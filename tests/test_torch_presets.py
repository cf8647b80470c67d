"""The presets of slice 8 against the JAX package, and the dense ones whole:
``yi-6b`` (GQA 32:4, rope θ 5e6, SwiGLU) and ``starcoder2-3b`` (GQA 24:2,
θ 999,999, tanh-GELU MLP) at smoke size, held to the reference's
``init_model`` weights through ``convert.params_from_numpy``: f32 prefill
logits, greedy tokens, prefill + decode steps, and one AdamW train step's
loss, gradients and parameters.  Also the configs, the attention at the
four presets' head ratios, ``convert`` over the ``("dense", "moe")``
pattern, the leaf-by-leaf init and the dense presets' CLI.  The MoE
presets' model tests are in ``test_torch_presets_moe.py``, which shares
the helpers here.  The reference runs on ``mesh1`` with its Pallas
kernels in interpret mode; every tolerance is stated at its assertion."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import io as jio
from repro.core import config as jconfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import attention as jattn
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.serving import engine as jengine
from repro.training import train_step as jts
from repro_torch import configs, tree
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 state_from_numpy, state_to_numpy)
from repro_torch.core.config import TrainConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import serve
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as T
from repro_torch.serving import engine
from repro_torch.training import train_step as ts

MOE_ARCHS = ("dbrx-132b", "llama4-maverick-400b-a17b")
DENSE_ARCHS = ("yi-6b", "starcoder2-3b")
NEW_ARCHS = MOE_ARCHS + DENSE_ARCHS
RNG = jax.random.PRNGKey(11)
METRIC_KEYS = ("loss", "ce", "aux", "grad_norm", "lr")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: at the smoke widths a
    torch op is too small to share out, and the parallel test workers
    would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# helpers (test_torch_presets_moe.py imports them)
# ---------------------------------------------------------------------------

def cfgs(arch, dispatch=None, dtype="float32"):
    """(reference, port) smoke configs in ``dtype``; for a MoE preset the
    reference runs its Pallas kernels (interpret mode), and ``dispatch``
    (default: the preset's) is set on both."""
    jc = jconfigs.smoke_config(arch).replace(dtype=dtype)
    tc = configs.smoke_config(arch).replace(dtype=dtype)
    if jc.moe is not None:
        d = dispatch or jc.moe.dispatch
        jc = jc.replace(moe=dataclasses.replace(jc.moe, use_pallas_gate=True,
                                                dispatch=d))
        tc = tc.replace(moe=dataclasses.replace(tc.moe, dispatch=d))
    return jc, tc


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    """The reference's smoke-model parameters (numpy), seeded by RNG."""
    return jax.tree.map(np.asarray, JT.init_model(RNG, cfgs(arch)[0]))


def port_model(arch, tc):
    return T.Transformer(tc, device="cpu",
                         params=params_from_numpy(jax_params(arch), tc))


def prompt(B=2, S=16, seed=6):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def jax_logits(arch, jc, toks, mesh):
    def f(p, t):
        h, _, _ = JT.forward(p, t, jc, mesh=mesh)
        return JT.logits_from_hidden(p, jc, h, mesh)
    return np.asarray(jax.jit(f)(jax_params(arch), jnp.asarray(toks)))


def port_logits(model, toks):
    with torch.inference_mode():
        h, _, _ = model.forward(torch.from_numpy(toks).long())
        return model.logits_from_hidden(h).float().numpy()


def check_prefill(arch, dispatch, mesh):
    """f32 logits at every position of a (2, 16) prompt, atol 1e-4 (f32
    sums in other orders through two blocks and the head)."""
    jc, tc = cfgs(arch, dispatch)
    toks = prompt()
    np.testing.assert_allclose(port_logits(port_model(arch, tc), toks),
                               jax_logits(arch, jc, toks, mesh), atol=1e-4)


def check_greedy(arch, dispatch, mesh):
    """Greedy token ids equal over 6 steps, f32, prompt (2, 16)."""
    jc, tc = cfgs(arch, dispatch)
    toks = prompt()
    j = np.asarray(jengine.generate(jax.tree.map(jnp.asarray,
                                                 jax_params(arch)),
                                    jc, jnp.asarray(toks), steps=6,
                                    mesh=mesh))
    t = engine.generate(port_model(arch, tc), torch.from_numpy(toks).long(),
                        steps=6).numpy()
    np.testing.assert_array_equal(t, j)


def check_decode(arch, dispatch, mesh):
    """The reference's compiled prefill and decode steps against the
    port's: last-token logits after a 12-token prefill, then after each of
    3 decode steps over a cache of 16, f32 atol 1e-4."""
    jc, tc = cfgs(arch, dispatch)
    toks = prompt(S=12)
    jp = jax.tree.map(jnp.asarray, jax_params(arch))
    jl, jcache = jengine.build_prefill(jc, mesh, cache_len=16)(
        jp, jnp.asarray(toks))
    step = jengine.build_decode(jc, mesh, batch=2)
    model = port_model(arch, tc)
    with torch.inference_mode():
        caches = model.init_caches(2, 16)
        assert len(caches) == tc.num_layers
        h, _, caches = model.forward(torch.from_numpy(toks).long(),
                                     caches=caches)
        tl = model.logits_from_hidden(h[:, -1:])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        for i in range(3):
            tok = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
            jl, jcache = step(jp, jnp.asarray(tok), jcache)
            tl, caches = model.decode_step(torch.from_numpy(tok).long(),
                                           caches)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=1e-4, err_msg=f"step {i}")


def check_train_step(arch, dispatch, mesh):
    """One f32 batch (2 x 32, SyntheticLM) from the reference's weights:
    loss within rtol 2e-6 and every gradient leaf within 1e-5 of its max
    |grad| (f32 sums in other orders) against ``jax.value_and_grad`` of
    the reference's forward + chunked CE + aux; then one AdamW step on
    both sides: loss, ce, aux, grad_norm and lr within rtol 2e-6
    (``test_torch_training.py``'s budget) and the parameters within atol
    1e-5 except at most 1e-4 of the elements, those within 2·lr (Adam's
    first step moves a parameter by about ±lr wherever |grad| ≫ eps, so
    a gradient near 0 that differs in its last bits can flip it)."""
    jc, tc = cfgs(arch, dispatch)
    p0 = jax_params(arch)
    kw = dict(learning_rate=3e-3, warmup_steps=1, total_steps=1)
    jtc, ttc = jconfig.TrainConfig(**kw), TrainConfig(**kw)
    jb = JSyntheticLM(jc, 2, 32).next_batch(0)
    tb = SyntheticLM(tc, 2, 32, device="cpu").next_batch(0)

    def jloss(p, b):
        h, aux, _ = JT.forward(p, b["inputs"], jc, mesh=mesh)
        return jts.chunked_ce_loss(p, jc, h, b["targets"], b["loss_mask"],
                                   mesh) + aux
    jp = jax.tree.map(jnp.asarray, p0)
    jv, jg = jax.jit(jax.value_and_grad(jloss))(jp, jb)
    state = ts.init_train_state(tc, ttc, params=params_from_numpy(p0, tc),
                                device="cpu")
    loss, _, _, grads = ts.loss_and_grads(state.params, tb, tc)
    np.testing.assert_allclose(float(loss), float(jv), rtol=2e-6)
    for (path, j), t in zip(
            jax.tree_util.tree_flatten_with_path(jg)[0],
            jax.tree.leaves(params_to_numpy(grads, tc)), strict=True):
        j = np.asarray(j)
        scale = np.abs(j).max()
        err = np.abs(t - j).max() / max(scale, 1e-30)
        assert err <= 1e-5, (jax.tree_util.keystr(path), err)

    jstate = jts.TrainState(
        jp, jadamw.init_opt_state(jp, jtc), jnp.zeros((), jnp.int32),
        skipped=jnp.zeros((), jnp.int32),
        nonfinite_streak=jnp.zeros((), jnp.int32),
        good_streak=jnp.zeros((), jnp.int32), loss_scale=jnp.float32(1.0))
    jstate, jm = jax.jit(jts.make_train_step(jc, jtc, mesh))(jstate, jb, RNG)
    state, tm = ts.make_train_step(tc, ttc)(state, tb)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-6,
                                   atol=1e-9, err_msg=k)
    assert float(tm["skipped"]) == 0
    want = jax.tree.leaves(jax.tree.map(np.asarray, jstate.params))
    got = jax.tree.leaves(params_to_numpy(state.params, tc))
    diff = np.concatenate([np.abs(a - b).ravel()
                           for a, b in zip(want, got, strict=True)])
    assert (diff > 1e-5).mean() <= 1e-4, (diff > 1e-5).sum()
    assert diff.max() <= 2 * float(jm["lr"]), diff.max()


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_presets_copy_the_reference(arch):
    """get_config and smoke_config equal the reference's field by field;
    the MoE presets differ in use_pallas_gate=True only.  The smoke
    reductions keep dbrx's top_k=4 over 4 experts and llama4's
    ("dense", "moe") period with its shared expert."""
    for get in ("get_config", "smoke_config"):
        t, j = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
        if j.moe is None:
            assert t.moe is None
        else:
            assert t.moe.use_pallas_gate and not j.moe.use_pallas_gate
            assert dataclasses.asdict(t.moe) == dataclasses.asdict(
                dataclasses.replace(j.moe, use_pallas_gate=True))
        assert dataclasses.asdict(t.attention) == dataclasses.asdict(
            j.attention)
        for f in dataclasses.fields(t):
            if f.name not in ("moe", "attention"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.head_dim == j.head_dim
        assert t.num_super_blocks == j.num_super_blocks
    smoke = configs.smoke_config(arch)
    if arch == "dbrx-132b":
        assert (smoke.moe.top_k, smoke.moe.num_experts) == (4, 4)
    if arch == "llama4-maverick-400b-a17b":
        assert smoke.block_pattern == ("dense", "moe")
        assert smoke.num_super_blocks == 1
        assert smoke.moe.num_shared_experts == 1 and smoke.attention.qk_norm


def test_every_reference_preset_is_registered():
    """The port registers the reference's eleven presets, the recurrent
    two included, each equal to the reference's field by field (nested
    configs as dicts; the MoE ones with the port's kernels on)."""
    assert set(configs.ARCHS) == set(jconfigs.ARCHS)
    for arch in ("rwkv6-1.6b", "zamba2-7b"):
        t, j = configs.get_config(arch), jconfigs.get_config(arch)
        for f in dataclasses.fields(t):
            a, b = getattr(t, f.name), getattr(j, f.name)
            assert (dataclasses.asdict(a) == dataclasses.asdict(b)
                    if dataclasses.is_dataclass(a) else a == b), f.name


# ---------------------------------------------------------------------------
# the attention at the presets' shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_attention_at_the_presets_head_ratios(arch):
    """The preset's heads, kv heads, qk-norm and rope θ at head dim 16
    (d = 16·H): the prefill attention of 24 tokens, then 3 decode steps
    over its cache, f32 within 1e-5 of the reference's (rtol and atol)."""
    a = configs.get_config(arch).attention
    acfg = dataclasses.replace(a, head_dim=16)
    jacfg = dataclasses.replace(jconfigs.get_config(arch).attention,
                                head_dim=16)
    d = 16 * a.num_heads
    rng = np.random.default_rng(51)
    p = {"wq": rng.standard_normal((d, a.num_heads * 16)),
         "wk": rng.standard_normal((d, a.num_kv_heads * 16)),
         "wv": rng.standard_normal((d, a.num_kv_heads * 16)),
         "wo": rng.standard_normal((a.num_heads * 16, d))}
    p = {k: (v * d ** -0.5).astype(np.float32) for k, v in p.items()}
    if a.qk_norm:
        p["q_norm"] = rng.standard_normal(16).astype(np.float32) * 0.1
        p["k_norm"] = rng.standard_normal(16).astype(np.float32) * 0.1
    x = rng.standard_normal((2, 27, d)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    pos = np.arange(24, dtype=np.int32)
    jy, jkv = jattn.full_attention(jp, jnp.asarray(x[:, :24]), jacfg,
                                   positions=jnp.asarray(pos))
    ty, tkv = tattn.full_attention(tp, torch.from_numpy(x[:, :24]), acfg,
                                   positions=torch.from_numpy(pos))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    jc = jattn.fill_cache(jattn.init_cache(jacfg, 2, 27, d, jnp.float32),
                          jkv, ring=False)
    tc = tattn.fill_cache(tattn.init_cache(acfg, 2, 27, d, torch.float32),
                          tkv)
    for i in range(24, 27):
        jy, jc = jattn.decode_attention(jp, jnp.asarray(x[:, i:i + 1]), jc,
                                        jacfg, ring=False)
        ty, tc = tattn.decode_attention(tp, torch.from_numpy(x[:, i:i + 1]),
                                        tc, acfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5, err_msg=f"decode {i}")


# ---------------------------------------------------------------------------
# the dense presets against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_prefill_logits_match_reference_f32(mesh1, arch):
    check_prefill(arch, None, mesh1)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_greedy_generate_matches_reference(mesh1, arch):
    check_greedy(arch, None, mesh1)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_decode_steps_match_reference(mesh1, arch):
    check_decode(arch, None, mesh1)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_train_step_matches_reference(mesh1, arch):
    check_train_step(arch, None, mesh1)


# ---------------------------------------------------------------------------
# convert over the block kinds, the leaf-by-leaf init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_params_round_trip_through_the_port(arch):
    """params_from_numpy then params_to_numpy gives the reference's tree
    back bitwise; each layer holds its kind's FFN (llama4: layer 0 an
    MLP, layer 1 the MoE layer and the shared experts' MLP of width
    d_ff_expert·num_shared_experts)."""
    _, tc = cfgs(arch)
    p0 = jax_params(arch)
    port = params_from_numpy(p0, tc)
    kinds = T.layer_kinds(tc)
    for kind, blk in zip(kinds, port["blocks"], strict=True):
        want = {"ln1", "attn", "ln2"} | (
            {"moe"} | ({"shared_mlp"} if tc.moe.num_shared_experts else set())
            if kind == "moe" else {"mlp"})
        assert set(blk) == want, (kind, set(blk))
    if arch == "llama4-maverick-400b-a17b":
        assert kinds == ["dense", "moe"]
        f = tc.moe.d_ff_expert
        assert tuple(port["blocks"][1]["shared_mlp"]["w_out"].shape) == (
            f, tc.d_model)
    back = params_to_numpy(port, tc)
    flat_j = jax.tree_util.tree_flatten_with_path(p0)
    flat_t = jax.tree_util.tree_flatten_with_path(back)
    assert flat_j[1] == flat_t[1]
    for (path, a), (_, b) in zip(flat_j[0], flat_t[0], strict=True):
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(
            path))


@pytest.mark.parametrize("arch", ("llama4-maverick-400b-a17b", "yi-6b"))
def test_train_state_crosses_between_the_packages(mesh1, arch):
    """A reference TrainState (after one step, so the moments are not 0)
    flattened under its checkpoint keys → state_from_numpy →
    state_to_numpy: the same keys in the same order and every array
    bitwise; the port's next step from it matches the reference's within
    rtol 2e-6."""
    jc, tc = cfgs(arch)
    kw = dict(learning_rate=3e-3, warmup_steps=1, total_steps=3)
    jtc, ttc = jconfig.TrainConfig(**kw), TrainConfig(**kw)
    jstate = jts.init_train_state(RNG, jc, jtc)
    jstep = jax.jit(jts.make_train_step(jc, jtc, mesh1))
    jds = JSyntheticLM(jc, 2, 16)
    jstate, _ = jstep(jstate, jds.next_batch(0), RNG)
    want = {k: np.asarray(v) for k, v in jio._flatten(jstate).items()}
    state = state_from_numpy(want, tc, device="cpu")
    got = state_to_numpy(state, tc)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jstate, jm = jstep(jstate, jds.next_batch(1), RNG)
    state, tm = ts.make_train_step(tc, ttc)(
        state, SyntheticLM(tc, 2, 16, device="cpu").next_batch(1), step=1)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-6,
                                   atol=1e-9, err_msg=k)


@pytest.mark.parametrize("arch", NEW_ARCHS + ("hetumoe-paper-16e",))
def test_leafwise_init_equals_init_then_cast(arch):
    """init_params with dtype=bf16 (each leaf cast right after its draw)
    equals the f32 init_params cast afterwards, bitwise, from the same
    seed; the norm scales, the router and the qk-norm scales stay f32.  A
    bf16 Transformer drawn from a seed holds exactly those values."""
    cfg = configs.smoke_config(arch)
    f32 = T.init_params(cfg, torch.Generator().manual_seed(3))
    bf16 = T.init_params(cfg, torch.Generator().manual_seed(3),
                         dtype=torch.bfloat16)
    model = T.Transformer(cfg, device="cpu", seed=3)
    served = {"blocks": [b.tree() for b in model.blocks],
              "final_norm": model.final_norm, "embed": model.embed,
              "lm_head": model.lm_head}
    paths = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: 0, f32))[0]
    for (path, _), a, b, c in zip(paths, tree.leaves(f32), tree.leaves(bf16),
                                  tree.leaves(served), strict=True):
        name = str(path[-1].key)
        want = a if name in T._F32_LEAVES else a.to(torch.bfloat16)
        assert b.dtype == c.dtype == want.dtype, (path, b.dtype)
        assert torch.equal(b, want) and torch.equal(c, want), path


def test_served_qk_norm_scales_stay_f32():
    """A bf16 Transformer keeps the qk-norm scales in f32, as the
    reference applies them (its rms_norm reads the f32 scale): a scale
    that bf16 cannot hold gives the f32 result, not a rounded one."""
    _, tc = cfgs("llama4-maverick-400b-a17b", dtype="bfloat16")
    p = T.init_params(tc, torch.Generator().manual_seed(0))
    p["blocks"][0]["attn"]["q_norm"] += 1e-3 * (1 + 2 ** -12)
    model = T.Transformer(tc, device="cpu", params=p)
    q = model.blocks[0].attn["q_norm"]
    assert q.dtype == torch.float32
    assert torch.equal(q, p["blocks"][0]["attn"]["q_norm"])


# ---------------------------------------------------------------------------
# entry points on the dense presets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_serve_cli_serves_a_dense_preset(capsys, arch):
    """The CLI serves a dense preset and prints no dispatch; --dispatch on
    it raises as in the reference."""
    serve.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len",
                "8", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "dispatch=" not in out and "-> (2, 11)" in out
    with pytest.raises(ValueError, match="no MoE layer"):
        serve.run(arch, smoke=True, batch=1, prompt_len=4, gen=2,
                  dispatch="grouped", device="cpu")
    with pytest.raises(ValueError, match="no MoE layer"):
        jengine.serve_config(jconfigs.smoke_config(arch), dispatch="grouped")


def test_train_cli_trains_a_dense_preset(capsys):
    """launch.train.run on yi-6b's smoke config: 2 finite steps; moe
    keywords on a dense preset raise."""
    _, hist = tlaunch.run("yi-6b", steps=2, batch=2, seq=16, smoke=True,
                          log_every=1, device="cpu")
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert "dispatch=" not in capsys.readouterr().out
    with pytest.raises(ValueError, match="no MoE layer"):
        tlaunch.run("yi-6b", steps=1, batch=1, seq=8, smoke=True,
                    moe=dict(gate="topk"), device="cpu")
