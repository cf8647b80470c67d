"""The recurrent presets against the JAX package: ``rwkv6-1.6b`` (every
layer an ``rwkv`` block: the RWKV-6 time mix and a ReLU MLP as the channel
mix) and ``zamba2-7b`` (``mamba``, ``mamba``, ``mamba_sa``: Mamba-2 blocks
and one shared attention block, LoRA-adapted per occurrence) at smoke
size, held to the reference's ``init_model`` weights through
``convert.params_from_numpy`` — with the leaves that init to zero or one
(the norm scales, RWKV's ``ln_x``, Mamba's ``norm`` and ``conv_b``, the
LoRA's ``sa_lora_b``) drawn away from it, so that a wrong formula shows.
f32 logits of the forward, of a prefill then decode steps, greedy tokens,
one train step's loss, gradients and metrics, remat bitwise none;
``SlotServer`` against
``generate`` and the reference's server; ``DecodeStep.reset`` and
``put_slot`` over recurrent states; zamba2's long-context ring caches;
``convert`` and checkpoints across the packages; the serving copy's f32
leaves; the CLIs.  The reference runs on ``mesh1``; every tolerance is
stated at its assertion."""
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
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.serving import Request as JRequest
from repro.serving import SlotServer as JSlotServer
from repro.serving import engine as jengine
from repro.training import train_step as jts
from repro_torch import configs, tree
from repro_torch.checkpoint.io import restore_checkpoint, save_checkpoint
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 state_to_numpy)
from repro_torch.core.config import TrainConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import serve
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as T
from repro_torch.serving import Request, SlotServer, engine
from repro_torch.training import train_step as ts

ARCHS = ("rwkv6-1.6b", "zamba2-7b")
RNG = jax.random.PRNGKey(11)
METRIC_KEYS = ("loss", "ce", "aux", "grad_norm", "lr")
# leaves drawn away from their zero (or one) init: name -> scale of the draw
PERTURB = {"ln1": 0.1, "ln2": 0.1, "sa_ln": 0.1, "ln": 0.1,
           "final_norm": 0.1, "norm": 0.2, "conv_b": 0.2, "sa_lora_b": 0.1,
           "ln_x": 0.2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(arch, dtype="float32"):
    return (jconfigs.smoke_config(arch).replace(dtype=dtype),
            configs.smoke_config(arch).replace(dtype=dtype))


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    """The reference's smoke parameters (numpy), seeded by RNG, with the
    ``PERTURB`` leaves drawn around their init."""
    p = jax.tree.map(np.asarray, JT.init_model(RNG, cfgs(arch)[0]))
    rng = np.random.default_rng(21)
    flat, treedef = jax.tree_util.tree_flatten_with_path(p)
    leaves = []
    for path, a in flat:
        name = str(getattr(path[-1], "key", ""))
        if name in PERTURB:
            a = (a + PERTURB[name] * rng.standard_normal(a.shape)).astype(
                np.float32)
        leaves.append(a)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def port_model(arch, tc=None):
    tc = tc or cfgs(arch)[1]
    return T.Transformer(tc, device="cpu",
                         params=params_from_numpy(jax_params(arch), tc))


def prompt(B=2, S=20, seed=6):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def rel(a, b):
    """max|a − b| / max|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_presets_copy_the_reference(arch):
    """get_config and smoke_config equal the reference's field by field
    (the SSM, RWKV and attention configs as dicts); the smoke reductions
    are the reference's (chunks of 8, head dim 16)."""
    for get in ("get_config", "smoke_config"):
        t, j = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
        for f in dataclasses.fields(t):
            a, b = getattr(t, f.name), getattr(j, f.name)
            if dataclasses.is_dataclass(a):
                assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
            else:
                assert a == b, f.name
        assert t.is_subquadratic == j.is_subquadratic
        assert t.head_dim == j.head_dim
    smoke = configs.smoke_config(arch)
    if arch == "rwkv6-1.6b":
        assert (smoke.rwkv.chunk_size, smoke.rwkv.head_dim) == (8, 16)
    else:
        assert (smoke.ssm.chunk_size, smoke.ssm.d_state) == (8, 16)
        assert configs.get_config(arch).head_dim == 112


# ---------------------------------------------------------------------------
# the forward, prefill + decode, generate
# ---------------------------------------------------------------------------

def jax_logits(arch, toks, mesh):
    jc = cfgs(arch)[0]

    def f(p, t):
        h, _, _ = JT.forward(p, t, jc, mesh=mesh)
        return JT.logits_from_hidden(p, jc, h, mesh)
    return np.asarray(jax.jit(f)(jax_params(arch), jnp.asarray(toks)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [20, 13], ids=["chunks-of-5", "prime"])
def test_forward_logits_match_reference(mesh1, arch, S):
    """f32 logits at every position of a (2, S) prompt within 1e-5 of the
    max logit (f32 sums in other orders through the blocks and the head);
    S = 20 runs chunks of 5, the prime S = 13 chunks of 1."""
    toks = prompt(S=S)
    model = port_model(arch)
    with torch.inference_mode():
        h, _, _ = model.forward(torch.from_numpy(toks).long())
        got = model.logits_from_hidden(h).numpy()
    assert rel(got, jax_logits(arch, toks, mesh1)) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference(mesh1, arch):
    """The reference's compiled prefill and decode steps against the
    port's: last-token logits after a 12-token prefill into caches of 24,
    then after each of 4 decode steps, f32, within 1e-5 of the max logit;
    the port's recurrent states are written in place (the cache tensors
    keep their addresses)."""
    jc, tc = cfgs(arch)
    toks = prompt(S=12)
    jp = jax.tree.map(jnp.asarray, jax_params(arch))
    jl, jcache = jengine.build_prefill(jc, mesh1, cache_len=24)(
        jp, jnp.asarray(toks))
    step = jengine.build_decode(jc, mesh1, batch=2)
    model = port_model(arch, tc)
    with torch.inference_mode():
        caches = model.init_caches(2, 24)
        ptrs = [t.data_ptr() for t in engine._cache_leaves(caches)]
        h, _, caches = model.forward(torch.from_numpy(toks).long(),
                                     caches=caches)
        tl = model.logits_from_hidden(h[:, -1:])
        assert rel(tl.numpy(), jl) <= 1e-5
        for i in range(4):
            tok = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
            jl, jcache = step(jp, jnp.asarray(tok), jcache)
            tl, caches = model.decode_step(torch.from_numpy(tok).long(),
                                           caches)
            assert rel(tl.numpy(), jl) <= 1e-5, i
        assert [t.data_ptr() for t in engine._cache_leaves(caches)] == ptrs


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(mesh1, arch):
    """Greedy token ids equal over 8 steps, f32, prompt (2, 16)."""
    jc, tc = cfgs(arch)
    toks = prompt(S=16)
    j = np.asarray(jengine.generate(jax.tree.map(jnp.asarray,
                                                 jax_params(arch)),
                                    jc, jnp.asarray(toks), steps=8,
                                    mesh=mesh1))
    t = engine.generate(port_model(arch, tc), torch.from_numpy(toks).long(),
                        steps=8).numpy()
    np.testing.assert_array_equal(t, j)


def test_zamba2_long_context_rings(mesh1):
    """zamba2 with ``long_context``: the shared block's caches are rings
    of local_window (32 at smoke size) and the Mamba states are unchanged
    in shape; a 40-token prompt (past the ring) and 12 greedy steps (the
    ring wraps) give the reference's tokens; without long_context the
    caches are linear and their capacity the cache length."""
    arch = "zamba2-7b"
    jc, tc = cfgs(arch)
    model = port_model(arch, tc)
    ring = model.init_caches(2, 52, long_context=True)
    linear = model.init_caches(2, 52)
    kinds = T.layer_kinds(tc)
    assert [c["sa"]["k"].shape[1] for c, k in zip(ring, kinds)
            if k == "mamba_sa"] == [32]
    assert T.linear_capacity(tc, ring, long_context=True) is None
    assert T.linear_capacity(tc, linear) == 52
    toks = prompt(S=40, seed=8)
    j = np.asarray(jengine.generate(jax.tree.map(jnp.asarray,
                                                 jax_params(arch)),
                                    jc, jnp.asarray(toks), steps=12,
                                    mesh=mesh1, long_context=True))
    t = engine.generate(model, torch.from_numpy(toks).long(), steps=12,
                        long_context=True).numpy()
    np.testing.assert_array_equal(t, j)


def test_rwkv6_caches_hold_no_attention():
    """rwkv6's caches are recurrent states only ({"rwkv": {s, x_last}},
    f32): no capacity, so generate never refuses a length."""
    tc = cfgs("rwkv6-1.6b")[1]
    caches = port_model("rwkv6-1.6b", tc).init_caches(3, 10)
    assert all(set(c) == {"rwkv"} and set(c["rwkv"]) == {"s", "x_last"}
               for c in caches)
    assert caches[0]["rwkv"]["s"].shape == (3, 8, 16, 16)
    assert T.linear_capacity(tc, caches) is None


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(mesh1, arch):
    """One f32 batch (2 x 32, SyntheticLM: chunks of 8): loss within rtol
    2e-6 and every gradient leaf within 2e-5 of its max |grad| against
    ``jax.value_and_grad`` of the reference's forward + chunked CE (each
    side's f32 sums lie up to ~1.1e-5 of the max from a float64 replay of
    the same step: rwkv6's u, wo, wk and wv gradients sum many products
    of opposite signs over the chunks); then
    one AdamW step on both sides: loss, ce, aux, grad_norm and lr within
    rtol 2e-6, none skipped."""
    jc, tc = cfgs(arch)
    p0 = jax_params(arch)
    kw = dict(learning_rate=3e-3, warmup_steps=1, total_steps=1)
    jtc, ttc = jconfig.TrainConfig(**kw), TrainConfig(**kw)
    jb = JSyntheticLM(jc, 2, 32).next_batch(0)
    tb = SyntheticLM(tc, 2, 32, device="cpu").next_batch(0)

    def jloss(p, b):
        h, aux, _ = JT.forward(p, b["inputs"], jc, mesh=mesh1)
        return jts.chunked_ce_loss(p, jc, h, b["targets"], b["loss_mask"],
                                   mesh1) + aux
    jp = jax.tree.map(jnp.asarray, p0)
    jv, jg = jax.jit(jax.value_and_grad(jloss))(jp, jb)
    state = ts.init_train_state(tc, ttc, params=params_from_numpy(p0, tc),
                                device="cpu")
    loss, _, _, grads = ts.loss_and_grads(state.params, tb, tc)
    np.testing.assert_allclose(float(loss), float(jv), rtol=2e-6)
    for (path, j), t in zip(
            jax.tree_util.tree_flatten_with_path(jg)[0],
            jax.tree.leaves(params_to_numpy(grads, tc)), strict=True):
        assert rel(t, j) <= 2e-5, jax.tree_util.keystr(path)
    jstate = jts.TrainState(
        jp, jadamw.init_opt_state(jp, jtc), jnp.zeros((), jnp.int32),
        skipped=jnp.zeros((), jnp.int32),
        nonfinite_streak=jnp.zeros((), jnp.int32),
        good_streak=jnp.zeros((), jnp.int32), loss_scale=jnp.float32(1.0))
    _, jm = jax.jit(jts.make_train_step(jc, jtc, mesh1))(jstate, jb, RNG)
    state, tm = ts.make_train_step(tc, ttc)(state, tb)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-6,
                                   atol=1e-9, err_msg=k)
    assert float(tm["skipped"]) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_matches_none_bitwise(arch):
    """``remat="block"`` and ``"full"`` (each layer recomputed in the
    backward, the scan's own checkpoint nested inside) give the loss and
    every gradient of ``remat="none"`` bitwise, f32, batch 2 x 32."""
    tc = cfgs(arch)[1]
    params = tree.map_(lambda t: t.requires_grad_(True),
                       params_from_numpy(jax_params(arch), tc))
    batch = SyntheticLM(tc, 2, 32, device="cpu").next_batch(0)
    runs = {r: ts.loss_and_grads(params, batch, tc, remat=r)
            for r in ("none", "block", "full")}
    for r in ("block", "full"):
        assert torch.equal(runs[r][0], runs["none"][0]), r
        for a, b in zip(tree.leaves(runs[r][3]), tree.leaves(runs["none"][3]),
                        strict=True):
            assert torch.equal(a, b), r


# ---------------------------------------------------------------------------
# serving: SlotServer, DecodeStep.reset, put_slot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_slot_server_matches_generate_and_reference(mesh1, arch):
    """Three requests of 12-token prompts and 5 new tokens over 2 slots
    (the third waits for a free slot, whose recurrent states a finished
    request left behind): every request ends ok with the port's batch-1
    greedy ``generate`` tokens, and the statuses and tokens equal the
    reference server's."""
    jc, tc = cfgs(arch)
    model = port_model(arch, tc)
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, 512, (12,)).astype(np.int32)
               for _ in range(3)]
    kw = dict(slots=2, cache_len=20)
    jd = JSlotServer(jc, jax.tree.map(jnp.asarray, jax_params(arch)),
                     mesh=mesh1, **kw).run(
        [JRequest(uid=i, prompt=jnp.asarray(p), max_new=5)
         for i, p in enumerate(prompts)])
    td = SlotServer(model, **kw).run(
        [Request(uid=i, prompt=torch.from_numpy(p.astype(np.int64)),
                 max_new=5) for i, p in enumerate(prompts)])

    def summary(done):
        return sorted((r.uid, r.status, [int(t) for t in r.out])
                      for r in done)
    assert summary(td) == summary(jd)
    for r in td:
        ref = engine.generate(model, torch.from_numpy(
            prompts[r.uid][None].astype(np.int64)), steps=5)[0, 12:]
        assert r.status == "ok" and r.out == ref.tolist(), r.uid


@pytest.mark.parametrize("arch", ARCHS)
def test_reset_and_put_slot_over_recurrent_states(arch):
    """``DecodeStep.reset`` zeroes every cache tensor, the recurrent
    states and positions included; ``put_slot`` copies a slot prefill's
    single-row caches into its row — attention k/v, s, x_last, conv —
    and sets every position, leaving the other rows as they were, all in
    place."""
    tc = cfgs(arch)[1]
    model = port_model(arch, tc)
    with torch.inference_mode():
        step = engine.build_decode(model, batch=3, cache_len=16)
        prefill = engine.build_prefill(model, cache_len=16, batch=3)
        prefill(torch.from_numpy(prompt(B=3, S=6)).long(), step.caches)
        step(torch.zeros((3, 1), dtype=torch.long))
        leaves = engine._cache_leaves(step.caches)
        assert all(bool(t.abs().sum() > 0) for t in leaves)
        before = [t.clone() for t in leaves]
        ptrs = [t.data_ptr() for t in leaves]
        slot_prefill = engine.build_slot_prefill(model, cache_len=16)
        _, sub = slot_prefill(torch.from_numpy(prompt(B=1, S=7,
                                                      seed=9)).long())
        engine.put_slot(step.caches, sub, 1)
        for t, was, one in zip(engine._cache_leaves(step.caches), before,
                               engine._cache_leaves(sub), strict=True):
            if t.ndim == 0:
                assert int(t) == int(one) == 7
                continue
            assert torch.equal(t[1], one[0])
            assert torch.equal(t[0], was[0]) and torch.equal(t[2], was[2])
        step.reset()
        leaves = engine._cache_leaves(step.caches)
        assert [t.data_ptr() for t in leaves] == ptrs
        assert all(not bool(t.any()) for t in leaves)
    engine.clear_step_cache(model)


# ---------------------------------------------------------------------------
# convert, checkpoints, the serving copy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_through_the_port(arch):
    """params_from_numpy then params_to_numpy gives the reference's tree
    back bitwise; each layer holds its kind's leaves, and zamba2's tree
    one top-level shared_attn {ln, attn}."""
    tc = cfgs(arch)[1]
    p0 = jax_params(arch)
    port = params_from_numpy(p0, tc)
    want = {"rwkv": {"ln1", "rwkv", "ln2", "mlp"}, "mamba": {"ln1", "mamba"},
            "mamba_sa": {"ln1", "mamba", "sa_ln", "sa_lora_a", "sa_lora_b"}}
    for kind, blk in zip(T.layer_kinds(tc), port["blocks"], strict=True):
        assert set(blk) == want[kind], kind
    if arch == "zamba2-7b":
        assert set(port["shared_attn"]) == {"ln", "attn"}
        assert tuple(port["blocks"][2]["sa_lora_a"].shape) == (128, T.LORA_R)
    else:
        assert "shared_attn" not in port
    back = params_to_numpy(port, tc)
    flat_j = jax.tree_util.tree_flatten_with_path(p0)
    flat_t = jax.tree_util.tree_flatten_with_path(back)
    assert flat_j[1] == flat_t[1]
    for (path, a), (_, b) in zip(flat_j[0], flat_t[0], strict=True):
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(
            path))


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_both_ways(tmp_path, arch):
    """A reference TrainState saved by the JAX trainer restores in the
    port with every checkpoint key bitwise, and the port's state after
    one step saved by the port restores in the reference, every array
    equal under the same keys."""
    jc, tc = cfgs(arch)
    kw = dict(learning_rate=3e-3, warmup_steps=1, total_steps=3)
    jstate = jts.init_train_state(RNG, jc, jconfig.TrainConfig(**kw))
    jio.save_checkpoint(str(tmp_path / "jax"), jstate, 1)
    ttc = TrainConfig(**kw)
    tmpl = ts.init_train_state(tc, ttc, device="cpu")
    state, step = restore_checkpoint(str(tmp_path / "jax"), tmpl, cfg=tc)
    want = {k: np.asarray(v) for k, v in jio._flatten(jstate).items()}
    got = state_to_numpy(state, tc)
    assert step == 1 and list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    state, m = ts.make_train_step(tc, ttc)(
        state, SyntheticLM(tc, 2, 16, device="cpu").next_batch(0), step=0)
    assert float(m["skipped"]) == 0
    save_checkpoint(str(tmp_path / "port"), state, 2, cfg=tc)
    jback, jstep = jio.restore_checkpoint(str(tmp_path / "port"), jstate)
    got = {k: np.asarray(v) for k, v in jio._flatten(jback).items()}
    want = state_to_numpy(state, tc)
    assert jstep == 2 and list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_served_f32_leaves_stay_f32(arch):
    """A bf16 Transformer keeps the leaves the reference uses in f32 —
    the norms, RWKV's decay LoRA, w0, u and ln_x, Mamba's A_log, D,
    dt_bias and norm — as the f32 values it was given (values bf16 cannot
    hold), and the projections in bf16."""
    tc = cfgs(arch, dtype="bfloat16")[1]
    p = params_from_numpy(jax_params(arch), tc)
    p = tree.map_(lambda t: t + 1e-3 * (1 + 2 ** -12), p)
    model = T.Transformer(tc, device="cpu", params=p)
    paths = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: 0, p))[0]
    seen = set()
    for (path, _), given, served in zip(paths, tree.leaves(p),
                                        tree.leaves(model.tree()),
                                        strict=True):
        name = str(path[-1].key)
        if name in T._F32_LEAVES:
            seen.add(name)
            assert served.dtype == torch.float32, path
            assert torch.equal(served, given), path
        else:
            assert served.dtype == torch.bfloat16, path
    assert seen >= ({"w0", "decay_a", "decay_b", "u", "ln_x"}
                    if arch == "rwkv6-1.6b" else
                    {"A_log", "D", "dt_bias", "norm", "sa_ln", "ln"})


@pytest.mark.parametrize("arch", ARCHS)
def test_leafwise_init_equals_init_then_cast(arch):
    """init_params with dtype=bf16 equals the f32 init_params cast
    afterwards, bitwise, from the same seed, the f32 leaves kept f32; a
    bf16 Transformer drawn from that seed holds exactly those values
    (zamba2's shared_attn included)."""
    cfg = configs.smoke_config(arch)
    f32 = T.init_params(cfg, torch.Generator().manual_seed(3))
    bf16 = T.init_params(cfg, torch.Generator().manual_seed(3),
                         dtype=torch.bfloat16)
    served = T.Transformer(cfg, device="cpu", seed=3).tree()
    paths = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: 0, f32))[0]
    for (path, _), a, b, c in zip(paths, tree.leaves(f32), tree.leaves(bf16),
                                  tree.leaves(served), strict=True):
        name = str(path[-1].key)
        want = a if name in T._F32_LEAVES else a.to(torch.bfloat16)
        assert b.dtype == c.dtype == want.dtype, (path, b.dtype)
        assert torch.equal(b, want) and torch.equal(c, want), path


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_train_clis(capsys, arch):
    """The serving CLI serves the smoke config (2 x 8 prompt, 3 new
    tokens); launch.train.run takes 2 finite, unskipped AdamW steps at
    seq 32 (chunks of 8)."""
    serve.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len",
                "8", "--gen", "3", "--device", "cpu"])
    assert "-> (2, 11)" in capsys.readouterr().out
    _, hist = tlaunch.run(arch, steps=2, batch=2, seq=32, smoke=True,
                          device="cpu")
    assert len(hist) == 2
    assert all(np.isfinite(h["loss"]) and h["skipped"] == 0 for h in hist)
