"""The frontend presets against the JAX package: ``hubert-xlarge``
(audio frames, encoder-only: bidirectional attention, no RoPE, GELU, no
decode step) and ``internvl2-2b`` (the vision stub's merged embedding
stream, GQA 16:8, untied head) at smoke size, held to the reference's
``init_model`` weights through ``convert.params_from_numpy``.  Their
inputs are (B, S, d) embeddings, not token ids: the configs, the
frontend batches of ``SyntheticLM`` (bitwise), forward logits on
``_attend`` (S=16) and on the flash path (S=640, non-causal for hubert,
at hubert's own head dim 80), one train step, internvl2's prefill and
embedding-fed decode steps, the serving refusals, ``convert`` and
checkpoints across the packages, and a frontend config with a noisy MoE
gate (its gate draws one row per token, B·S, not one per input element).
The reference runs on ``mesh1`` with its Pallas kernels in interpret
mode; every tolerance is stated at its assertion."""
import dataclasses

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
from repro.training import train_step as jts
from repro_torch import configs, tree
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 state_to_numpy)
from repro_torch.core.config import TrainConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import flash_attention as F
from repro_torch.launch import serve
from repro_torch.launch import train as tlaunch
from repro_torch.models import frontend
from repro_torch.models import transformer as T
from repro_torch.serving import engine
from repro_torch.training import train_step as ts
from test_torch_gating import layer_draws
from test_torch_presets import RNG, check_train_step, cfgs, jax_params

ARCHS = ("hubert-xlarge", "internvl2-2b")
METRIC_KEYS = ("loss", "ce", "aux", "grad_norm", "lr")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs (smoke widths; the
    parallel test workers would otherwise contend for the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def embeddings(B, S, d=128, seed=7):
    """A (B, S, d) f32 embedding stream at the frontend stub's scale."""
    return (np.random.default_rng(seed).standard_normal((B, S, d))
            .astype(np.float32) * 0.02)


def with_head_dim(cfg, d):
    return cfg.replace(attention=dataclasses.replace(cfg.attention,
                                                     head_dim=d))


# ---------------------------------------------------------------------------
# configs, batches, the frontend stub
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_presets_copy_the_reference(arch):
    """get_config and smoke_config equal the reference's field by field;
    hubert is encoder-only, non-causal, without RoPE, with GELU and head
    dim 80; internvl2 is causal GQA 16:8 at head dim 128, with an untied
    head over 92553 entries."""
    for get in ("get_config", "smoke_config"):
        t, j = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
        assert t.moe is None and j.moe is None
        assert dataclasses.asdict(t.attention) == dataclasses.asdict(
            j.attention)
        for f in dataclasses.fields(t):
            if f.name not in ("moe", "attention"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.head_dim == j.head_dim
    full = configs.get_config(arch)
    if arch == "hubert-xlarge":
        assert (full.frontend, full.encoder_only, full.has_decode) == (
            "audio", True, False)
        assert not full.attention.use_rope and not full.attention.causal
        assert (full.head_dim, full.num_layers, full.act) == (80, 48, "gelu")
    else:
        assert (full.frontend, full.has_decode, full.head_dim) == (
            "vision", True, 128)
        assert (full.attention.num_heads, full.attention.num_kv_heads,
                full.vocab_size) == (16, 8, 92553)


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_batches_equal_the_reference(arch):
    """``SyntheticLM`` frontend batches (B=2, S=40, steps 0 and 3, seeds
    0 and 5) are bitwise the reference's: inputs (B, S, d) f32, the rows
    of the seed's fixed (V, d) projection at the input tokens; targets
    and mask as for tokens."""
    cfg = configs.smoke_config(arch)
    for seed in (0, 5):
        j = JSyntheticLM(jconfigs.smoke_config(arch), 2, 40, seed=seed)
        t = SyntheticLM(cfg, 2, 40, seed=seed, device="cpu")
        for step in (0, 3):
            jb, tb = j.next_batch(step), t.next_batch(step)
            assert tb["inputs"].shape == (2, 40, cfg.d_model)
            assert tb["inputs"].dtype == torch.float32
            for k in ("inputs", "targets", "loss_mask"):
                np.testing.assert_array_equal(tb[k].numpy(),
                                              np.asarray(jb[k]), err_msg=k)


def test_frontend_stub_shapes():
    """``frontend_embedding_shape`` is (B, S, d) for both frontends and
    refuses a token config; ``synthetic_embeddings`` draws that shape in
    the requested dtype from the generator it is given, at scale 0.02."""
    for arch in ARCHS:
        cfg = configs.get_config(arch)
        assert frontend.frontend_embedding_shape(cfg, 3, 5) == (
            3, 5, cfg.d_model)
        g = torch.Generator().manual_seed(0)
        x = frontend.synthetic_embeddings(g, cfg, 2, 64, device="cpu")
        assert x.shape == (2, 64, cfg.d_model) and x.dtype == torch.bfloat16
        assert 0.015 < x.float().std().item() < 0.025
        y = frontend.synthetic_embeddings(torch.Generator().manual_seed(0),
                                          cfg, 2, 64, dtype=torch.float32)
        assert y.dtype == torch.float32
    with pytest.raises(AssertionError):
        frontend.frontend_embedding_shape(configs.get_config("yi-6b"), 1, 1)


# ---------------------------------------------------------------------------
# forward, decode
# ---------------------------------------------------------------------------

def _logits_both(arch, B, S, mesh, head_dim=None):
    jc, tc = cfgs(arch)
    if head_dim:
        jc, tc = with_head_dim(jc, head_dim), with_head_dim(tc, head_dim)
    p0 = (jax_params(arch) if head_dim is None else
          jax.tree.map(np.asarray, JT.init_model(RNG, jc)))
    x = embeddings(B, S)

    def f(p, e):
        h, _, _ = JT.forward(p, e, jc, mesh=mesh)
        return JT.logits_from_hidden(p, jc, h, mesh)
    j = np.asarray(jax.jit(f)(jax.tree.map(jnp.asarray, p0), jnp.asarray(x)))
    model = T.Transformer(tc, device="cpu", params=params_from_numpy(p0, tc))
    assert model.embed is None and model.lm_head is not None
    with torch.inference_mode():
        h, _, _ = model.forward(torch.from_numpy(x))
        t = model.logits_from_hidden(h).float().numpy()
    return t, j


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_on_attend(mesh1, arch):
    """f32 logits at every position of a (2, 16) embedding stream (below
    q_chunk: ``_attend``, bidirectional for hubert), atol 1e-5 (f32 sums
    in other orders through two blocks and the untied head)."""
    t, j = _logits_both(arch, 2, 16, mesh1)
    np.testing.assert_allclose(t, j, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_on_the_flash_path(mesh1, arch, monkeypatch):
    """A (1, 640) stream takes the flash forward (past q_chunk = 512):
    the plain versions against the reference's Pallas flash kernels in
    interpret mode, non-causal for hubert at its own head dim 80 (640 =
    10 tiles of 64), causal GQA for internvl2; f32 logits at every
    position within atol 1e-5; the forward once per layer with
    ``causal`` as the config says."""
    causal = []
    fwd = F.flash_fwd
    monkeypatch.setattr(F, "flash_fwd",
                        lambda *a: causal.append(a[6]) or fwd(*a))
    t, j = _logits_both(arch, 1, 640, mesh1,
                        head_dim=80 if arch == "hubert-xlarge" else None)
    np.testing.assert_allclose(t, j, atol=1e-5)
    assert causal == [arch != "hubert-xlarge"] * 2


def test_internvl2_prefill_and_embedding_fed_decode(mesh1):
    """internvl2's smoke model served through the API: a (2, 12)
    embedding prefill into caches of 16, then 3 decode steps fed (2, 1, d)
    embeddings, against the reference's ``forward`` (caches collected)
    and ``decode_step``: last-position f32 logits within atol 1e-5 at
    every step, and the caches' positions advanced to 15."""
    arch = "internvl2-2b"
    jc, tc = cfgs(arch)
    p0 = jax_params(arch)
    jp = jax.tree.map(jnp.asarray, p0)
    x = embeddings(2, 12)
    steps = embeddings(3, 2, seed=8)[:, :, None]          # (3, B, 1, d)

    @jax.jit
    def jprefill(p, e, c):
        h, _, c = JT.forward(p, e, jc, mesh=mesh1, caches=c,
                             collect_caches=True)
        return JT.logits_from_hidden(p, jc, h[:, -1:], mesh1), c
    jdecode = jax.jit(lambda p, e, c: JT.decode_step(p, e, c, jc,
                                                     mesh=mesh1))
    jl, jc_ = jprefill(jp, jnp.asarray(x),
                       JT.init_caches(jc, 2, 16, dtype=jnp.float32))
    want = [np.asarray(jl)]
    for e in steps:
        jl, jc_ = jdecode(jp, jnp.asarray(e), jc_)
        want.append(np.asarray(jl))
    model = T.Transformer(tc, device="cpu", params=params_from_numpy(p0, tc))
    got = []
    with torch.inference_mode():
        caches = model.init_caches(2, 16)
        h, _, caches = model.forward(torch.from_numpy(x), caches=caches)
        got.append(model.logits_from_hidden(h[:, -1:]).numpy())
        for e in steps:
            tl, caches = model.decode_step(torch.from_numpy(e), caches)
            got.append(tl.numpy())
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=f"step {i}")
    assert all(c["pos"] == 15 for c in caches)


@pytest.mark.parametrize("arch", ARCHS)
def test_token_serving_refuses_the_frontend_presets(arch):
    """``generate`` and ``launch/serve.run`` take token prompts: both
    refuse hubert (encoder-only: no decode step) and internvl2 (a vision
    frontend: served through the API, which the message names)."""
    why = "encoder-only" if arch == "hubert-xlarge" else "decode_step"
    with pytest.raises(ValueError, match=why):
        serve.run(arch, smoke=True, batch=1, prompt_len=4, gen=2,
                  device="cpu")
    model = T.Transformer(configs.smoke_config(arch), device="cpu")
    with pytest.raises(ValueError, match=why):
        engine.generate(model, torch.zeros((1, 4), dtype=torch.long),
                        steps=2)


# ---------------------------------------------------------------------------
# training, convert, checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_train_step_matches_reference(mesh1, arch):
    """One f32 frontend batch (2 x 32, ``SyntheticLM``'s embeddings): the
    loss, the gradients and one AdamW step against the reference, with
    ``test_torch_presets.check_train_step``'s tolerances (loss rtol 2e-6,
    each gradient leaf within 1e-5 of its max, metrics rtol 2e-6,
    parameters atol 1e-5 but for 1e-4 of them within 2·lr)."""
    check_train_step(arch, None, mesh1)


def test_ce_chunks_at_the_frontend_presets_training_shapes():
    """The chunked CE's chunk count equals the reference's at the presets'
    training shapes: hubert's 781 frames (odd: one chunk) over 504
    clusters, internvl2's 4096 positions over 92553 entries (16 chunks of
    256, each chunk's logits under 2^25 elements a row)."""
    for S, V, want in ((781, 504, 1), (4096, 92553, 16)):
        assert ts._auto_chunks(S, V) == jts._auto_chunks(S, V) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_train_run_trains_a_frontend_preset(arch):
    """``launch/train.run`` trains the smoke config on the CPU when asked
    (2 steps of 2 x 24, finite, none skipped) and runs on CUDA by
    default: without a GPU it raises rather than fall back."""
    _, hist = tlaunch.run(arch, steps=2, batch=2, seq=24, smoke=True,
                          log_every=10, device="cpu")
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) and h["skipped"] == 0 for h in hist)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tlaunch.run(arch, steps=1, batch=1, seq=8, smoke=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_params_and_checkpoints_cross_both_ways(tmp_path, arch):
    """A frontend tree has no ``embed`` and an ``lm_head`` of (d, V): the
    reference's tree comes back bitwise through params_from_numpy and
    params_to_numpy; a reference TrainState saved by the JAX trainer
    restores in the port with every checkpoint key bitwise, and the port's
    state after one step saved by the port restores in the reference,
    every array equal under the same keys."""
    jc, tc = cfgs(arch)
    p0 = jax_params(arch)
    assert "embed" not in p0 and p0["lm_head"].shape == (128, 512)
    port = params_from_numpy(p0, tc)
    assert "embed" not in port and port["lm_head"].shape == (128, 512)
    back = params_to_numpy(port, tc)
    flat_j = jax.tree_util.tree_flatten_with_path(p0)
    flat_t = jax.tree_util.tree_flatten_with_path(back)
    assert flat_j[1] == flat_t[1]
    for (path, a), (_, b) in zip(flat_j[0], flat_t[0], strict=True):
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(
            path))
    kw = dict(learning_rate=3e-3, warmup_steps=1, total_steps=3)
    jstate = jts.init_train_state(RNG, jc, jconfig.TrainConfig(**kw))
    jio.save_checkpoint(str(tmp_path / "jax"), jstate, 1)
    ttc = TrainConfig(**kw)
    tmpl = ts.init_train_state(tc, ttc, device="cpu")
    assert "embed" not in tmpl.params
    state, step = restore_checkpoint(str(tmp_path / "jax"), tmpl, cfg=tc)
    want = {k: np.asarray(v) for k, v in jio._flatten(jstate).items()}
    got = state_to_numpy(state, tc)
    assert step == 1 and list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    state, _ = ts.make_train_step(tc, ttc)(
        state, SyntheticLM(tc, 2, 16, device="cpu").next_batch(0), step=0)
    save_checkpoint(str(tmp_path / "port"), state, 2, cfg=tc)
    jback, jstep = jio.restore_checkpoint(str(tmp_path / "port"), jstate)
    got = {k: np.asarray(v) for k, v in jio._flatten(jback).items()}
    want = state_to_numpy(state, tc)
    assert jstep == 2 and list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_frontend_with_a_noisy_moe_gate(mesh1):
    """internvl2's smoke config with its blocks made ``moe`` (4 experts,
    the ``gshard`` gate, whose draw is a forward input): one f32 train
    step on a frontend batch (2 x 16) given the reference's draws (its
    rng chain rebuilt, one (B·S, E) draw per layer) against the JAX
    trainer's step with that rng — loss, ce, aux, grad_norm and lr within
    rtol 2e-6, the parameters within atol 1e-5 but for 1e-4 of them
    (``check_train_step``'s budget).  Then the port's own draws: the
    train step draws one (B·S, E) row per token per layer from the
    step's generator (the same bits as drawing them by hand at that
    count), and the forward without draws makes its seed-0 ones."""
    moe = jconfigs.smoke_config("hetumoe-paper-16e").moe
    jc, tc = cfgs("internvl2-2b")
    jc = jc.replace(block_pattern=("moe",), moe=dataclasses.replace(
        moe, gate="gshard", use_pallas_gate=True))
    tc = tc.replace(block_pattern=("moe",), moe=dataclasses.replace(
        configs.smoke_config("hetumoe-paper-16e").moe, gate="gshard"))
    B, S = 2, 16
    p0 = jax.tree.map(np.asarray, JT.init_model(RNG, jc))
    kw = dict(learning_rate=3e-3, warmup_steps=1, total_steps=1)
    jtc, ttc = jconfig.TrainConfig(**kw), TrainConfig(**kw)
    jb = JSyntheticLM(jc, B, S).next_batch(0)
    tb = SyntheticLM(tc, B, S, device="cpu").next_batch(0)
    rng = jax.random.PRNGKey(3)
    jstate = jts.init_train_state(RNG, jc, jtc)
    jstate, jm = jax.jit(jts.make_train_step(jc, jtc, mesh1))(jstate, jb,
                                                              rng)
    step = ts.make_train_step(tc, ttc)
    fresh = ts.init_train_state(tc, ttc, params=params_from_numpy(p0, tc),
                                device="cpu")
    state, tm = step(fresh, tb, noise=[layer_draws("gshard", rng, tc, B * S)])
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-6,
                                   atol=1e-9, err_msg=k)
    want = jax.tree.leaves(jax.tree.map(np.asarray, jstate.params))
    got = jax.tree.leaves(params_to_numpy(state.params, tc))
    diff = np.concatenate([np.abs(a - b).ravel()
                           for a, b in zip(want, got, strict=True)])
    assert (diff > 1e-5).mean() <= 1e-4 and diff.max() <= 2 * float(jm["lr"])

    gen = ts.noise_generator(ttc, 0, "cpu")
    draws = T.draw_gate_noise(tc, B * S, gen, "cpu")
    assert [tuple(d.shape) for d in draws] == [(B * S, 4)] * 2
    fresh = ts.init_train_state(tc, ttc, params=params_from_numpy(p0, tc),
                                device="cpu")
    _, own = step(fresh, tb, step=0)
    fresh = ts.init_train_state(tc, ttc, params=params_from_numpy(p0, tc),
                                device="cpu")
    _, given = step(fresh, tb, noise=[draws])
    for k in METRIC_KEYS:
        assert float(own[k]) == float(given[k]), k
    h, aux, _ = T.forward(tree.map_(lambda t: t.detach(), fresh.params),
                          tb["inputs"], tc)
    assert h.shape == (B, S, tc.d_model) and torch.isfinite(aux)
