"""The port's training path against the JAX package: the MoE layer's
gradients, the optimizer pieces, the synthetic data, whole train steps
and the CLI.

The same numpy inputs (or the reference's own initial parameters, through
``convert``) go to both sides; the reference runs on ``mesh1`` with its
Pallas kernels in interpret mode (``use_pallas_gate=True``, so its
``custom_vjp`` backward kernels run), the port on the CPU with its
kernels' plain versions.  Every tolerance is stated at its assertion.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import config as jconfig
from repro.core import moe as jmoe
from repro.data import SyntheticLM as JSyntheticLM
from repro.optim import adamw as jadamw
from repro.training import train_step as jts
from repro_torch import configs, tree
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import moe
from repro_torch.core import config as tconfig
from repro_torch.core.config import TrainConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import grouped_ffn as G
from repro_torch.kernels import layout_transform as L
from repro_torch.launch import train as tlaunch
from repro_torch.optim import adamw
from repro_torch.training import train_step as ts

ARCH = "hetumoe-paper-16e"
RNG = jax.random.PRNGKey(3)


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(v), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


# ---------------------------------------------------------------------------
# the MoE layer's gradients
# ---------------------------------------------------------------------------

def _moe_params():
    rng = np.random.default_rng(31)
    E, d, f = 4, 32, 48
    return {"gate_w": rng.standard_normal((d, E)).astype(np.float32) * 0.3,
            "w_up": rng.standard_normal((E, d, f)).astype(np.float32) * 0.2,
            "w_out": rng.standard_normal((E, f, d)).astype(np.float32) * 0.2}


@pytest.mark.parametrize("gate,top_k", [("switch", 1), ("topk", 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dispatch", ["grouped", "sort"])
def test_moe_layer_gradients_match_reference(mesh1, dispatch, dtype, gate,
                                             top_k):
    """Value and gradients of sum(y·r) + aux with respect to x, gate_w,
    w_up and w_out: moe_apply (through the kernels' autograd Functions)
    against jax.grad of a jitted sharded_moe_apply on the 1×1 mesh.

    f32: value rtol 1e-5, every gradient within 1e-5 of its leaf's
    max|grad| (f32 sums in other orders).  bf16: value rtol 1e-2, the x
    gradient (bf16) and the f32 weight gradients within 3e-2 of their
    leaf's max|grad| — each side rounds the activations and the
    cotangents to bf16 after every product, in sums of other orders, so
    a rounding can land one bf16 ulp (2^-8 relative) apart and the
    following products carry it.  top_k=2 gives every token two rows, so
    the scatter-add accumulates duplicates."""
    fields = dict(num_experts=4, top_k=top_k, gate=gate, dispatch=dispatch,
                  use_pallas_gate=True, d_ff_expert=48, capacity_factor=1.0,
                  router_z_loss_weight=1e-3)
    jc, tc = jconfig.MoEConfig(**fields), tconfig.MoEConfig(**fields)
    p = _moe_params()
    rng = np.random.default_rng(32)
    x = rng.standard_normal((2, 20, 32)).astype(np.float32)
    r = rng.standard_normal((2, 20, 32)).astype(np.float32)

    def jf(pp, xx):
        y, aux, _ = jmoe.sharded_moe_apply(mesh1, jc, pp, xx, num_experts=4,
                                           act="relu")
        return jnp.sum(y.astype(jnp.float32) * r) + aux
    jv, (jgp, jgx) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(x).astype(dtype))

    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    y, aux, _ = moe.moe_apply(tc, tp, tx, num_experts=4, act="relu")
    tv = (y.float() * torch.from_numpy(r)).sum() + aux
    tv.backward()
    assert tx.grad.dtype == tx.dtype
    assert all(v.grad.dtype == torch.float32 for v in tp.values())

    f32 = dtype == "float32"
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5 if f32
                               else 1e-2)
    pairs = [("x", tx.grad, jgx)] + [(k, tp[k].grad, jgp[k]) for k in p]
    for name, t, j in pairs:
        j = np.asarray(j.astype(jnp.float32))
        t = t.float().numpy()
        scale = np.abs(j).max()
        assert scale > 0, name
        err = np.abs(t - j).max() / scale
        assert err <= (1e-5 if f32 else 3e-2), (name, err)


def test_train_step_goes_through_the_backward_wrappers(monkeypatch):
    """One train step per dispatch mode calls the backward kernels'
    wrappers as many times as chip_smoke.py expects their kernels to
    launch on the card (2 layers, relu, k=1): grouped — 4 dlhs, 4 drhs,
    2 scatter-adds; sort — 4 scatter-adds."""
    calls = {}

    def counting(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)
    counting(L, "scatter_add_rows")
    counting(G, "grouped_matmul_t")
    counting(G, "grouped_drhs")
    want = {"grouped": {"scatter_add_rows": 2, "grouped_matmul_t": 4,
                        "grouped_drhs": 4},
            "sort": {"scatter_add_rows": 4}}
    for dispatch in ("grouped", "sort"):
        calls.clear()
        tc = _tcfg(dispatch)
        tcfg = TrainConfig(total_steps=2, warmup_steps=1)
        state = ts.init_train_state(tc, tcfg, device="cpu")
        batch = SyntheticLM(tc, 2, 16, device="cpu").next_batch(0)
        ts.make_train_step(tc, tcfg)(state, batch)
        assert calls == want[dispatch], (dispatch, calls)


# ---------------------------------------------------------------------------
# optimizer pieces and data
# ---------------------------------------------------------------------------

def _tree_np(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_and_clip_match_reference(state_dtype):
    """Two AdamW updates after global-norm clipping, from the same params,
    grads and lr: the norm within rtol 1e-6; params and moments within
    rtol 1e-5, plus atol 1e-5·max|leaf| where a moment cancels between its
    two terms — the same f32 arithmetic in the same order, but the norm's
    f32 sum adds in another order, so the clip scale and every value
    after it may differ by a few ulps; bf16 moments within 1 bf16 ulp."""
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 2)}
    p, g1, g2 = (_tree_np(s, shapes) for s in (40, 41, 42))
    g2 = {k: v * 30 for k, v in g2.items()}     # clipped
    kw = dict(learning_rate=1e-2, weight_decay=0.1,
              optimizer_state_dtype=state_dtype)
    jc, tc = jconfig.TrainConfig(**kw), TrainConfig(**kw)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jst, tst = jadamw.init_opt_state(jp, jc), adamw.init_opt_state(tp, tc)
    assert all(v.dtype == getattr(torch, state_dtype)
               for v in tst["m"].values())
    for g in (g1, g2):
        jg, jn = jadamw.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
        tg, tn = adamw.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
        np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
        jp, jst = jadamw.adamw_update(jg, jst, jp, jc, jnp.float32(1e-2))
        tp, tst = adamw.adamw_update(tg, tst, tp, tc,
                                     torch.tensor(1e-2, dtype=torch.float32))
    assert int(tst["count"]) == int(jst["count"]) == 2
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-8)
        for mom in ("m", "v"):
            t = tst[mom][k].float().numpy()
            j = np.asarray(jst[mom][k].astype(jnp.float32))
            if state_dtype == "float32":
                np.testing.assert_allclose(t, j, rtol=1e-5,
                                           atol=1e-5 * np.abs(j).max())
            else:
                assert (np.abs(t - j) <= _bf16_ulp(j)).all()


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_schedule_matches_reference(schedule):
    """Warm-up then decay: equal to the reference at every step, rtol
    1e-6 (the same f32 arithmetic; cos may differ in the last bit)."""
    kw = dict(learning_rate=1e-3, warmup_steps=10, total_steps=100,
              schedule=schedule)
    js = jadamw.make_schedule(jconfig.TrainConfig(**kw))
    tsch = adamw.make_schedule(TrainConfig(**kw))
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        t = tsch(torch.tensor(s, dtype=torch.int32)).item()
        np.testing.assert_allclose(t, float(js(jnp.asarray(s))), rtol=1e-6,
                                   atol=1e-12, err_msg=str(s))


def test_synthetic_batches_equal_reference():
    """Bitwise: the same numpy draws in the same order."""
    jc, tc = jconfigs.smoke_config(ARCH), configs.smoke_config(ARCH)
    jd, td = JSyntheticLM(jc, 3, 40, seed=5), SyntheticLM(tc, 3, 40, seed=5,
                                                          device="cpu")
    for step in (0, 1, 7):
        jb, tb = jd.next_batch(step), td.next_batch(step)
        assert set(jb) == set(tb)
        for k in jb:
            assert tb[k].dtype == {"inputs": torch.int32,
                                   "targets": torch.int32,
                                   "loss_mask": torch.float32}[k]
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


# ---------------------------------------------------------------------------
# whole train steps
# ---------------------------------------------------------------------------

def _jcfg(dispatch, **moe_kw):
    jc = jconfigs.smoke_config(ARCH)
    return jc.replace(dtype="float32", moe=dataclasses.replace(
        jc.moe, use_pallas_gate=True, dispatch=dispatch, **moe_kw))


def _tcfg(dispatch, **moe_kw):
    tc = configs.smoke_config(ARCH)
    return tc.replace(dtype="float32", moe=dataclasses.replace(
        tc.moe, dispatch=dispatch, **moe_kw))


@pytest.fixture(scope="module")
def jax_init():
    """The reference's initial smoke-model parameters (numpy)."""
    jc = _jcfg("grouped")
    state = jts.init_train_state(RNG, jc, jconfig.TrainConfig())
    return jax.tree.map(np.asarray, state.params)


def _port_state(jax_init, tc, tcfg):
    return ts.init_train_state(tc, tcfg,
                               params=params_from_numpy(jax_init, tc),
                               device="cpu")


def _train_steps_match(mesh1, jax_init, dispatch, *, steps, batch, seq,
                       microbatches=1):
    """``steps`` f32 AdamW steps of the smoke model on both sides from the
    same parameters and SyntheticLM batches; the tolerances are
    ``test_train_steps_match_reference``'s."""
    jc, tc = _jcfg(dispatch), _tcfg(dispatch)
    kw = dict(learning_rate=3e-3, warmup_steps=1, total_steps=steps,
              microbatches=microbatches)
    jtc, ttc = jconfig.TrainConfig(**kw), TrainConfig(**kw)
    jstate = jts.TrainState(
        jax.tree.map(jnp.asarray, jax_init),
        jadamw.init_opt_state(jax.tree.map(jnp.asarray, jax_init), jtc),
        jnp.zeros((), jnp.int32), skipped=jnp.zeros((), jnp.int32),
        nonfinite_streak=jnp.zeros((), jnp.int32),
        good_streak=jnp.zeros((), jnp.int32), loss_scale=jnp.float32(1.0))
    tstate = _port_state(jax_init, tc, ttc)
    jstep = jax.jit(jts.make_train_step(jc, jtc, mesh1))
    tstep = ts.make_train_step(tc, ttc)
    jd = JSyntheticLM(jc, batch, seq)
    td = SyntheticLM(tc, batch, seq, device="cpu")
    lrs = 0.0
    for s in range(steps):
        jstate, jm = jstep(jstate, jd.next_batch(s), RNG)
        tstate, tm = tstep(tstate, td.next_batch(s))
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=2e-6, atol=1e-9,
                                       err_msg=f"step {s} {k}")
        assert float(tm["skipped"]) == 0
        lrs += float(jm["lr"])
    assert int(tstate.opt["count"]) == steps and int(tstate.step) == steps
    want = jax.tree.leaves(jax.tree.map(np.asarray, jstate.params))
    got = jax.tree.leaves(params_to_numpy(tstate.params, tc))
    diff = np.concatenate([np.abs(a - b).ravel() for a, b in zip(want, got,
                                                                strict=True)])
    assert (diff > 1e-5).mean() <= 1e-4, (diff > 1e-5).sum()
    assert diff.max() <= 2 * lrs, diff.max()


@pytest.mark.parametrize("dispatch,microbatches", [("grouped", 1),
                                                   ("sort", 1),
                                                   ("grouped", 2)])
def test_train_steps_match_reference(mesh1, jax_init, dispatch,
                                     microbatches):
    """Three f32 AdamW steps of the smoke model from the same parameters on
    the same SyntheticLM batches: loss, ce, aux, grad_norm and lr equal
    the reference's each step within rtol 2e-6 (f32 sums in other
    orders); the final parameters within atol 1e-5 except at most 1e-4 of
    the elements, and those within 2·Σlr — Adam's first steps move a
    parameter by about ±lr wherever |grad| ≫ eps, so a gradient near 0
    that differs in its last bits can flip the direction of one step."""
    _train_steps_match(mesh1, jax_init, dispatch, steps=3, batch=4, seq=32,
                       microbatches=microbatches)


@pytest.mark.parametrize("dispatch", ["grouped", "sort"])
def test_long_sequence_train_steps_match_reference(mesh1, jax_init,
                                                   dispatch):
    """Two f32 AdamW steps at batch 1 × seq 640, over q_chunk=512: the
    attention and its backward take the flash path on both sides (the
    port's forward, dq and dk/dv plain versions through
    ``FlashAttention``; the reference's Pallas kernels in interpret mode
    through its ``custom_vjp``), at the tolerances of
    ``test_train_steps_match_reference``."""
    _train_steps_match(mesh1, jax_init, dispatch, steps=2, batch=1, seq=640)


def test_train_step_goes_through_the_flash_wrappers(monkeypatch):
    """The flash wrappers are called as often as chip_smoke.py expects the
    kernels to launch on the card: per train step of 2 layers at seq 640,
    forward 2, dq 2, dk/dv 2; at seq 16 (<= q_chunk) none."""
    from repro_torch.kernels import flash_attention as F
    calls = {}
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        fn = getattr(F, name)

        def wrapped(*a, _fn=fn, _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a)
        monkeypatch.setattr(F, name, wrapped)
    tc = _tcfg("grouped")
    tcfg = TrainConfig(total_steps=2, warmup_steps=1)
    step = ts.make_train_step(tc, tcfg)
    for seq, want in ((16, {}), (640, {"flash_fwd": 2, "flash_dq": 2,
                                       "flash_dkv": 2})):
        calls.clear()
        state = ts.init_train_state(tc, tcfg, device="cpu")
        step(state, SyntheticLM(tc, 1, seq, device="cpu").next_batch(0))
        assert calls == want, (seq, calls)


def test_microbatches_two_equal_one(jax_init):
    """With the router losses off and the dropless dispatch, the loss of a
    batch does not couple its tokens, so microbatches=2 gives the same
    step as 1: ce rtol 1e-5; params rtol 2e-3 / atol 1e-5 (the reference's
    own tolerance for this check: the gradients are summed in another
    order)."""
    tc = _tcfg("grouped", aux_loss_weight=0.0)
    out = []
    for mbs in (1, 2):
        tcfg = TrainConfig(total_steps=2, warmup_steps=0, microbatches=mbs)
        state = _port_state(jax_init, tc, tcfg)
        batch = SyntheticLM(tc, 4, 16, device="cpu").next_batch(0)
        out.append(ts.make_train_step(tc, tcfg)(state, batch))
    (s1, m1), (s2, m2) = out
    assert float(m1["aux"]) == float(m2["aux"]) == 0.0
    np.testing.assert_allclose(float(m2["ce"]), float(m1["ce"]), rtol=1e-5)
    for a, b in zip(tree.leaves(s1.params), tree.leaves(s2.params),
                    strict=True):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=2e-3, atol=1e-5)


def test_chunked_ce_equals_full_and_reference(mesh1, jax_init):
    """chunked_ce_loss at 1, 2 and 8 chunks: the value equals the
    reference's (rtol 1e-6) and the 1-chunk value (rtol 1e-5, sums in
    another order), and the checkpointed chunks give the 1-chunk
    gradients (rtol 1e-5 / atol 1e-7).  At S=512 and V=50304 the
    reference's chunk rule picks one chunk."""
    assert ts._auto_chunks(512, 50304) == 1 == jts._auto_chunks(512, 50304)
    jc, tc = _jcfg("grouped"), _tcfg("grouped")
    rng = np.random.default_rng(43)
    h = rng.standard_normal((2, 32, tc.d_model)).astype(np.float32)
    t = rng.integers(0, tc.vocab_size, (2, 32)).astype(np.int32)
    m = (rng.random((2, 32)) < 0.9).astype(np.float32)
    params = ts.init_train_state(tc, TrainConfig(),
                                 params=params_from_numpy(jax_init, tc),
                                 device="cpu").params
    base = grads = None
    for nc in (1, 2, 8):
        j = float(jts.chunked_ce_loss(jax.tree.map(jnp.asarray, jax_init), jc,
                                      jnp.asarray(h), jnp.asarray(t),
                                      jnp.asarray(m), mesh1, num_chunks=nc))
        th = torch.from_numpy(h).requires_grad_()
        v = ts.chunked_ce_loss(params, tc, th, torch.from_numpy(t),
                               torch.from_numpy(m), num_chunks=nc)
        g = torch.autograd.grad(v, [th, params["lm_head"]])
        np.testing.assert_allclose(v.item(), j, rtol=1e-6)
        if nc == 1:
            base, grads = v.item(), g
            continue
        np.testing.assert_allclose(v.item(), base, rtol=1e-5)
        for a, b in zip(g, grads):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-7)


def _poison(state, value):
    """A copy of ``state`` whose first query weight holds ``value``."""
    params = tree.map_(lambda p: p.detach().clone().requires_grad_(),
                       state.params)
    with torch.no_grad():
        params["blocks"][0]["attn"]["wq"][0, 0] = value
    return state._replace(params=params)


def _bits_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree.leaves(a),
                                                 tree.leaves(b),
                                                 strict=True))


def test_nonfinite_step_leaves_state_bitwise_unchanged(jax_init):
    """A parameter set to inf makes the loss non-finite: the step is
    skipped — params, moments and the Adam count keep their bits — and
    counted (skipped 1, streak 1, good streak 0); the next finite step
    updates and resets the streak, as in the reference."""
    tc = _tcfg("grouped")
    tcfg = TrainConfig(total_steps=4, warmup_steps=0)
    step = ts.make_train_step(tc, tcfg)
    ds = SyntheticLM(tc, 2, 16, device="cpu")
    state, _ = step(_port_state(jax_init, tc, tcfg), ds.next_batch(0))
    saved = state.params["blocks"][0]["attn"]["wq"][0, 0].item()
    bad = _poison(state, float("inf"))
    after, m = step(bad, ds.next_batch(1))
    assert not np.isfinite(float(m["loss"]))
    assert _bits_equal(after.params, bad.params)
    assert _bits_equal(after.opt, bad.opt) and int(after.opt["count"]) == 1
    assert (int(after.skipped), int(after.nonfinite_streak),
            int(after.good_streak), int(after.step)) == (1, 1, 0, 2)
    assert float(m["skipped"]) == 1 and float(m["nonfinite_streak"]) == 1
    good, m = step(_poison(after, saved), ds.next_batch(2))
    assert np.isfinite(float(m["loss"])) and int(good.opt["count"]) == 2
    assert (int(good.skipped), int(good.nonfinite_streak),
            int(good.good_streak)) == (1, 0, 1)
    assert not _bits_equal(good.params, after.params)


def test_dynamic_loss_scale_halves_on_a_bad_step_and_grows(jax_init):
    """loss_scale="dynamic" starts at 2^15, halves on a non-finite step
    and doubles after ``loss_scale_growth_interval`` finite ones (the good
    streak then restarts).  A finite scaled step equals the unscaled one
    (a power-of-two scale is exact in f32): params rtol 1e-6."""
    tc = _tcfg("grouped")
    dyn = TrainConfig(total_steps=6, warmup_steps=0, loss_scale="dynamic",
                      loss_scale_growth_interval=2)
    ds = SyntheticLM(tc, 2, 16, device="cpu")
    step = ts.make_train_step(tc, dyn)
    state = _port_state(jax_init, tc, dyn)
    assert float(state.loss_scale) == 2.0 ** 15
    plain = TrainConfig(total_steps=6, warmup_steps=0)
    ref, _ = ts.make_train_step(tc, plain)(_port_state(jax_init, tc, plain),
                                           ds.next_batch(0))
    state, m = step(state, ds.next_batch(0))
    for a, b in zip(tree.leaves(state.params), tree.leaves(ref.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-9)
    assert float(m["loss_scale"]) == 2.0 ** 15 and int(state.good_streak) == 1
    saved = state.params["blocks"][0]["attn"]["wq"][0, 0].item()
    state, m = step(_poison(state, float("inf")), ds.next_batch(1))
    assert float(m["loss_scale"]) == 2.0 ** 14 and int(state.good_streak) == 0
    state = _poison(state, saved)
    state, m = step(state, ds.next_batch(2))
    assert float(m["loss_scale"]) == 2.0 ** 14 and int(state.good_streak) == 1
    state, m = step(state, ds.next_batch(3))
    assert float(m["loss_scale"]) == 2.0 ** 15 and int(state.good_streak) == 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_train_cli_runs_on_cpu(tmp_path, capsys):
    """The smoke trainer runs on the CPU and writes its history; its loss
    trajectory equals the entry point's run() with the same flags
    (deterministic seeds)."""
    out = tmp_path / "hist.json"
    tlaunch.main(["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2",
                  "--seq", "16", "--device", "cpu", "--history-out",
                  str(out)])
    hist = json.loads(out.read_text())
    assert hist["arch"] == ARCH + "-smoke" and hist["steps"] == 3
    assert [h["step"] for h in hist["history"]] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and h["skipped"] == 0
               for h in hist["history"])
    assert "history written to" in capsys.readouterr().out
    stats = {}
    _, again = tlaunch.run(ARCH, steps=3, batch=2, seq=16, smoke=True,
                           device="cpu", stats=stats)
    assert [h["loss"] for h in again] == [h["loss"] for h in
                                          hist["history"]]
    assert len(stats["step_s"]) == 3


def test_train_run_applies_the_dispatch_keyword(capsys):
    tlaunch.run(ARCH, steps=1, batch=2, seq=16, smoke=True, device="cpu",
                dispatch="grouped")
    assert "dispatch=grouped" in capsys.readouterr().out
    with pytest.raises(ValueError, match="dispatch"):
        tlaunch.run(ARCH, steps=1, batch=2, seq=16, smoke=True, device="cpu",
                    dispatch="nope")


@pytest.mark.parametrize("argv", [["--mesh", "2x2"],
                                  ["--tune", "calibrate"]])
def test_train_cli_rejects_unported_flags(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tlaunch.main(["--arch", ARCH, "--smoke", "--steps", "1",
                      "--device", "cpu", *argv])
