"""Rematerialisation in the port's trainer: ``remat="block"`` and
``"full"`` steps bitwise equal to ``"none"`` (noisy gates included, whose
draws are inputs of the recomputed block), equal to the reference's remat
steps within the train-step parity budget, and the forward kernels' wrappers
called twice a step — the counts ``chip_smoke.py`` phase 9 expects on the
card."""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import config as jconfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.training import train_step as jts
from repro_torch import configs, tree
from repro_torch.convert import params_from_numpy
from repro_torch.core.config import TrainConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import build
from repro_torch.models import transformer as T
from repro_torch.training import train_step as ts
from test_torch_gating import layer_draws

ARCH = "hetumoe-paper-16e"
RNG = jax.random.PRNGKey(3)
GATES = {"switch": {}, "gshard": {}, "dense_to_sparse": dict(top_k=2),
         "ktop1": dict(num_prototypes=2)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: at the smoke widths a
    torch op is too small to share out, and the parallel test workers
    would otherwise contend for the cores with 8 threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(gate="switch", dispatch="grouped"):
    tc = configs.smoke_config(ARCH).replace(dtype="float32")
    return tc.replace(moe=dataclasses.replace(tc.moe, dispatch=dispatch,
                                              gate=gate, **GATES[gate]))


def _jcfg(gate="switch", dispatch="grouped"):
    jc = jconfigs.smoke_config(ARCH).replace(dtype="float32")
    return jc.replace(moe=dataclasses.replace(
        jc.moe, dispatch=dispatch, gate=gate, use_pallas_gate=True,
        **GATES[gate]))


@pytest.fixture(scope="module")
def jax_init():
    jc = _jcfg()
    return jax.tree.map(np.asarray,
                        jts.init_train_state(RNG, jc, jconfig.TrainConfig())
                        .params)


def _run(tc, remat, jax_init, steps=2, seq=32, batch=2):
    tcfg = TrainConfig(total_steps=steps, warmup_steps=1, remat=remat)
    state = ts.init_train_state(tc, tcfg,
                                params=params_from_numpy(jax_init, tc),
                                device="cpu")
    step = ts.make_train_step(tc, tcfg)
    ds = SyntheticLM(tc, batch, seq, device="cpu")
    hist = []
    for s in range(steps):
        state, m = step(state, ds.next_batch(s), step=s)
        hist.append({k: v.item() for k, v in m.items()})
    return state, hist


@pytest.mark.parametrize("remat", ["block", "full"])
@pytest.mark.parametrize("gate,dispatch", [("switch", "grouped"),
                                           ("switch", "sort"),
                                           ("gshard", "grouped"),
                                           ("dense_to_sparse", "grouped")])
def test_remat_steps_bitwise_equal_none(jax_init, gate, dispatch, remat):
    """Two AdamW steps: every metric and every parameter and moment
    bitwise equal to the steps without remat — the recomputed block runs
    the same kernels on the same inputs, and a noisy gate routes with the
    same draws (drawn before the forward, keyed by the step)."""
    tc = _tcfg(gate, dispatch)
    s0, h0 = _run(tc, "none", jax_init)
    s1, h1 = _run(tc, remat, jax_init)
    assert h0 == h1
    for a, b in zip(tree.leaves((s0.params, s0.opt)),
                    tree.leaves((s1.params, s1.opt)), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("gate,remat", [("switch", "block"),
                                        ("switch", "full"),
                                        ("gshard", "block"),
                                        ("dense_to_sparse", "full"),
                                        ("ktop1", "block")])
def test_remat_steps_match_reference(mesh1, jax_init, gate, remat):
    """Two f32 remat steps of the smoke model from the reference's initial
    parameters on the same batches, the port given the reference's gate
    draws (its step rng through the model's chain): loss, ce, aux,
    grad_norm and lr within rtol 2e-6 each step (f32 sums in other
    orders, the budget of the port's train-step parity tests)."""
    jc, tc = _jcfg(gate), _tcfg(gate)
    kw = dict(learning_rate=3e-3, warmup_steps=1, total_steps=2, remat=remat)
    jtc, ttc = jconfig.TrainConfig(**kw), TrainConfig(**kw)
    jparams = jax.tree.map(jnp.asarray, jax_init)
    zero = jnp.zeros((), jnp.int32)
    jstate = jts.TrainState(jparams, jts.init_opt_state(jparams, jtc), zero,
                            skipped=zero, nonfinite_streak=zero,
                            good_streak=zero, loss_scale=jnp.float32(1.0))
    tstate = ts.init_train_state(tc, ttc,
                                 params=params_from_numpy(jax_init, tc),
                                 device="cpu")
    jstep = jax.jit(jts.make_train_step(jc, jtc, mesh1))
    tstep = ts.make_train_step(tc, ttc)
    jd, td = JSyntheticLM(jc, 2, 32), SyntheticLM(tc, 2, 32, device="cpu")
    for s in range(2):
        r = jax.random.fold_in(RNG, s)
        jstate, jm = jstep(jstate, jd.next_batch(s), r)
        noise = ([layer_draws(gate, r, tc, 64)]
                 if gate in ("gshard", "dense_to_sparse") else None)
        tstate, tm = tstep(tstate, td.next_batch(s), step=s, noise=noise)
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-6,
                                       atol=1e-9, err_msg=f"step {s} {k}")


@pytest.mark.parametrize("seq,flash", [(16, False), (640, True)])
def test_remat_runs_the_forward_kernels_twice(monkeypatch, seq, flash):
    """Kernel wrappers called per train step (2 layers, grouped, switch):
    under remat the gate, the gather and the grouped matmul forward, the
    combine's scatter-add — and past q_chunk the flash forward — run
    twice, the backward kernels (the gather among them, the combine's
    VJP) once."""
    seen = collections.Counter()
    real = build.dispatch_device
    monkeypatch.setattr(build, "dispatch_device",
                        lambda name, t: seen.update([name]) or real(name, t))
    tc = _tcfg()
    counts = {}
    for remat in ("none", "block", "full"):
        seen.clear()
        tcfg = TrainConfig(total_steps=2, warmup_steps=1, remat=remat)
        state = ts.init_train_state(tc, tcfg, device="cpu")
        ts.make_train_step(tc, tcfg)(
            state, SyntheticLM(tc, 1, seq, device="cpu").next_batch(0))
        counts[remat] = dict(seen)
    f = 2 if flash else 0
    want = {"none": {"fused_topk_gate": 2, "gather_rows": 4,
                     "grouped_matmul": 4, "grouped_matmul_t": 4,
                     "grouped_drhs": 4, "scatter_add_rows": 4,
                     "flash_fwd": f, "flash_dq": f, "flash_dkv": f}}
    want["block"] = want["full"] = {
        **want["none"], "fused_topk_gate": 4, "gather_rows": 6,
        "grouped_matmul": 8, "scatter_add_rows": 6, "flash_fwd": 2 * f}
    for remat in want:
        assert counts[remat] == {k: v for k, v in want[remat].items() if v}, (
            remat, counts[remat])


def test_forward_rejects_unknown_remat_and_caches():
    tc = _tcfg()
    params = T.init_params(tc, torch.Generator().manual_seed(0))
    toks = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="remat"):
        T.forward(params, toks, tc, remat="some")
    with pytest.raises(ValueError, match="caches"):
        T.forward(params, toks, tc, remat="block", caches=[])


def test_noisy_gate_step_needs_the_step_index():
    tc = _tcfg("gshard")
    tcfg = TrainConfig(total_steps=2, warmup_steps=1)
    state = ts.init_train_state(tc, tcfg, device="cpu")
    batch = SyntheticLM(tc, 1, 8, device="cpu").next_batch(0)
    with pytest.raises(ValueError, match="step"):
        ts.make_train_step(tc, tcfg)(state, batch)
