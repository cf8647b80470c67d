"""Training across ranks: ``launch.train.run`` on gloo CPU ranks
(``launch.mesh.spawn``) at meshes 1x2 and 2x2 against the reference
trainer at the same mesh on the conftest's fake devices — the paper
preset's smoke model (2 layers, d=128, 4 experts) in f32 from the same
initial parameters and ``SyntheticLM`` batches; the replicated leaves
bitwise equal on every rank; a NaN injected on one rank skipped on
every rank; a checkpoint saved at 2x2 resumed there."""
import dataclasses

import jax
import numpy as np
import pytest

import torch_ranks
from repro import configs as jconfigs
from repro.core import alltoall as jalltoall
from repro.core import tuning as jtuning
from repro.launch import train as jtrain
from repro.models import transformer as JT
from repro_torch.core import alltoall
from repro_torch.launch.mesh import spawn

ARCH = "hetumoe-paper-16e"
STEPS, BATCH, SEQ = 3, 4, 16
FABRIC = ("pcie_eth100", (jalltoall.PCIE, jalltoall.ETH100))
TFABRIC = ("pcie_eth100", tuple(alltoall.LinkSpec(s.alpha, s.beta)
                                for s in FABRIC[1]))
# both meshes, both dispatches (the 2x2 ranks then run the skip check,
# the 1x2 ranks a noisy gate)
CELLS = [((1, 2), "sort"), ((2, 2), "grouped")]
NOISY = dict(steps=2, batch=BATCH, seq=SEQ, dispatch="grouped",
             moe={"gate": "gshard"})


@pytest.fixture(scope="module")
def init_params():
    """The reference trainer's initial parameters (its run's seed 0) of
    the f32 smoke model."""
    cfg = jconfigs.smoke_config(ARCH).replace(dtype="float32")
    return jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(0),
                                                  cfg))


def _reference(monkeypatch, shape, dispatch):
    base = jconfigs.smoke_config

    def f32(arch):
        cfg = base(arch)
        return cfg.replace(dtype="float32", moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch))
    monkeypatch.setattr(jconfigs, "smoke_config", f32)
    prev = jtuning.set_tuning()
    try:
        _, hist = jtrain.run(ARCH, steps=STEPS, batch=BATCH, seq=SEQ,
                             smoke=True, mesh_shape=shape, log_every=1000,
                             tune="auto", fabric=FABRIC)
    finally:
        jtuning.set_tuning(*prev)
        monkeypatch.setattr(jconfigs, "smoke_config", base)
    return hist


@pytest.fixture(scope="module")
def port_runs(init_params, tmp_path_factory):
    out = {}
    for shape, dispatch in CELLS:
        ckpt = (str(tmp_path_factory.mktemp("ckpt_2x2")) if shape == (2, 2)
                else None)
        out[shape, dispatch] = spawn(
            torch_ranks.train_rank, shape[0] * shape[1], backend="gloo",
            threads=1, args=(shape, ARCH, init_params, dict(
                steps=STEPS, batch=BATCH, seq=SEQ, dispatch=dispatch),
                dict(tune="auto", fabric=TFABRIC), jtuning.NOMINAL_FLOPS,
                ckpt, NOISY if shape == (1, 2) else None))
    return out


@pytest.mark.parametrize("shape,dispatch", CELLS,
                         ids=[f"{s[0]}x{s[1]}-{d}" for s, d in CELLS])
def test_train_run_history_matches_reference(port_runs, monkeypatch, shape,
                                             dispatch):
    """Each step's loss, ce, aux, grad norm and lr equal the reference
    trainer's at the same mesh (f32: relative 2e-5 — the gradients are
    summed over the ranks in another order than XLA's), on every rank;
    nothing skipped."""
    want = _reference(monkeypatch, shape, dispatch)
    for r in port_runs[shape, dispatch]:
        assert len(r["history"]) == STEPS
        for s, (t, j) in enumerate(zip(r["history"], want, strict=True)):
            for k in ("loss", "ce", "aux", "grad_norm", "lr"):
                np.testing.assert_allclose(t[k], j[k], rtol=2e-5, atol=1e-9,
                                           err_msg=f"step {s} {k}")
            assert t["skipped"] == 0


@pytest.mark.parametrize("shape,dispatch", CELLS,
                         ids=[f"{s[0]}x{s[1]}-{d}" for s, d in CELLS])
def test_replicated_leaves_bitwise_equal_across_ranks(port_runs, shape,
                                                      dispatch):
    """After the steps every rank holds the same replicated leaves, bit
    for bit, and the data replicas of a model column the same experts."""
    ranks = port_runs[shape, dispatch]
    for r in ranks[1:]:
        for a, b in zip(ranks[0]["replicated"], r["replicated"],
                        strict=True):
            np.testing.assert_array_equal(a, b)
    D, M = shape
    for m in range(M):
        for d in range(1, D):
            for a, b in zip(ranks[m]["experts"], ranks[d * M + m]["experts"],
                            strict=True):
                np.testing.assert_array_equal(a, b)


def test_nan_on_one_rank_is_skipped_on_every_rank(port_runs):
    """A NaN in rank 1's gradients at step 1 skips step 1 on all four
    ranks of 2x2 (the guard's ``ok`` all-reduced with MIN): params and
    moments bitwise unchanged there, steps 0 and 2 applied."""
    for r in port_runs[(2, 2), "grouped"]:
        assert r["skip"]["skipped"] == [0, 1, 1]
        assert r["skip"]["unchanged"] == [False, True, False]


def test_checkpoint_dir_with_a_mesh_saves_and_resumes(port_runs):
    """run() at 2x2 with --ckpt-dir saves every 2 of 4 steps (and at the
    end); resumed from the step-2 checkpoint on every rank, it ends
    bitwise equal to the uninterrupted run, every leaf of params, moments
    and counters."""
    ranks = port_runs[(2, 2), "grouped"]
    for r in ranks:
        assert r["skip"]["ckpt"]["start"] == 2
        assert r["skip"]["ckpt"]["saves"] == 1
    ck = ranks[0]["skip"]["ckpt"]
    assert set(ck["whole"]) == set(ck["resumed"])
    for k, v in ck["whole"].items():
        np.testing.assert_array_equal(ck["resumed"][k], v, err_msg=k)


def test_noisy_gate_across_ranks_equals_one_device(port_runs, init_params):
    """gshard's noise is drawn for the global tokens from the step's
    generator and each rank routes with its rows: dropless grouped at 1x2
    gives the port's one-device history (f32, relative 2e-5)."""
    import torch_ranks as tr
    from repro_torch.launch import train
    base = train.configs.smoke_config
    try:
        tr._f32_smoke(train.configs)
        _, want = train.run(ARCH, smoke=True, device="cpu",
                            init_params=init_params, log_every=1000, **NOISY)
    finally:
        train.configs.smoke_config = base
    for r in port_runs[(1, 2), "sort"]:
        for t, w in zip(r["noisy"], want, strict=True):
            for k in ("loss", "ce", "aux", "grad_norm"):
                np.testing.assert_allclose(t[k], w[k], rtol=2e-5, atol=1e-9)
