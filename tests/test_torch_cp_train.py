"""Training with rows split over ranks (context parallelism) on gloo CPU
ranks (``launch.mesh.spawn``; rank bodies in ``tests/torch_ranks.py``)
against the JAX package on one of the conftest's fake devices, from the
reference's initial parameters: ``gemma2-9b`` (``local`` / ``global``,
softcap 50) and ``h2o-danube-3-4b`` (every layer a sliding window) at
smoke size, batch 2 x 640 at 2x2 — each row split over two ranks, 320
positions each, the whole row past ``q_chunk`` (512) so the flash path
runs, its 32-wide window reaching across the chunks' boundary — and
gemma2 again under FSDP; ``rwkv6-1.6b`` and ``zamba2-7b`` (recurrent
blocks gathering their whole rows) at 1x2 with one row.  Tolerances are
stated at each assertion."""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_ranks
from repro import configs as jconfigs
from repro.core import tuning as jtuning
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import train as jtrain
from repro.models import transformer as JT
from repro.training import train_step as jts
from repro_torch.launch.mesh import spawn
from test_torch_fsdp import _close, _flatten_state
from test_torch_recurrent import jax_params

_SMOKE = jconfigs.smoke_config
STEPS = 2            # the first step's lr is 0 (one warm-up step)
WINDOWED = ("gemma2-9b", "h2o-danube-3-4b")
B, S = 2, 640
# (key, arch, run keywords beyond the shared ones)
CELLS = [("gemma2-9b", "gemma2-9b", {}),
         ("h2o-danube-3-4b", "h2o-danube-3-4b", {}),
         ("gemma2-9b-fsdp", "gemma2-9b", {"fsdp": True})]
RECURRENT = ("rwkv6-1.6b", "zamba2-7b")
R_S = 32             # one row of 32, 16 positions a rank


def _f32(arch):
    return _SMOKE(arch).replace(dtype="float32")


def _init(arch):
    return jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(0),
                                                  _f32(arch)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of four ranks (the windowed cells at 2x2), one of two
    (the recurrent cells at 1x2)."""
    tmp = tmp_path_factory.mktemp("cp_train")
    paths = {}
    for arch in WINDOWED + RECURRENT:
        paths[arch] = str(tmp / f"{arch}.pkl")
        with open(paths[arch], "wb") as f:
            pickle.dump(_init(arch) if arch in WINDOWED
                        else jax_params(arch), f)
    jobs = [(key, "cp_train", ((2, 2), arch, paths[arch],
                               dict(steps=STEPS, batch=B, seq=S, **kw)))
            for key, arch, kw in CELLS]
    four = spawn(torch_ranks.jobs_rank, 4, backend="gloo", threads=1,
                 args=(jobs,))
    jobs = [(arch, "cp_grads", ((1, 2), arch, paths[arch], 1, R_S))
            for arch in RECURRENT]
    two = spawn(torch_ranks.jobs_rank, 2, backend="gloo", threads=1,
                args=(jobs,))
    return four, two


@pytest.fixture(scope="module")
def reference():
    """The reference trainer on one device, each windowed preset."""
    out = {}
    mp = pytest.MonkeyPatch()
    prev = jtuning.set_tuning()
    try:
        mp.setattr(jconfigs, "smoke_config", _f32)
        for arch in WINDOWED:
            st, hist = jtrain.run(arch, steps=STEPS, batch=B, seq=S,
                                  smoke=True, log_every=1000, tune="off")
            out[arch] = (hist, {k: np.asarray(v)
                                for k, v in _flatten_state(st).items()})
    finally:
        mp.undo()
        jtuning.set_tuning(*prev)       # tune="off" is the process's mode
    return out


@pytest.mark.parametrize("key,arch,kw", CELLS, ids=[c[0] for c in CELLS])
def test_windowed_train_steps_with_split_rows_match_one_device(
        ranks, reference, key, arch, kw):
    """Two AdamW steps (the first at lr 0) at 2x2 with two rows of 640,
    each split over two ranks (the row's k and v gathered once a layer
    and forward — twice under FSDP, whose blocks recompute — the flash
    path chosen by the whole row's 640 > 512): loss, ce, aux, grad norm
    and lr of each step on every rank within rtol 2e-5 of the reference
    trainer on one device (``test_torch_ep_train``'s tolerance), and
    every leaf of params, moments and counters within 2e-5 of its max."""
    hist, flat = reference[arch]
    four, _ = ranks
    layers = _f32(arch).num_layers
    for r in four:
        got = r[key]["history"]
        assert len(got) == STEPS
        for s, (t, j) in enumerate(zip(got, hist, strict=True)):
            for k in ("loss", "ce", "aux", "grad_norm", "lr"):
                np.testing.assert_allclose(t[k], j[k], rtol=2e-5, atol=1e-9,
                                           err_msg=f"{key} step {s} {k}")
            assert t["skipped"] == 0
        assert r[key]["gathers"] == layers * (2 if kw.get("fsdp") else 1)
    whole = four[0][key]["whole"]
    assert set(whole) == set(flat)
    _close(whole, flat, key)


# what each recurrent preset's gradients are held to: rwkv6's against the
# reference's float64 replay — its own f32 gradient of u lies 2.7e-5 of
# the max from that replay at this one-row batch (many products of
# opposite signs summed over the chunks), the split row's 2.7e-6;
# zamba2's against the reference's f32 gradients (its float64 replay
# does not trace: the Mamba-2 scan's carry stays f32)
F64_REPLAY = {"rwkv6-1.6b": True, "zamba2-7b": False}


def _ref_grads(arch, f64):
    jc = _f32(arch).replace(dtype="float64" if f64 else "float32")
    jb = JSyntheticLM(jc, 1, R_S).next_batch(0)
    dt = jnp.float64 if f64 else jnp.float32

    def jloss(p, b):
        h, aux, _ = JT.forward(p, b["inputs"], jc)
        return jts.chunked_ce_loss(p, jc, h, b["targets"], b["loss_mask"],
                                   None) + aux
    with jax.enable_x64(f64):
        jv, jg = jax.jit(jax.value_and_grad(jloss))(
            jax.tree.map(lambda a: jnp.asarray(a, dt), jax_params(arch)), jb)
        return float(jv), [(jax.tree_util.keystr(path), np.asarray(g))
                           for path, g in jax.tree_util.tree_flatten_with_path(
                               jg)[0]]


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_blocks_with_a_split_row_match_one_device(ranks, arch):
    """One f32 batch of one row of 32 at 1x2 (16 positions a rank; every
    recurrent block gathers its whole row, runs it and keeps its chunk,
    zamba2's shared attention over the whole row inside it), from
    ``test_torch_recurrent``'s parameters (the zero- and one-initialised
    leaves drawn away from their init): the loss within rtol 2e-5 of
    the reference's on one device, and every gradient leaf (summed over
    the ranks) within 2e-5 of its max |grad| (the tolerance
    ``test_torch_recurrent`` holds a train step's gradients to) of
    ``jax.value_and_grad`` of the reference's forward + chunked CE —
    rwkv6's of its float64 replay (``F64_REPLAY``)."""
    _, two = ranks
    jv, _ = _ref_grads(arch, False)
    _, jg = _ref_grads(arch, F64_REPLAY[arch])
    for r in two:
        assert r[arch]["split"] == 2
        np.testing.assert_allclose(r[arch]["loss"], jv, rtol=2e-5)
    for (path, j), t in zip(jg, jax.tree.leaves(two[0][arch]["grads"]),
                            strict=True):
        err = np.abs(t - j).max() / max(np.abs(j).max(), 1e-30)
        assert err <= 2e-5, (path, err)
