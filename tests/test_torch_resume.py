"""Kill-and-resume in the port (its side of tests/test_resume.py): a run
restored from the newest intact checkpoint reproduces the uninterrupted
trajectory BITWISE (data and gate noise are keyed by the global step, the
lr schedule by ``state.step``); and a ``TrainState`` checkpoint crosses
between the JAX trainer and the port in both directions.  The fast path
crashes in-process through the fault harness; the slow-marked test
SIGKILLs a real subprocess mid-save."""
import dataclasses
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import io as jio
from repro.core import config as jconfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.training import train_step as jts
from repro_torch import configs, tree
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.convert import state_to_numpy
from repro_torch.core import faults as F
from repro_torch.core.config import TrainConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as tlaunch
from repro_torch.training import train_step as ts

ARCH = "hetumoe-paper-16e"
KW = dict(batch=2, seq=16, smoke=True, log_every=100, device="cpu")
METRIC_KEYS = ("loss", "ce", "aux", "grad_norm", "lr")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: at the smoke widths a
    torch op is too small to share out, and the parallel test workers
    would otherwise contend for the cores with 8 threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_bitwise_equal_tail(ref_hist, res_hist, start):
    """res_hist (resumed, steps start..end) must equal ref_hist[start:]
    exactly — float equality, no tolerance."""
    assert [h["step"] for h in res_hist] == [h["step"]
                                             for h in ref_hist[start:]]
    for ref, res in zip(ref_hist[start:], res_hist):
        for k in METRIC_KEYS:
            assert ref[k] == res[k], (
                f"step {ref['step']} {k}: {ref[k]!r} != {res[k]!r} — resume "
                f"is not bitwise-reproducing the uninterrupted run")


def _bits_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(
        tree.leaves((a.params, a.opt, a.step, a.skipped, a.loss_scale)),
        tree.leaves((b.params, b.opt, b.step, b.skipped, b.loss_scale)),
        strict=True))


@pytest.mark.parametrize("moe", [None, dict(gate="gshard")])
def test_crash_and_resume_bitwise(tmp_path, moe):
    """Crash (simulated preemption) at the top of step 5 with saves every
    3 steps; the resume restores step 3 and replays 3..7: every metric and
    the final state bitwise the uninterrupted run's (with a noisy gate
    too, whose draws are keyed by the step)."""
    ckpt = str(tmp_path / "ckpt")
    ref_state, ref = tlaunch.run(ARCH, steps=8, moe=moe, **KW)
    plan = F.FaultPlan(sites={"train.loop": F.FaultSpec(steps=(5,),
                                                        mode="raise")})
    with pytest.raises(F.FaultInjected):
        tlaunch.run(ARCH, steps=8, ckpt_dir=ckpt, ckpt_every=3, faults=plan,
                    moe=moe, **KW)
    stats = {}
    state, resumed = tlaunch.run(ARCH, steps=8, ckpt_dir=ckpt, resume=True,
                                 moe=moe, stats=stats, **KW)
    assert resumed[0]["step"] == 3 and stats["restore_s"] > 0
    _assert_bitwise_equal_tail(ref, resumed, start=3)
    assert _bits_equal(ref_state, state)
    assert len(stats["save_s"]) == 1           # the final save at step 8


def test_resume_without_checkpoint_starts_fresh(tmp_path, capsys):
    ckpt = str(tmp_path / "empty")
    _, hist = tlaunch.run(ARCH, steps=2, ckpt_dir=ckpt, resume=True, **KW)
    assert [h["step"] for h in hist] == [0, 1]
    assert "starting fresh" in capsys.readouterr().out


def test_ckpt_flags_require_ckpt_dir():
    with pytest.raises(ValueError, match="ckpt-dir"):
        tlaunch.run(ARCH, steps=2, ckpt_every=1, **KW)
    with pytest.raises(ValueError, match="ckpt-dir"):
        tlaunch.run(ARCH, steps=2, resume=True, **KW)


def test_training_loop_fails_fast_on_persistent_nonfinite():
    """Every step non-finite → every step skipped → the loop aborts after
    max_skipped_steps consecutive skips instead of spinning."""
    plan = F.FaultPlan(sites={"train.grads": F.FaultSpec(mode="nan",
                                                         always=True)})
    with pytest.raises(RuntimeError, match="consecutive non-finite"):
        tlaunch.run(ARCH, steps=30, faults=plan, **KW)


def test_cli_keeps_the_newest_checkpoints_and_resumes(tmp_path, capsys):
    """--ckpt-every/--ckpt-keep/--resume/--inject through main():
    retention keeps the newest --ckpt-keep; the injected NaN step is
    skipped; --history-out records start and resumed."""
    ckpt, out = str(tmp_path / "ck"), str(tmp_path / "h.json")
    base = ["--arch", ARCH, "--smoke", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--ckpt-dir", ckpt]
    tlaunch.main(base + ["--steps", "4", "--ckpt-every", "1",
                         "--ckpt-keep", "2"])
    assert sorted(f for f in os.listdir(ckpt) if f.endswith(".npz")) == [
        "ckpt_00000003.npz", "ckpt_00000004.npz"]
    tlaunch.main(base + ["--steps", "6", "--resume", "--history-out", out,
                         "--inject", "train.grads:nan@4"])
    hist = json.loads(open(out).read())
    assert hist["start"] == 4 and hist["resumed"]
    assert [(h["step"], h["skipped"]) for h in hist["history"]] == [
        (4, 1.0), (5, 1.0)]
    assert "resumed from step 4" in capsys.readouterr().out


# -- real SIGKILL mid-save, via the CLI -------------------------------------

def _train_cli(tmp_path, *extra):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
           "--smoke", "--steps", "8", "--batch", "2", "--seq", "16",
           "--log-every", "100", "--device", "cpu", *extra]
    return subprocess.run(cmd, cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=600)


@pytest.mark.slow
def test_sigkill_during_save_then_resume_bitwise(tmp_path):
    """End-to-end through the CLI: SIGKILL the process between the
    checkpoint tmp-file fsync and its os.replace, then --resume and diff
    --history-out JSON against an uninterrupted run — bitwise."""
    ckpt = str(tmp_path / "ckpt")
    ref = _train_cli(tmp_path, "--history-out", "ref.json")
    assert ref.returncode == 0, ref.stderr
    crashed = _train_cli(tmp_path, "--ckpt-dir", ckpt, "--ckpt-every", "3",
                         "--inject", "ckpt.data_tmp_written:kill@6")
    assert crashed.returncode == -signal.SIGKILL
    resumed = _train_cli(tmp_path, "--ckpt-dir", ckpt, "--resume",
                         "--history-out", "res.json")
    assert resumed.returncode == 0, resumed.stderr
    assert "resumed from step 3" in resumed.stdout
    with open(tmp_path / "ref.json") as f:
        ref_hist = json.load(f)["history"]
    with open(tmp_path / "res.json") as f:
        res = json.load(f)
    assert res["resumed"] and res["start"] == 3
    _assert_bitwise_equal_tail(ref_hist, res["history"], start=3)


# -- checkpoints across the two packages ------------------------------------

def _jcfg():
    jc = jconfigs.smoke_config(ARCH).replace(dtype="float32")
    return jc.replace(moe=dataclasses.replace(jc.moe, use_pallas_gate=True,
                                              dispatch="grouped"))


def _tcfg():
    tc = configs.smoke_config(ARCH).replace(dtype="float32")
    return tc.replace(moe=dataclasses.replace(tc.moe, dispatch="grouped"))


KWT = dict(learning_rate=3e-3, warmup_steps=1, total_steps=4)


@pytest.fixture(scope="module")
def jax_run(mesh1):
    """The reference trainer after one step (moments and counters
    non-trivial), its jitted step and its batches."""
    jc, jtc = _jcfg(), jconfig.TrainConfig(**KWT)
    rng = jax.random.PRNGKey(3)
    step = jax.jit(jts.make_train_step(jc, jtc, mesh1))
    ds = JSyntheticLM(jc, 2, 32)
    state = jts.init_train_state(rng, jc, jtc)
    state, _ = step(state, ds.next_batch(0), rng)
    return state, step, ds, rng


def test_jax_checkpoint_resumes_in_the_port(tmp_path, jax_run):
    """A checkpoint saved by the JAX trainer, restored by the port: every
    leaf bitwise the reference's, and the port's next step matches the
    reference's next step within rtol 2e-6 (f32 sums in other orders, the
    port's train-step budget), with equal counters."""
    jstate, jstep, jds, rng = jax_run
    d = str(tmp_path)
    jio.save_checkpoint(d, jstate, 1)
    tc, ttc = _tcfg(), TrainConfig(**KWT)
    tmpl = ts.init_train_state(tc, ttc, device="cpu")
    state, step = restore_checkpoint(d, tmpl, cfg=tc)
    assert step == 1
    flat = state_to_numpy(state, tc)
    want = {k: np.asarray(v) for k, v in jio._flatten(jstate).items()}
    assert list(flat) == list(want)
    for k in want:
        assert flat[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)
    assert all(p.requires_grad for p in tree.leaves(state.params))
    jstate, jm = jstep(jstate, jds.next_batch(1), rng)
    state, tm = ts.make_train_step(tc, ttc)(
        state, SyntheticLM(tc, 2, 32, device="cpu").next_batch(1), step=1)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-6,
                                   atol=1e-9, err_msg=k)
    assert int(state.step) == int(jstate.step) == 2
    assert int(state.opt["count"]) == int(jstate.opt["count"]) == 2


def test_port_checkpoint_restores_in_the_reference(tmp_path, jax_run):
    """A port TrainState saved by the port, restored by
    ``repro.checkpoint.restore_checkpoint`` into a reference TrainState:
    every array equal, under the same keys."""
    tc, ttc = _tcfg(), TrainConfig(**KWT)
    state = ts.init_train_state(tc, ttc, device="cpu")
    state, _ = ts.make_train_step(tc, ttc)(
        state, SyntheticLM(tc, 2, 32, device="cpu").next_batch(0), step=0)
    d = str(tmp_path)
    save_checkpoint(d, state, 1, cfg=tc)
    jtmpl = jax_run[0]
    back, step = jio.restore_checkpoint(d, jtmpl)
    assert step == 1
    got = {k: np.asarray(v) for k, v in jio._flatten(back).items()}
    want = state_to_numpy(state, tc)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_train_state_round_trip_is_bitwise(tmp_path):
    """save_checkpoint/restore_checkpoint of a port TrainState: every
    leaf, dtype and counter bitwise; a TrainState without its cfg is
    refused."""
    tc, ttc = _tcfg(), TrainConfig(**KWT, loss_scale="dynamic")
    state = ts.init_train_state(tc, ttc, device="cpu")
    state, _ = ts.make_train_step(tc, ttc)(
        state, SyntheticLM(tc, 2, 16, device="cpu").next_batch(0), step=0)
    d = str(tmp_path)
    save_checkpoint(d, state, 1, cfg=tc)
    tmpl = ts.init_train_state(tc, ttc, device="cpu")
    back, _ = restore_checkpoint(d, tmpl, cfg=tc)
    assert _bits_equal(state, back)
    assert float(back.loss_scale) == 2.0 ** 15
    with pytest.raises(ValueError, match="cfg"):
        save_checkpoint(d, state, 2)
    with pytest.raises(ValueError, match="cfg"):
        restore_checkpoint(d, tmpl)
    bf16 = ts.init_train_state(
        tc, TrainConfig(**KWT, optimizer_state_dtype="bfloat16"),
        device="cpu")
    with pytest.raises(ValueError, match="f32 moments"):
        save_checkpoint(d, bf16, 3, cfg=tc)
