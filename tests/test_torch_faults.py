"""The port's fault harness and every training and checkpoint guard it
proves (the port's side of tests/test_faults.py; the serving seams wait
for the port's SlotServer): plan parsing and host seams, injection bytes
equal to the reference's, NaN/Inf at each traced seam skipped bitwise,
the dynamic loss scale under faults, and crash-safe checkpoints — crash
points, fallback from a corrupt latest, checksums, key mismatches,
retention, the legacy manifest and the file format shared with the
reference."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.core import faults as JF
from repro_torch import configs, tree
from repro_torch.checkpoint import (CheckpointCorruptError, latest_step,
                                    list_checkpoints, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.core import faults as F
from repro_torch.core.config import TrainConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.training.train_step import (init_train_state,
                                             make_train_step)

ARCH = "hetumoe-paper-16e"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: at the smoke widths a
    torch op is too small to share out, and the parallel test workers
    would otherwise contend for the cores with 8 threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the harness itself
# ---------------------------------------------------------------------------

def test_fault_plan_addressing_and_log():
    plan = F.FaultPlan(sites={"a.b": F.FaultSpec(steps=(2, 5), mode="nan")})
    assert plan.fires("a.b", 1) is None
    assert plan.fires("a.b", 2) is not None
    assert plan.fires("nope", 2) is None
    assert plan.fired == [("a.b", 2)]
    always = F.FaultPlan(sites={"x": F.FaultSpec(mode="inf", always=True)})
    assert always.fires("x", 123) is not None


def test_plan_from_specs_cli_parsing():
    plan = F.plan_from_specs(["train.grads:nan@3,7", "serve.step:stall@*"])
    assert plan.sites["train.grads"].steps == (3, 7)
    assert plan.sites["serve.step"].always
    ref = JF.plan_from_specs(["train.grads:nan@3,7", "serve.step:stall@*"])
    assert {k: vars(v) for k, v in plan.sites.items()} == {
        k: vars(v) for k, v in ref.sites.items()}
    with pytest.raises(ValueError, match="site:mode@steps"):
        F.plan_from_specs(["garbage"])
    with pytest.raises(ValueError, match="mode"):
        F.plan_from_specs(["a:frobnicate@1"])


def test_host_seams_noop_without_plan_and_fire_with_one():
    F.crash_point("any.site", 0)              # no ambient plan → no-op
    F.maybe_stall("any.site", 0)
    x = np.ones(4)
    np.testing.assert_array_equal(F.inject_array("any.site", x, 0), x)
    plan = F.plan_from_specs(["a:raise@1", "b:stall@*"])
    with F.active(plan):
        F.crash_point("a", 0)
        with pytest.raises(F.FaultInjected, match=r"a\[1\]"):
            F.crash_point("a", 1)
        F.maybe_stall("b", 9)
    assert F.get_active() is None
    assert plan.fired == [("a", 1), ("b", 9)]


@pytest.mark.parametrize("mode", ["nan", "inf"])
def test_inject_array_equals_the_references(mode):
    """The same seeded element poisoned as by the reference (same
    process, so the same site hash), repeatably."""
    sites = {"s": (1,)}
    plan = F.FaultPlan(sites={"s": F.FaultSpec(steps=sites["s"], mode=mode)},
                       seed=3)
    jplan = JF.FaultPlan(sites={"s": JF.FaultSpec(steps=sites["s"],
                                                  mode=mode)}, seed=3)
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    with F.active(plan):
        a = F.inject_array("s", x, 1)
        b = F.inject_array("s", x, 1)
        np.testing.assert_array_equal(F.inject_array("s", x, 2), x)
    with JF.active(jplan):
        j = JF.inject_array("s", x, 1)
    assert (~np.isfinite(a)).sum() == 1
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, j)


@pytest.mark.parametrize("mode,seed", [("truncate", 0), ("bitflip", 1),
                                       ("bitflip", 7)])
def test_corrupt_file_gives_the_references_bytes(tmp_path, mode, seed):
    data = bytes(range(256)) * 3
    p, q = tmp_path / "port.bin", tmp_path / "ref.bin"
    p.write_bytes(data)
    q.write_bytes(data)
    F.corrupt_file(str(p), mode=mode, seed=seed)
    JF.corrupt_file(str(q), mode=mode, seed=seed)
    assert p.read_bytes() == q.read_bytes() != data
    with pytest.raises(ValueError, match="bitflip"):
        F.corrupt_file(str(p), mode="nope")


def test_traced_factor_fires_only_at_its_steps():
    """nan/inf at the spec'd steps and 1.0 elsewhere; None (no op to add)
    without a plan, for a missing site, for a host-only mode and for an
    empty step list."""
    plan = F.plan_from_specs(["train.loss:inf@2,4", "train.grads:nan@*",
                              "train.loop:raise@1"])
    got = [F.traced_factor(plan, "train.loss",
                           torch.tensor(s, dtype=torch.int32)).item()
           for s in range(6)]
    assert got == [1.0, 1.0, float("inf"), 1.0, float("inf"), 1.0]
    assert np.isnan(F.traced_factor(plan, "train.grads",
                                    torch.tensor(0)).item())
    step = torch.tensor(2)
    assert F.traced_factor(None, "train.loss", step) is None
    assert F.traced_factor(plan, "train.activations", step) is None
    assert F.traced_factor(plan, "train.loop", step) is None
    assert F.traced_factor(F.FaultPlan({"x": F.FaultSpec(steps=())}), "x",
                           step) is None
    t = {"a": torch.ones(3), "b": [torch.ones(2, dtype=torch.bfloat16)]}
    assert F.apply_traced(None, "x", step, t) is t
    out = F.apply_traced(plan, "train.loss", step, t)
    assert torch.isinf(out["a"]).all() and out["b"][0].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# training: skip-step guard + loss scaling under injected faults
# ---------------------------------------------------------------------------

def _tiny_train(tcfg, faults=None, steps=3):
    cfg = configs.smoke_config(ARCH).replace(dtype="float32")
    state = init_train_state(cfg, tcfg, device="cpu")
    ds = SyntheticLM(cfg, 2, 16, device="cpu")
    step = make_train_step(cfg, tcfg, faults=faults)
    states, metrics = [state], []
    for s in range(steps):
        state, m = step(state, ds.next_batch(s), step=s)
        states.append(state)
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics


def _bits(state):
    return [t.detach().clone() for t in tree.leaves((state.params,
                                                     state.opt))]


@pytest.mark.parametrize("mode", ["nan", "inf"])
@pytest.mark.parametrize("site", ["train.grads", "train.loss",
                                  "train.activations"])
def test_nonfinite_step_skipped_bitwise(site, mode):
    """An injected NaN/Inf at any traced seam skips the update: params AND
    opt state (moments + Adam count) keep their exact bits, the counters
    advance, and the next step updates again."""
    plan = F.FaultPlan(sites={site: F.FaultSpec(steps=(1,), mode=mode)})
    states, metrics = _tiny_train(TrainConfig(total_steps=3, warmup_steps=1),
                                  faults=plan, steps=3)
    before, after = states[1], states[2]          # step 1 is the bad step
    for a, b in zip(_bits(before), _bits(after), strict=True):
        assert torch.equal(a, b)
    assert metrics[1]["skipped"] == 1 and metrics[1]["nonfinite_streak"] == 1
    assert int(after.step) == 2 and int(after.opt["count"]) == 1
    assert metrics[2]["nonfinite_streak"] == 0
    assert any(not torch.equal(a, b) for a, b in zip(_bits(states[2]),
                                                      _bits(states[3])))


def test_unfaulted_steps_are_bitwise_those_without_a_plan():
    """A plan whose site is elsewhere (or fires at another step) leaves
    every step bitwise what it is without a plan."""
    tcfg = TrainConfig(total_steps=3, warmup_steps=1)
    ref, _ = _tiny_train(tcfg, steps=2)
    plan = F.plan_from_specs(["train.grads:nan@5", "train.loop:raise@9"])
    got, m = _tiny_train(tcfg, faults=plan, steps=2)
    assert all(torch.equal(a, b) for a, b in zip(_bits(ref[-1]),
                                                 _bits(got[-1])))
    assert all(x["skipped"] == 0 for x in m)


def test_streak_counts_consecutive():
    plan = F.FaultPlan(sites={"train.grads":
                              F.FaultSpec(steps=(1, 2), mode="inf")})
    _, metrics = _tiny_train(TrainConfig(total_steps=4, warmup_steps=1),
                             faults=plan, steps=4)
    assert [m["nonfinite_streak"] for m in metrics] == [0, 1, 2, 0]
    assert [m["skipped"] for m in metrics] == [0, 1, 2, 2]


def test_dynamic_loss_scale_halves_and_regrows_under_faults():
    tcfg = TrainConfig(total_steps=6, warmup_steps=1, loss_scale="dynamic",
                       loss_scale_growth_interval=2)
    plan = F.FaultPlan(sites={"train.loss": F.FaultSpec(steps=(1,),
                                                        mode="inf")})
    _, metrics = _tiny_train(tcfg, faults=plan, steps=4)
    s0 = 2.0 ** 15
    assert [m["loss_scale"] for m in metrics] == [s0, s0 / 2, s0 / 2, s0]
    assert metrics[1]["skipped"] == 1
    assert np.isfinite(metrics[-1]["loss"])


# ---------------------------------------------------------------------------
# checkpointing: atomicity, checksums, fallback, retention, format
# ---------------------------------------------------------------------------

def _toy_state(val=1.0):
    return {"w": torch.full((4, 3), val),
            "opt": {"m": torch.full((4, 3), val * 0.1),
                    "count": torch.tensor(int(val), dtype=torch.int32)}}


@pytest.mark.parametrize("site,expect_step", [
    ("ckpt.data_tmp_written", 1),       # killed before os.replace
    ("ckpt.data_replaced", 1),          # .npz in place, no manifest yet
    ("ckpt.manifest_step_written", 2),  # per-step manifest already durable
])
def test_crash_during_save_leaves_restorable_dir(tmp_path, site, expect_step):
    d = str(tmp_path)
    save_checkpoint(d, _toy_state(1.0), 1)
    plan = F.FaultPlan(sites={site: F.FaultSpec(steps=(2,), mode="raise")})
    with F.active(plan):
        with pytest.raises(F.FaultInjected):
            save_checkpoint(d, _toy_state(2.0), 2)
    state, step = restore_checkpoint(d, _toy_state(0.0))
    assert step == expect_step
    assert torch.equal(state["w"], torch.full((4, 3), float(expect_step)))
    assert state["opt"]["count"].dtype == torch.int32
    save_checkpoint(d, _toy_state(3.0), 3)
    _, step = restore_checkpoint(d, _toy_state(0.0))
    assert step == 3


@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_corrupt_latest_falls_back_to_previous(tmp_path, mode):
    d = str(tmp_path)
    for s in (1, 2, 3):
        save_checkpoint(d, _toy_state(float(s)), s)
    F.corrupt_file(os.path.join(d, "ckpt_00000003.npz"), mode=mode, seed=7)
    state, step = restore_checkpoint(d, _toy_state(0.0))
    assert step == 2
    assert torch.equal(state["w"], torch.full((4, 3), 2.0))
    with pytest.raises(CheckpointCorruptError):
        restore_checkpoint(d, _toy_state(0.0), fallback=False)


def test_checksum_mismatch_is_corruption(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, _toy_state(1.0), 1)
    mp = os.path.join(d, "ckpt_00000001.json")
    with open(mp) as f:
        manifest = json.load(f)
    manifest["checksums"]["w"] ^= 0xFF
    with open(mp, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(CheckpointCorruptError, match="checksum"):
        restore_checkpoint(d, _toy_state(0.0), fallback=False)


def test_restore_names_missing_and_unexpected_keys(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, _toy_state(1.0), 1)
    bad_tpl = {"w": torch.zeros(4, 3), "extra": torch.zeros(2)}
    with pytest.raises(ValueError) as ei:
        restore_checkpoint(d, bad_tpl)
    msg = str(ei.value)
    assert "missing" in msg and "extra" in msg
    assert "unexpected" in msg and "opt/m" in msg


def test_all_candidates_corrupt_raises_typed_error(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, _toy_state(1.0), 1)
    F.corrupt_file(os.path.join(d, "ckpt_00000001.npz"), mode="truncate")
    with pytest.raises(CheckpointCorruptError, match="no intact checkpoint"):
        restore_checkpoint(d, _toy_state(0.0))
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"), _toy_state(0.0))


def test_retention_keeps_last_k_and_cleans_tmp(tmp_path):
    d = str(tmp_path)
    open(os.path.join(d, "ckpt_99999999.npz.tmp"), "w").write("torn")
    for s in range(1, 6):
        save_checkpoint(d, _toy_state(float(s)), s, keep=2)
    assert [s for s, _ in list_checkpoints(d)] == [5, 4]
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    assert latest_step(d) == 5
    assert latest_step(str(tmp_path / "nope")) is None


def test_legacy_manifest_only_dir_still_restores(tmp_path):
    d = str(tmp_path)
    path = os.path.join(d, "ckpt_00000007.npz")
    np.savez(path, w=np.ones((2, 2), np.float32))
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump({"latest": path, "step": 7, "keys": ["w"]}, f)
    state, step = restore_checkpoint(d, {"w": torch.zeros(2, 2)})
    assert step == 7 and torch.equal(state["w"], torch.ones(2, 2))


@pytest.mark.parametrize("kind", ["stored", "compressed"])
def test_mapped_restore_reads_what_np_load_reads(tmp_path, kind):
    """A stored npz is mapped on restore (``io._map_npz``): every array
    the dtype, shape and bits ``np.load`` gives (C and Fortran order,
    0-d, empty, bool); a compressed one is left to ``np.load``.  Either
    restores through a manifest with checksums."""
    from repro_torch.checkpoint import io as cio
    rng = np.random.default_rng(3)
    arrays = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "f": np.asfortranarray(rng.standard_normal((2, 5))),
              "s": np.array(3, np.int32),
              "e": np.zeros((0, 5), np.float16),
              "opt/b": np.array([True, False, True])}
    d = tmp_path / "ck"
    d.mkdir()
    path = d / "ckpt_00000005.npz"
    (np.savez if kind == "stored" else np.savez_compressed)(path, **arrays)
    mapped = cio._map_npz(str(path))
    if kind == "compressed":
        assert mapped is None
    else:
        with np.load(path) as z:
            assert sorted(mapped) == sorted(z.files)
            for k in z.files:
                assert mapped[k].dtype == z[k].dtype, k
                assert mapped[k].shape == z[k].shape, k
                assert np.array_equal(mapped[k], z[k]), k
    with open(d / "ckpt_00000005.json", "w") as f:
        json.dump({"latest": path.name, "step": 5, "keys": sorted(arrays),
                   "checksums": {k: cio._checksum(a)
                                 for k, a in arrays.items()}}, f)
    tpl = {"w": torch.zeros(4, 3), "f": torch.zeros(2, 5, dtype=torch.float64),
           "s": torch.zeros((), dtype=torch.int32),
           "e": torch.zeros(0, 5, dtype=torch.float16),
           "opt": {"b": torch.zeros(3, dtype=torch.bool)}}
    state, step = restore_checkpoint(str(d), tpl, fallback=False)
    assert step == 5
    for k, t in (("w", state["w"]), ("f", state["f"]), ("s", state["s"]),
                 ("e", state["e"]), ("opt/b", state["opt"]["b"])):
        assert np.array_equal(t.numpy(), arrays[k]), k


def test_format_is_the_references_in_both_directions(tmp_path):
    """The same toy state saved by the port and by the reference: equal
    manifests (keys, checksums, format) and equal arrays; each package
    restores the other's directory."""
    pd, jd = str(tmp_path / "port"), str(tmp_path / "ref")
    save_checkpoint(pd, _toy_state(2.0), 4)
    jstate = {"w": jnp.full((4, 3), 2.0, jnp.float32),
              "opt": {"m": jnp.full((4, 3), 0.2, jnp.float32),
                      "count": jnp.asarray(2, jnp.int32)}}
    jio.save_checkpoint(jd, jstate, 4)
    for name in ("ckpt_00000004.json", "manifest.json"):
        with open(os.path.join(pd, name)) as f, \
                open(os.path.join(jd, name)) as g:
            assert json.load(f) == json.load(g), name
    with np.load(os.path.join(pd, "ckpt_00000004.npz")) as a, \
            np.load(os.path.join(jd, "ckpt_00000004.npz")) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    got, step = restore_checkpoint(jd, _toy_state(0.0))
    assert step == 4 and torch.equal(got["opt"]["m"], _toy_state(2.0)["opt"]
                                     ["m"])
    back, step = jio.restore_checkpoint(pd, jstate)
    assert step == 4
    np.testing.assert_array_equal(np.asarray(back["w"]),
                                  np.full((4, 3), 2.0))
