"""The checkpoint of a train state sharded across ranks: gloo CPU ranks
(``launch.mesh.spawn``, rank bodies in ``tests/torch_ranks.py``) train the
paper preset's f32 smoke model at 2x2 under FSDP through
``launch.train.run`` with ``--ckpt-dir``.  The one file it writes carries
the reference's keys and format, and restores in the port at 1x1, at 1x4
without FSDP and in the JAX reference; a reference checkpoint restores at
2x2; a truncated latest falls back on every rank; a SIGKILL of rank 0 at
each ``ckpt.*`` seam leaves a restorable directory, from which a fresh
spawn with ``--resume`` ends bitwise equal to the uninterrupted run."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_ranks
from repro import configs as jconfigs
from repro.checkpoint import io as jio
from repro.core.config import TrainConfig as JTrainConfig
from repro.training import train_step as jts
from repro_torch import configs, convert, tree
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.core.config import TrainConfig
from repro_torch.launch import shard
from repro_torch.launch.mesh import spawn, tree_paths
from repro_torch.training.train_step import init_train_state

ARCH = "hetumoe-paper-16e"
SEAMS = ("data_tmp_written", "data_replaced", "manifest_step_written")
# what a kill at the step-2 save leaves: nothing to restore (the run
# starts over), or the step-2 checkpoint (its per-step manifest written)
RESUMED_FROM = {"data_tmp_written": 0, "data_replaced": 0,
                "manifest_step_written": 2}


def _jcfg():
    return jconfigs.smoke_config(ARCH).replace(dtype="float32")


def _cfg():
    cfg = configs.smoke_config(ARCH)
    return cfg.replace(dtype="float32", moe=dataclasses.replace(cfg.moe))


def _ref_state():
    """A reference TrainState with every leaf distinct: its initial
    parameters, seeded moments and counters."""
    st = jts.init_train_state(jax.random.PRNGKey(0), _jcfg(),
                              JTrainConfig())
    rng = np.random.default_rng(7)

    def mom(x):
        return jnp.asarray(rng.standard_normal(x.shape).astype(np.float32))
    return st._replace(
        opt={"m": jax.tree.map(mom, st.opt["m"]),
             "v": jax.tree.map(lambda x: jnp.abs(mom(x)), st.opt["v"]),
             "count": jnp.int32(5)},
        step=jnp.int32(5), skipped=jnp.int32(1),
        nonfinite_streak=jnp.int32(0), good_streak=jnp.int32(4),
        loss_scale=jnp.float32(1.0))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks draw their own weights (seed 0, each leaf whole then
    cut); a killed run's directory is listed before the resume."""
    root = tmp_path_factory.mktemp("ckpt_ranks")
    dirs = {k: str(root / k) for k in ("run", "truncated", "ref")}
    ref = _ref_state()
    jio.save_checkpoint(dirs["ref"], ref, 5)
    main = spawn(torch_ranks.ckpt_main_rank, 4, backend="gloo", threads=1,
                 args=(ARCH, None, dirs))
    kills, kill_dirs = {}, []
    for seam in SEAMS:
        d = root / f"kill_{seam}"
        kill_dirs.append(str(d))
        try:
            spawn(torch_ranks.ckpt_kill_rank, 4, backend="gloo", threads=1,
                  args=(ARCH, None, str(d), seam))
            kills[seam] = ("the ranks ended", None)
        except RuntimeError as e:
            kills[seam] = (str(e), sorted(p.name for p in d.iterdir()))
    resumed = spawn(torch_ranks.ckpt_resume_rank, 4, backend="gloo",
                    threads=1, args=(ARCH, None, kill_dirs))
    return dict(dirs=dirs, main=main, kills=kills,
                resumed=dict(zip(SEAMS, resumed[0])),
                ref={k: np.asarray(v) for k, v in jio._flatten(ref).items()})


def _equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), w, err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(w).dtype, k


def test_fsdp_checkpoint_is_the_reference_format(runs):
    """The 2x2 FSDP run saved at steps 2 and 4 (every 2, the last at the
    end) into one npz each, with exactly ``convert.state_keys``' keys,
    shapes and dtypes, CRC32 manifests, and the step-4 file holding the
    ranks' state gathered whole, bit for bit."""
    from repro_torch.checkpoint import io
    whole = runs["main"][0]["whole"]
    assert runs["main"][0]["saves"] == 2
    cands = io.list_checkpoints(runs["dirs"]["run"])
    assert [s for s, _ in cands] == [4, 2]
    arrays = io._load_verified(runs["dirs"]["run"], cands[0][1])
    want = convert.state_keys(_cfg())
    assert set(arrays) == set(want)
    for k, (shape, dt) in want.items():
        assert arrays[k].shape == shape and arrays[k].dtype == dt, k
    _equal(arrays, whole)


def test_fsdp_checkpoint_restores_at_1x1_in_the_port(runs):
    """One process restores the 2x2 FSDP checkpoint whole, bitwise the
    ranks' gathered state."""
    cfg = _cfg()
    tpl = init_train_state(cfg, TrainConfig(), device="cpu")
    state, step = restore_checkpoint(runs["dirs"]["run"], tpl, cfg=cfg)
    assert step == 4
    _equal(convert.state_to_numpy(state, cfg), runs["main"][0]["whole"])


def test_fsdp_checkpoint_restores_at_1x4_without_fsdp(runs):
    """Four ranks at 1x4 without FSDP restore it: each holds its E/4
    experts and every other leaf whole, and gathered their state is the
    2x2 run's, bitwise."""
    step, whole, shapes = runs["main"][0]["1x4"]
    assert step == 4
    _equal(whole, runs["main"][0]["whole"])
    cfg = _cfg()
    E = cfg.moe.num_experts
    full = [tuple(t.shape) for t in tree.leaves(convert.param_shapes(cfg))]
    expert = [shard.is_expert(p) for p, _ in
              tree_paths(convert.param_shapes(cfg))]
    for r in runs["main"]:
        assert r["1x4"][2] == shapes
    assert shapes == [(E // 4,) + f[1:] if x else f
                      for f, x in zip(full, expert, strict=True)]


def test_fsdp_checkpoint_restores_in_the_reference(runs):
    """The reference's own ``restore_checkpoint`` with its TrainState
    template restores the port's 2x2 FSDP checkpoint: every leaf, by the
    reference's key, bitwise the port's state."""
    tpl = jts.init_train_state(jax.random.PRNGKey(1), _jcfg(), JTrainConfig())
    state, step = jio.restore_checkpoint(runs["dirs"]["run"], tpl)
    assert step == 4
    _equal({k: np.asarray(v) for k, v in jio._flatten(state).items()},
           runs["main"][0]["whole"])


def test_reference_checkpoint_restores_at_2x2_fsdp(runs):
    """A checkpoint the reference wrote restores at 2x2 under FSDP on
    every rank, each rank its blocks: gathered whole, bitwise the
    reference's state."""
    for r in runs["main"]:
        assert r["ref"][0] == 5
    _equal(runs["main"][0]["ref"][1], runs["ref"])


def test_truncated_latest_falls_back_on_every_rank(runs):
    """With the step-4 npz truncated every rank restores step 2, and
    gathered its state is that checkpoint's, bitwise."""
    from repro_torch.checkpoint import io
    for r in runs["main"]:
        assert r["fallback"][0] == 2
    cands = io.list_checkpoints(runs["dirs"]["truncated"])
    two = dict(cands)[2]
    _equal(runs["main"][0]["fallback"][1],
           io._load_verified(runs["dirs"]["truncated"], two))


# the files a kill at each seam of the step-2 save leaves
LEFT = {"data_tmp_written": ["ckpt_00000002.npz.tmp"],
        "data_replaced": ["ckpt_00000002.npz"],
        "manifest_step_written": ["ckpt_00000002.json",
                                  "ckpt_00000002.npz"]}


@pytest.mark.parametrize("seam", SEAMS)
def test_sigkill_of_rank0_at_a_seam_leaves_a_restorable_dir(runs, seam):
    """``--inject ckpt.<seam>:kill@2`` kills rank 0 at that seam of the
    step-2 save: the spawn fails (rank 0 killed without a word, or the
    others' collectives failing with it), leaving exactly the seam's
    files; the directory restores (the step-2 checkpoint once its
    per-step manifest is written, else nothing and the run starts over),
    and a fresh spawn with ``--resume`` ends bitwise equal to the
    uninterrupted run."""
    err, left = runs["kills"][seam]
    assert "--- rank 0 ---" not in err and (
        "exited with codes [-9]" in err or "ranks failed" in err), err
    assert left == LEFT[seam]
    res = runs["resumed"][seam]
    want = RESUMED_FROM[seam]
    assert res["latest"] == (want or None)
    assert res["start"] == want
    _equal(res["whole"], runs["main"][0]["whole"])
