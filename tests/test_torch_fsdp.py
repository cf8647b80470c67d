"""The sharded train state: the port's parameter sharding rules
(``launch/mesh.py``) against the reference's, word for word, on every
preset's smoke tree and the paper model's published shapes at five
meshes; each rank's stored block against the reference's
``NamedSharding`` for that device; and training under FSDP (ZeRO-3) on
gloo CPU ranks (``launch.mesh.spawn``, rank bodies in
``tests/torch_ranks.py``) at 2x2 and 4x1, sort and grouped, remat none
and block and two microbatches, against the reference's one-device
trainer and the port's ``fsdp=False`` run at the same mesh."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_ranks
from repro import configs as jconfigs
from repro.core.config import TrainConfig as JTrainConfig
from repro.launch import mesh as jmesh
from repro.launch import train as jtrain
from repro.models import transformer as JT
from repro.training import train_step as jts
from repro_torch import configs, convert
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import shard
from repro_torch.launch.mesh import spawn
from repro_torch.training.train_step import TrainState

MESHES = [(1, 1), (2, 2), (4, 1), (1, 4), (2, 4)]
ARCH = "hetumoe-paper-16e"
PRESETS = sorted(configs.ARCHS)
TREES = [(a, True) for a in PRESETS] + [(ARCH, False)]


def _shapes(arch, smoke):
    """The reference's parameter shapes and the port's (meta) tree."""
    jcfg = jconfigs.smoke_config(arch) if smoke else jconfigs.get_config(arch)
    cfg = configs.smoke_config(arch) if smoke else configs.get_config(arch)
    ref = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, ref, convert.param_shapes(cfg)


def _ref_specs(tree):
    """{path: spec tuple (one entry per dim)} of a tree of shardings."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    out = {}
    for path, sh in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = tuple(sh.spec)
    return out


def _padded(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


def _port_key(cfg, path):
    """The reference's key of a port leaf path (layer i → pattern slot
    i mod P, the scan dim dropped)."""
    parts = path.split("/")
    if parts[0] == "blocks":
        parts[1] = str(int(parts[1]) % len(cfg.block_pattern))
    return "/".join(parts)


def _check_params(cfg, ref_specs, ref_shapes, port_specs, port_shapes):
    ref_nd = {k: len(v.shape) for k, v in ref_shapes.items()}
    got = dict(pmesh.tree_paths(port_shapes))
    seen = set()
    for path, spec in _port_spec_items(port_specs, port_shapes):
        key = _port_key(cfg, path)
        nd = len(got[path].shape)
        want = _padded(ref_specs[key], ref_nd[key])
        lead = ref_nd[key] - nd
        assert want[:lead] == (None,) * lead, (key, want)
        assert spec == want[lead:], (path, spec, want)
        seen.add(key)
    assert seen == set(ref_specs)


def _port_spec_items(specs, shapes, prefix=""):
    """(path, spec) of a port spec tree, walked along the shapes tree (a
    spec is a tuple: a walk of its own would descend into it)."""
    if isinstance(shapes, dict):
        items = [(str(k), shapes[k], specs[k]) for k in shapes]
    elif isinstance(shapes, (list, tuple)):
        items = [(str(i), v, specs[i]) for i, v in enumerate(shapes)]
    else:
        return [(prefix, specs)]
    return [x for k, v, sp in items for x in _port_spec_items(
        sp, v, f"{prefix}/{k}" if prefix else k)]


def _ref_shape_map(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in flat}


@pytest.fixture(scope="module")
def trees():
    return {(a, s): _shapes(a, s) for a, s in TREES}


@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("arch,smoke", TREES,
                         ids=[a + ("-smoke" if s else "-full")
                              for a, s in TREES])
def test_param_shardings_equal_the_reference(trees, arch, smoke, shape):
    """``param_shardings`` with ``fsdp`` and ``expert_tp`` both ways gives
    every port leaf the reference's spec for its key, the scan dim
    dropped (divisibility decided on the same trailing dims)."""
    jcfg, cfg, ref, port = trees[arch, smoke]
    mesh = jmesh.make_smoke_mesh(shape)
    ms = {"data": shape[0], "model": shape[1]}
    rshapes = _ref_shape_map(ref)
    for fsdp in (True, False):
        for etp in (True, False):
            want = _ref_specs(jmesh.param_shardings(mesh, ref, fsdp=fsdp,
                                                    expert_tp=etp))
            got = pmesh.param_shardings(ms, port, fsdp=fsdp, expert_tp=etp)
            _check_params(cfg, want, rshapes, got, port)


@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("arch,smoke", TREES,
                         ids=[a + ("-smoke" if s else "-full")
                              for a, s in TREES])
def test_state_shardings_and_needs_fsdp_equal_the_reference(trees, arch,
                                                            smoke, shape):
    """``state_shardings`` (fsdp None, True, False) over a TrainState of
    shapes: params and both moments as the reference's, the count and
    every counter replicated; ``needs_fsdp`` the reference's answer at
    the default budget and at budgets around the state's size."""
    jcfg, cfg, ref, port = trees[arch, smoke]
    mesh = jmesh.make_smoke_mesh(shape)
    ms = {"data": shape[0], "model": shape[1]}
    jstate = jax.eval_shape(lambda: jts.init_train_state(
        jax.random.PRNGKey(0), jcfg, JTrainConfig()))
    scalar = torch.empty((), device="meta")
    pstate = TrainState(port, {"m": port, "v": port, "count": scalar},
                        scalar, skipped=scalar, nonfinite_streak=scalar,
                        good_streak=scalar, loss_scale=scalar)
    rshapes = _ref_shape_map(ref)
    for fsdp in (None, True, False):
        want = jmesh.state_shardings(mesh, jstate, fsdp=fsdp)
        got = pmesh.state_shardings(ms, pstate, fsdp=fsdp)
        for sec in ("m", "v"):
            _check_params(cfg, _ref_specs(want.opt[sec]), rshapes,
                          got.opt[sec], port)
        _check_params(cfg, _ref_specs(want.params), rshapes, got.params,
                      port)
        assert got.opt["count"] == tuple(want.opt["count"].spec) == ()
        for f in ("step", "skipped", "nonfinite_streak", "good_streak",
                  "loss_scale"):
            assert getattr(got, f) == tuple(getattr(want, f).spec) == ()
    total = sum(int(np.prod(v.shape)) for v in rshapes.values())
    for budget in (6e9, total * 12.0 / shape[1] * 0.99,
                   total * 12.0 / shape[1] * 1.01):
        assert pmesh.needs_fsdp(ms, port, budget_bytes=budget) == \
            jmesh.needs_fsdp(mesh, ref, budget_bytes=budget)


@pytest.mark.parametrize("shape", MESHES[1:],
                         ids=[f"{d}x{m}" for d, m in MESHES[1:]])
@pytest.mark.parametrize("arch,smoke", TREES,
                         ids=[a + ("-smoke" if s else "-full")
                              for a, s in TREES])
def test_stored_blocks_equal_the_reference_shards(trees, arch, smoke, shape):
    """Under FSDP each rank ``r = d·M + m`` stores of every leaf exactly
    the block the reference's ``NamedSharding`` (fsdp=True) gives device
    ``(d, m)``: the same shape (``shard_shape``) at the same place
    (``devices_indices_map``); without FSDP the experts' E over
    ``model`` and every other leaf whole."""
    jcfg, cfg, ref, port = trees[arch, smoke]
    mesh = jmesh.make_smoke_mesh(shape)
    ms = {"data": shape[0], "model": shape[1]}
    rsh = _ref_shape_map(ref)
    want = jax.tree_util.tree_flatten_with_path(
        jmesh.param_shardings(mesh, ref, fsdp=True),
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    want = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): sh for path, sh in want}
    devs = mesh.devices.reshape(-1)
    for r in range(shape[0] * shape[1]):
        fs = shard.make_layout(port, ms, r, fsdp=True)
        rep = shard.make_layout(port, ms, r, fsdp=False)
        for path, leaf in pmesh.tree_paths(port):
            key = _port_key(cfg, path)
            sh, full = want[key], rsh[key].shape
            lead = len(full) - len(leaf.shape)
            assert tuple(full[:lead]) + fs.block_shape(path, leaf.shape) \
                == tuple(sh.shard_shape(full)), (path, r)
            idx = sh.devices_indices_map(full)[devs[r]][lead:]
            got = fs.block(path, leaf.shape)
            assert [(s.start or 0, s.stop if s.stop is not None else n)
                    for s, n in zip(idx, leaf.shape)] == \
                [(s.start, s.stop) for s in got], (path, r)
            E = leaf.shape[0]
            expert = shard.is_expert(path) and shape[1] > 1
            assert rep.block_shape(path, leaf.shape) == (
                (E // shape[1],) + tuple(leaf.shape[1:]) if expert
                else tuple(leaf.shape)), (path, r)


def test_fit_spec_drops_nondivisible():
    """``fit_spec``'s three cases of the reference's test: vocab 92553 on
    a 4-wide model axis stays whole; a dim over (data, model) keeps both
    where 8 divides it and drops them where it does not."""
    ms = {"data": 2, "model": 4}
    assert pmesh.fit_spec(ms, ("data", "model"), (6, 92553)) == \
        ("data", None)
    assert pmesh.fit_spec(ms, (("data", "model"),), (8,)) == \
        (("data", "model"),)
    assert pmesh.fit_spec(ms, (("data", "model"),), (4,)) == (None,)


# ---------------------------------------------------------------------------
# training under FSDP on gloo CPU ranks
# ---------------------------------------------------------------------------

STEPS, BATCH, SEQ = 3, 8, 16
# sort at capacity E (no drops at any mesh: sort == the one device's)
SORT = dict(dispatch="sort", moe={"capacity_factor": 4.0})
GROUPED = dict(dispatch="grouped")
# the MoE knobs at their static defaults on both sides (the bound B = T·K)
RUN = dict(batch=BATCH, seq=SEQ, tune="off")
CELLS = {
    (2, 2): [("2x2-sort-none", dict(RUN, **SORT)),
             ("2x2-sort-block", dict(RUN, remat="block", **SORT)),
             ("2x2-grouped-none", dict(RUN, **GROUPED)),
             ("2x2-grouped-block", dict(RUN, remat="block", **GROUPED)),
             ("2x2-grouped-mb2", dict(RUN, microbatches=2, **GROUPED))],
    (4, 1): [("4x1-sort-none", dict(RUN, **SORT)),
             ("4x1-sort-block", dict(RUN, remat="block", **SORT)),
             ("4x1-grouped-none", dict(RUN, **GROUPED)),
             ("4x1-grouped-block", dict(RUN, remat="block", **GROUPED))],
}
KEYS = [k for cells in CELLS.values() for k, _ in cells]
# the fsdp=False run of a cell with remat block is its remat none twin's
# (remat changes no bit: test_torch_remat.py)
TWIN = {k: k.replace("block", "none") for k in KEYS}
# f32, relative to each leaf's max: the ranks sum the gradients in another
# order (the tolerance test_torch_ep_train.py holds at meshes); FSDP
# against fsdp=False at one mesh holds every leaf to it (they lie within
# 1e-6 of each other), and each run's metrics against one device
RTOL = 2e-5
# against one device every leaf is held to RTOL of its max but the expert
# w_out leaves (params and both moments), held by test_torch_training.py's
# rule for Adam steps: within 1e-5 except at most 1e-4 of the elements,
# those within 2·Σlr (a gradient near 0 that differs in its last bits
# flips the sign of Adam's ±lr step; those leaves reach 2.5e-5 of their
# max at 2x2 and 4x1 with and without FSDP alike, 2.3e-4 in two
# microbatches)
ATOL, FRAC = 1e-5, 1e-4


def _adam_ruled(key: str) -> bool:
    return key.endswith("moe/w_out")


@pytest.fixture(scope="module")
def init_params():
    cfg = jconfigs.smoke_config(ARCH).replace(dtype="float32")
    return jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(0),
                                                  cfg))


@pytest.fixture(scope="module")
def ranks(init_params, tmp_path_factory):
    """One spawn of four ranks: every cell of both meshes, FSDP then
    not."""
    import pickle
    path = tmp_path_factory.mktemp("fsdp") / "init.pkl"
    path.write_bytes(pickle.dumps(init_params))
    cells = [(k, shape, kw, TWIN[k] == k) for shape, cs in CELLS.items()
             for k, kw in cs]
    return spawn(torch_ranks.fsdp_train_rank, 4, backend="gloo", threads=1,
                 args=(ARCH, str(path), cells, (2, 2)))


@pytest.fixture(scope="module")
def reference(monkeypatch_module):
    """The reference's one-device runs: sort at capacity E, grouped, and
    grouped in two microbatches (remat changes nothing numerically)."""
    base = jconfigs.smoke_config
    out = {}
    for name, moe, mb in (("sort", dict(dispatch="sort",
                                        capacity_factor=4.0), 1),
                          ("grouped", dict(dispatch="grouped"), 1),
                          ("grouped-mb2", dict(dispatch="grouped"), 2)):
        def f32(arch, _moe=moe):
            cfg = base(arch)
            return cfg.replace(dtype="float32", moe=dataclasses.replace(
                cfg.moe, **_moe))
        monkeypatch_module.setattr(jconfigs, "smoke_config", f32)
        state, hist = jtrain.run(ARCH, steps=STEPS, batch=BATCH, seq=SEQ,
                                 smoke=True, microbatches=mb,
                                 log_every=1000, tune="off")
        flat = {k: np.asarray(v) for k, v in _flatten_state(state).items()}
        out[name] = (hist, flat)
    monkeypatch_module.setattr(jconfigs, "smoke_config", base)
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _flatten_state(state):
    from repro.checkpoint.io import _flatten
    return _flatten(state)


def _ref_name(key):
    if "sort" in key:
        return "sort"
    return "grouped-mb2" if key.endswith("mb2") else "grouped"


def _close(got, want, what):
    for k, w in want.items():
        g = np.asarray(got[k], dtype=np.float64)
        w = np.asarray(w, dtype=np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= RTOL * scale, (what, k)


def _adam_close(got, want, lrs, what):
    diff = np.concatenate([np.abs(np.asarray(got[k], np.float64)
                                  - np.asarray(w, np.float64)).ravel()
                           for k, w in want.items()])
    assert (diff > ATOL).mean() <= FRAC, (what, (diff > ATOL).sum())
    assert diff.max() <= 2 * lrs, (what, diff.max())


@pytest.mark.parametrize("key", KEYS)
def test_fsdp_training_matches_one_device_and_no_fsdp(ranks, reference, key):
    """Three steps under FSDP: loss, ce, aux, grad norm and lr on every
    rank within rtol 2e-5 of the reference's one-device run, and of the
    port's ``fsdp=False`` run at the same mesh, whose every leaf of
    params, moments and counters (gathered whole) FSDP's holds within
    2e-5 of the leaf's max; every leaf of params, moments and counters
    against one device within 2e-5 of its max, but the expert ``w_out``
    leaves, held by the Adam rule (``ATOL``); nothing skipped; a rank
    stores fewer parameters than without FSDP."""
    hist, flat = reference[_ref_name(key)]
    lrs = sum(j["lr"] for j in hist)
    r0 = ranks[0]
    for run in ((key, True), (TWIN[key], False)):
        for r in ranks:
            got = r[run]["history"]
            assert len(got) == STEPS
            for s, (t, j) in enumerate(zip(got, hist, strict=True)):
                for k in ("loss", "ce", "aux", "grad_norm", "lr"):
                    np.testing.assert_allclose(t[k], j[k], rtol=RTOL,
                                               atol=1e-9,
                                               err_msg=f"{run} {s} {k}")
                assert t["skipped"] == 0
        whole = r0[run]["whole"]
        assert set(whole) == set(flat)
        assert any(_adam_ruled(k) for k in flat)
        _close(whole, {k: w for k, w in flat.items()
                       if not _adam_ruled(k)}, run)
        _adam_close(whole, {k: w for k, w in flat.items()
                            if _adam_ruled(k)}, lrs, run)
    _close(r0[key, True]["whole"], r0[TWIN[key], False]["whole"], key)
    assert all(r[key, True]["stored"] < r[TWIN[key], False]["stored"]
               for r in ranks)


@pytest.mark.parametrize("key", KEYS)
def test_fsdp_replicated_scalars_bitwise_across_ranks(ranks, key):
    """The Adam count, the step and the skip / loss-scale counters are
    the same bits on every rank, with and without FSDP."""
    for run in ((key, True), (TWIN[key], False)):
        want = ranks[0][run]["scalars"]
        assert all(r[run]["scalars"] == want for r in ranks[1:])


def test_fsdp_draw_is_the_unsharded_draw(ranks):
    """``init_train_state`` under FSDP at 2x2 draws each leaf whole from
    the seeded generator and keeps its block: every rank stores the
    layout's block shapes, and gathered whole the weights are bitwise one
    process's draw."""
    for r in ranks:
        assert r["draw"] == {"blocks": True, "equal": True}


def test_fsdp_nan_on_one_rank_is_skipped_on_every_rank(ranks):
    """A NaN in rank 1's gradients at step 1 under FSDP at 2x2 skips step
    1 on all four ranks: every block of params and moments bitwise
    unchanged there, steps 0 and 2 applied."""
    for r in ranks:
        assert r["skip"]["skipped"] == [0, 1, 1]
        assert r["skip"]["unchanged"] == [False, True, False]
