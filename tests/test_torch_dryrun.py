"""The dry run (``launch/dryrun.py``) against the reference's
``repro/launch/dryrun.py``: its pure functions (``eligible``,
``active_params``, ``attention_flops_fwd``, ``model_flops``) on the ten
assigned presets × the four input shapes; ``make_batch_specs``; the specs
of ``input_specs`` (``batch_shardings``, ``fit_spec``, ``cache_shardings``
over the port's per-layer caches) on six meshes, (1,1), (2,2), (2,4),
(4,2), (1,8) and the pod mesh (2,2,2), entry for entry; and ``--all`` at
both production meshes in a process that never imports JAX.  The
reference module is imported inside the tests: its first line sets
``XLA_FLAGS``, after ``tests/conftest.py`` has fixed the backend."""
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from repro import configs as jconfigs
from repro.core import config as jconfig
from repro.data import pipeline as jpipeline
from repro_torch import configs
from repro_torch.core import config as tconfig
from repro_torch.data import pipeline
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as pmesh

SHAPES = list(jconfig.INPUT_SHAPES)
PAIRS = [(a, s) for a in jconfigs.ASSIGNED for s in SHAPES]
MESHES = [(1, 1), (2, 2), (2, 4), (4, 2), (1, 8), (2, 2, 2)]


@pytest.fixture(scope="module")
def ref():
    from repro.launch import dryrun as jdryrun
    return jdryrun


def test_assigned_and_shapes_are_the_references():
    """The ten presets in the reference's order and the four shapes."""
    assert configs.ASSIGNED == jconfigs.ASSIGNED
    assert {k: (v.name, v.seq_len, v.global_batch, v.mode)
            for k, v in tconfig.INPUT_SHAPES.items()} == {
        k: (v.name, v.seq_len, v.global_batch, v.mode)
        for k, v in jconfig.INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", jconfigs.ASSIGNED)
def test_pure_functions_equal_the_references(ref, arch):
    """``eligible`` (the skip reasons), ``active_params``,
    ``attention_flops_fwd`` and ``model_flops`` equal the reference's at
    every shape (rel 1e-12)."""
    jc, tc = jconfigs.get_config(arch), configs.get_config(arch)
    assert dryrun.active_params(tc) == pytest.approx(
        ref.active_params(jc), rel=1e-12)
    for s in SHAPES:
        js, ts = jconfig.INPUT_SHAPES[s], tconfig.INPUT_SHAPES[s]
        assert dryrun.eligible(arch, s) == ref.eligible(arch, s)
        assert dryrun.attention_flops_fwd(tc, ts) == pytest.approx(
            ref.attention_flops_fwd(jc, js), rel=1e-12, abs=0)
        assert dryrun.model_flops(tc, ts) == pytest.approx(
            ref.model_flops(jc, js), rel=1e-12)
    assert dryrun.LONG_CONTEXT_VARIANT == ref.LONG_CONTEXT_VARIANT
    assert dryrun.GIANT == ref.GIANT
    for a, b in ((dryrun.DRYRUN_TCFG, ref.DRYRUN_TCFG),
                 (dryrun.DRYRUN_TCFG_GIANT, ref.DRYRUN_TCFG_GIANT)):
        assert (a.remat, a.microbatches, a.optimizer_state_dtype) == (
            b.remat, b.microbatches, b.optimizer_state_dtype)


@pytest.mark.parametrize("arch", jconfigs.ASSIGNED)
def test_batch_specs_equal_the_references(arch):
    """``make_batch_specs``: the reference's shapes and dtypes (int32
    tokens or a frontend's (B, S, d) embeddings, int32 targets, f32
    loss mask), as ``meta`` tensors."""
    jc, tc = jconfigs.get_config(arch), configs.get_config(arch)
    for s in SHAPES:
        want = jpipeline.make_batch_specs(jc, jconfig.INPUT_SHAPES[s],
                                          dtype=jc.dtype)
        got = pipeline.make_batch_specs(tc, tconfig.INPUT_SHAPES[s],
                                        dtype=tc.dtype)
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), (s, k)
            assert str(got[k].dtype).removeprefix("torch.") == str(
                want[k].dtype), (s, k)
            assert got[k].device.type == "meta"


def _jmesh(shape):
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    n = math.prod(shape)
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), axes)


def _pmesh(shape):
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return dict(zip(axes, shape))


def _spec(named):
    """A NamedSharding's spec as the port's tuple, one entry per dim."""
    return tuple(named.spec)


def _ref_cache_leaf(ref_caches, cfg, i, path):
    """The reference's stacked cache leaf of port layer ``i`` at
    ``path`` (its pattern slot, then the keys)."""
    leaf = ref_caches[i % len(cfg.block_pattern)]
    for p in path.split("/")[1:]:
        leaf = leaf[p]
    return leaf


@pytest.mark.parametrize("shape", MESHES,
                         ids=["x".join(map(str, m)) for m in MESHES])
def test_input_specs_equal_the_references(ref, shape):
    """``input_specs`` on every eligible pair: the batch's specs
    (``batch_shardings``), the prefill / decode tokens' (``fit_spec`` of
    the batch axes, ``pod`` then ``data``) and every cache leaf's
    (``cache_shardings``: the reference's (NSB, B, ...) spec without its
    NSB entry on the port's per-layer (B, ...) leaf, whose shape is the
    reference's without NSB), entry for entry."""
    jm, pm = _jmesh(shape), _pmesh(shape)
    assert pmesh.dp_axes(pm) == ref.mesh_lib.dp_axes(jm)
    for arch, s in PAIRS:
        if ref.eligible(arch, s) is not None:
            continue
        cfg = configs.get_config(arch)
        want = ref.input_specs(arch, s, jm)
        got, specs = dryrun.input_specs(arch, s, pm)
        mode = tconfig.INPUT_SHAPES[s].mode
        if mode == "train":
            for k in want:
                assert tuple(got[k].shape) == want[k].shape
                assert specs[k] == _spec(want[k].sharding), (arch, s, k)
        elif mode == "prefill":
            assert tuple(got.shape) == want.shape
            assert specs == _spec(want.sharding), (arch, s)
        else:
            (tok, caches), (tok_spec, cache_specs) = got, specs
            wtok, wcaches = want
            assert tuple(tok.shape) == wtok.shape
            assert tok_spec == _spec(wtok.sharding), (arch, s)
            for i, layer in enumerate(caches):
                for path, leaf in pmesh.tree_paths(layer, str(i)):
                    w = _ref_cache_leaf(wcaches, cfg, i, path)
                    assert tuple(leaf.shape) == w.shape[1:], (arch, path)
                    spec = dict(pmesh.spec_paths(cache_specs[i], str(i)))
                    assert spec[path] == _spec(w.sharding)[1:], (
                        arch, s, path, spec[path], w.sharding.spec)


class _ShapeMesh:
    """A mesh's axis names and sizes, all the reference's cache rule reads
    of it (no 256 devices are needed to count its blocks)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
@pytest.mark.parametrize("s", ["decode_32k", "long_500k"])
def test_recurrent_cache_bytes_are_the_references_rule(ref, monkeypatch,
                                                       arch, s):
    """At 16x16 the dry run's ``caches`` a rank equal the bytes a device
    holds of the reference's stacked caches (``init_caches``) by its own
    ``cache_shardings``: the recurrent states cut over ``model`` too
    (RWKV's key dim, Mamba's head dim and conv channels), not by rows
    only."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec
    from repro.models import transformer as JT
    monkeypatch.setattr(ref.mesh_lib, "NamedSharding",
                        lambda mesh, spec: spec)
    big = _ShapeMesh({"data": 16, "model": 16})
    jc, tc = jconfigs.get_config(arch), configs.get_config(arch)
    shape = tconfig.INPUT_SHAPES[s]
    caches = jax.eval_shape(lambda: JT.init_caches(
        jc, shape.global_batch, shape.seq_len,
        long_context=s == "long_500k", dtype=jnp.dtype(jc.dtype)))
    specs = ref.mesh_lib.cache_shardings(big, caches)
    want = 0
    for leaf, spec in zip(jax.tree.leaves(caches), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, PartitionSpec)),
            strict=True):
        n = math.prod(big.shape[a] for e in spec if e is not None
                      for a in (e if isinstance(e, tuple) else (e,)))
        want += math.prod(leaf.shape) // n * leaf.dtype.itemsize
    rec = dryrun.count_pair(tc, shape, dict(big.shape), fsdp=False,
                            long_context=s == "long_500k")
    assert rec["stored_bytes"]["caches"] == want
    rows = dryrun.count_pair(tc, shape, {"data": 16, "model": 1},
                             fsdp=False, long_context=s == "long_500k")
    assert want < rows["stored_bytes"]["caches"]


def test_production_meshes():
    """The reference's production meshes as shapes: 16x16, and 2x16x16
    with the pod axis outermost, which batches shard over with data."""
    one = pmesh.make_production_mesh()
    two = pmesh.make_production_mesh(multi_pod=True)
    assert list(one.items()) == [("data", 16), ("model", 16)]
    assert list(two.items()) == [("pod", 2), ("data", 16), ("model", 16)]
    assert pmesh.dp_axes(two) == ("pod", "data")
    assert pmesh.batch_shardings(two, {"x": np.empty((256, 8))}) == {
        "x": (("pod", "data"), None)}


_RUN = """
import sys
sys.path.insert(0, {src!r})
from repro_torch.launch import dryrun
dryrun.OUT_DIR = {out!r}
dryrun.main({argv!r})
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules), "the dry run imported JAX"
"""


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_all_pairs_run_without_jax(ref, tmp_path, multi_pod):
    """``--all`` (and ``--all --multi-pod``) in a fresh process: no JAX
    import, the reference's skip reason for every skipped pair and a
    record for every other, whose stored bytes, model FLOPs and
    collectives are counted and whose roofline names its dominant term
    from the datasheet constants: at 16x16 every pair executed, its
    compute and memory terms the executed FLOPs and bytes a rank; at
    2x16x16 the plan's, the record saying why it was not executed.
    Eight worker processes execute the 32 pairs (~6 CPU-minutes), so
    that the run keeps inside its 300 s beside the other test
    workers."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    argv = ["--all", "--jobs", "8"] + (["--multi-pod"] if multi_pod else [])
    code = _RUN.format(src=os.path.abspath(src), out=str(tmp_path),
                       argv=argv)
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "JAX_PLATFORMS": ""})
    assert done.returncode == 0, done.stderr[-3000:]
    mesh = "2x16x16" if multi_pod else "16x16"
    for arch, s in PAIRS:
        with open(tmp_path / f"{arch}__{s}__{mesh}.json") as f:
            rec = json.load(f)
        reason = ref.eligible(arch, s)
        if reason is not None:
            assert rec["skipped"] == reason
            assert f"SKIP: {reason}" in done.stdout
            continue
        cfg = configs.get_config(arch)
        chips = 512 if multi_pod else 256
        assert rec["chips"] == chips
        assert rec["model_flops"] == pytest.approx(
            dryrun.model_flops(cfg, tconfig.INPUT_SHAPES[s]), rel=1e-12)
        assert rec["model_flops_per_chip"] == pytest.approx(
            rec["model_flops"] / chips, rel=1e-12)
        st = rec["stored_bytes"]
        assert st["params"] > 0 and st["total"] >= st["params"]
        r = rec["roofline"]
        terms = {k: r[k] for k in ("compute_s", "memory_s", "collective_s")}
        assert r["dominant"] == max(terms, key=terms.get)
        if multi_pod:
            assert rec["not_executed"] == dryrun.POD_REASON
            assert "memory_analysis" not in rec
            assert r["compute_s"] == pytest.approx(
                rec["model_flops_per_chip"] / dryrun.PEAK_FLOPS, rel=1e-12)
        else:
            oa, ma = rec["op_analysis"], rec["memory_analysis"]
            assert r["compute_s"] == pytest.approx(
                oa["flops"] / dryrun.PEAK_FLOPS, rel=1e-12)
            assert r["memory_s"] == pytest.approx(
                oa["hbm_bytes"] / dryrun.HBM_BW, rel=1e-12)
            assert r["useful_fraction"] == pytest.approx(
                rec["model_flops"] / (oa["flops"] * chips), rel=1e-12)
            assert ma["peak_per_device_bytes"] >= ma["argument_bytes"] > 0
            assert oa["collectives"]["count"] == rec["collectives"]["count"]
        coll = rec["collectives"]
        assert coll["total_wire_bytes"] == pytest.approx(
            sum(o["wire_bytes"] for o in coll["ops"]), rel=1e-12)
        if cfg.moe is not None:
            # the model group of 16 spans two nodes of 8
            assert any(o["axis"] == "model" and o["crosses_node"]
                       for o in coll["ops"]), (arch, s)


def test_wire_bytes_and_node_crossing():
    """Each op's wire bytes a rank follow the ring and pairwise costs
    (all-gather (n-1)·input, all-reduce 2(n-1)/n, all-to-all and
    reduce-scatter (n-1)/n of the input); a group crosses a node of 8
    GPUs where its ranks (r = d·M + m) do: at 16x16 the model group (16
    consecutive ranks) and the data group (stride 16) cross, at 2x4 none
    does."""
    from repro_torch.core.alltoall import Collective
    c = Collective("all_gather", "data", 4, "bfloat16", (8, 16))
    assert c.wire_bytes == 3 * 8 * 16 * 2
    assert Collective("all_reduce", "world", 4, "float32",
                      (10,)).wire_bytes == 2 * 40 * 3 / 4
    assert Collective("reduce_scatter", "data", 2, "float32",
                      (4, 4)).wire_bytes == 64 / 2
    big = {"data": 16, "model": 16}
    for axis, want in (("model", True), ("data", True)):
        ranks = dryrun._member_offsets((axis,), axis, 16, big, 1)
        assert (len({r // dryrun.NODE for r in ranks}) > 1) == want
    small = {"data": 2, "model": 4}
    for axis in ("model", "data"):
        ranks = dryrun._member_offsets((axis,), axis, small[axis], small, 1)
        assert len({r // dryrun.NODE for r in ranks}) == 1
