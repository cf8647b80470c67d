"""The port's graph-invariant linter (``repro_torch.analysis``) against the
reference's (``repro.analysis``).

Every rule of the nine has a KNOWN-BAD case here that makes it fire at
level ``error`` with a structural location, and a clean twin, as
``tests/test_analysis.py`` has for the reference.  The clean matrix — the
reference's 36 cells — comes from ONE run of the lint as its CLI runs it
(``lint.lint_cells``: the ``r1`` cells in this process, the ep4, tp2 and
ep2tp2 cells each in one spawn of gloo CPU ranks), shared by every test
of this module: the recorded graphs the known-bad cases relabel, the
sequential-window job (``torch_ranks.lint_sequential_windows``) and the
forward counts come out of the same spawns.  The EP cells' AllToAll
count and payload-window count equal the reference's jaxpr counts on the
8 fake CPU devices.  The ``auto`` cells are left out of that comparison:
the two packages' default fabrics differ (the reference's ``ici_dcn``,
the port's ``pcie_eth100``), so their resolutions may differ; those cells
are held to the port's own resolution by ``tuned-plan-consistency``.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro import analysis as janalysis
from repro.analysis import lint as jlint
from repro.analysis import rules as jrules
from repro.core import capacity as jcapacity
from repro.core import moe as jmoe
from repro_torch import analysis
from repro_torch.analysis import lint
from repro_torch.core import alltoall
from repro_torch.core.config import MoEConfig
from repro_torch.kernels import grouped_ffn as gffn
from repro_torch.kernels import ops

REPO = pathlib.Path(__file__).resolve().parents[1]
# the EP cells whose counts are held to the reference's
EP_CELLS = ("grouped/ep4/flat/P2", "grouped/ep4/hier/P2",
            "grouped/ep4/flat/P2/int8", "grouped/ep4/hier/P1/float8_e4m3fn",
            "grouped/ep2tp2/flat/P2/int8", "grouped/ep4/flat/P4",
            "sort/ep4/hier/P1")
# rank 0's recorded graphs the known-bad cases relabel
KEEP = ("grouped/ep4/flat/P1", "grouped/ep4/flat/P2", "grouped/ep4/hier/P2",
        "grouped/ep4/flat/P1/int8", "grouped/ep4/auto/Pauto")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: at the lint's sizes a
    torch op is too small to share out, and the parallel test workers
    would otherwise contend for the cores with 8 threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def matrix():
    findings, meshes = lint.lint_cells(
        lint.matrix_cells(), device="cpu", keep=KEEP, jobs={"ep4": [
            ("sequential", "torch_ranks:lint_sequential_windows", ())]})
    counts, graphs = {}, {}
    for ranks in meshes.values():
        counts.update(ranks[0]["counts"])
        graphs.update(ranks[0]["graphs"])
    return {"findings": findings, "counts": counts, "graphs": graphs,
            "sequential": meshes["ep4"][0]["jobs"]["sequential"],
            "probes": lint.lint_probes("cpu")}


def _ctx(graph, **kw):
    """A copy of ``graph`` linted under another contract."""
    return analysis.OpGraph(graph.sites(), dict(graph.context, **kw))


# ---------------------------------------------------------------------------
# the recorded graph
# ---------------------------------------------------------------------------

def _grouped_loss(lhs, rhs, offsets, wrap=lambda f, *a: f(*a)):
    return (wrap(gffn.grouped_matmul, lhs, rhs, offsets).float() ** 2).sum()


def _grouped_operands(dtype=torch.float32):
    g = torch.Generator().manual_seed(3)
    lhs = torch.randn(32, 8, generator=g).to(dtype).requires_grad_(True)
    rhs = torch.randn(4, 8, 8, generator=g).to(dtype).requires_grad_(True)
    return lhs, rhs, torch.tensor([0, 10, 16, 16, 32], dtype=torch.int32)


def test_trace_graph_phases_paths_and_counters():
    g = analysis.trace_graph(_grouped_loss, *_grouped_operands(), grad=True,
                             context={"label": "unit"})
    assert g.kind == "ops" and g.label == "unit"
    kernels = [s.describe() for s in g.sites() if s.kind == "kernel"]
    assert kernels == ["fwd/grouped_matmul", "bwd/grouped_matmul_t",
                       "bwd/grouped_drhs"]
    # the plain versions' aten ops sit under their wrapper
    assert g.primitives()["aten.mm"] == g.count("aten.mm")
    mm = {s.describe() for s in g.find("aten.mm")}
    assert mm == {"fwd/grouped_matmul/aten.mm",
                  "bwd/grouped_matmul_t/aten.mm", "bwd/grouped_drhs/aten.mm"}
    [call] = g.find("grouped_matmul")
    assert call.in_dtypes == ("float32", "float32", "int32")
    assert call.in_shapes == ((32, 8), (4, 8, 8), (5,))
    # the CPU runs the plain versions: no launch counter moves
    assert set(g.launches) == {"fwd", "bwd"}
    assert not any(any(v.values()) for v in g.launches.values())
    # the logs are put back, and a caller's log keeps receiving
    assert ops.calls is None and alltoall.collectives is None
    ops.calls = []
    try:
        analysis.trace_graph(_grouped_loss, *_grouped_operands())
        assert [c.name for c in ops.calls] == ["grouped_matmul"]
    finally:
        ops.calls = None


def test_trace_graph_grad_needs_grad():
    lhs, rhs, offs = _grouped_operands()
    with pytest.raises(ValueError, match="require grad"):
        analysis.trace_graph(_grouped_loss, lhs.detach(), rhs.detach(),
                             offs, grad=True)


def test_hierarchical_stage_inputs_are_payload_windows(matrix):
    """The log records each stage's input: (inner, outer, B/P, d) then
    (outer, inner, B/P, d) — both matched as (M, B/P, d) windows."""
    g = matrix["graphs"]["grouped/ep4/hier/P2"]
    payload = analysis.rules.payload_sites(g, 4, 16, lint.D_MODEL)
    assert len(payload) == 8
    assert {s.in_shapes[0] for s in payload} == {(2, 2, 16, lint.D_MODEL)}
    assert {s.axis for s in payload} == {"inner", "outer"}
    assert all(s.in_dtypes == ("bfloat16",) for s in payload)


# ---------------------------------------------------------------------------
# per-rule known-bad graphs (each rule must FIRE somewhere)
# ---------------------------------------------------------------------------

def test_known_bad_collective_in_loop(matrix):
    """PR 5's hazard in eager form: two windows exchanged and computed
    one after the other — window 1's dispatch comes after window 0's
    grouped matmuls."""
    bad = matrix["sequential"]
    findings = analysis.run_rule("collective-in-loop", bad)
    assert len(findings) == 1
    f = findings[0]
    assert f.level == "error" and f.location == "fwd/all_to_all"
    assert "window 1's dispatch exchange is issued after window 0's" in (
        f.message)
    # the pipelined graph issues window 1's exchange first: clean
    good = matrix["graphs"]["grouped/ep4/flat/P2"]
    assert analysis.run_rule("collective-in-loop", good) == []
    assert analysis.run_rule("collective-in-loop",
                             matrix["graphs"]["grouped/ep4/hier/P2"]) == []
    # explicitly allowed, and the quantized (synchronous) wire exempt
    assert analysis.run_rule("collective-in-loop", _ctx(
        bad, allow_loop_collectives=True)) == []
    assert analysis.run_rule("collective-in-loop", _ctx(
        bad, cfg=dataclasses.replace(bad.context["cfg"],
                                     payload_dtype="int8"))) == []


def test_known_bad_overlap_chunk_count(matrix):
    """An unchunked (P=1) pipeline linted against a P=4 contract misses
    on both the collective count and the payload windows."""
    g = matrix["graphs"]["grouped/ep4/flat/P1"]
    cfg4 = dataclasses.replace(g.context["cfg"], overlap_chunks=4)
    findings = analysis.run_rule("overlap-chunk-count", _ctx(g, cfg=cfg4))
    assert len(findings) == 2, findings
    count_f, payload_f = findings
    assert all(f.level == "error" and f.location == "fwd/all_to_all"
               for f in findings)
    assert "12 all_to_all collectives, recorded 3" in count_f.message
    assert "(4, 8, 32)" in payload_f.message   # (M, B/P, d) window
    assert analysis.run_rule("overlap-chunk-count", g) == []


def test_known_bad_tuned_plan_consistency(matrix):
    """A flat/P=1 graph linted against the ``"auto"`` contract: the tuner
    resolves the two-stage exchange (stages=2) for this cell, so the
    recorded graph misses on the count (3 vs 5) and the windows."""
    flat = matrix["graphs"]["grouped/ep4/flat/P1"]
    auto = matrix["graphs"]["grouped/ep4/auto/Pauto"]
    findings = analysis.run_rule("tuned-plan-consistency",
                                 _ctx(flat, cfg=auto.context["cfg"]))
    assert len(findings) == 2, findings
    count_f, payload_f = findings
    assert "a2a='hierarchical'" in count_f.message
    assert "must issue 5 all_to_all collectives, recorded 3" in (
        count_f.message)
    assert payload_f.level == "error"
    # positive control: the graph recorded under the auto config
    assert analysis.run_rule("tuned-plan-consistency", auto) == []
    # concrete-config cells stay owned by overlap-chunk-count
    assert analysis.run_rule("tuned-plan-consistency", flat) == []


def test_known_bad_payload_dtype(matrix):
    """PR 10, both directions: a full-width wire under an int8 contract
    (the quantize/dequantize pair dropped), and an int8 wire under a
    full-width contract; a dot-like call fed the wire dtype."""
    full = matrix["graphs"]["grouped/ep4/flat/P1"]
    quant = matrix["graphs"]["grouped/ep4/flat/P1/int8"]
    findings = analysis.run_rule("payload-dtype",
                                 _ctx(full, cfg=quant.context["cfg"]))
    assert findings and all(f.level == "error" for f in findings)
    assert all("quantize/dequantize pair" in f.message for f in findings)
    assert any("int8" in f.message and "bfloat16" in f.message
               for f in findings)
    assert {f.location for f in findings} == {"fwd/all_to_all"}
    findings = analysis.run_rule("payload-dtype",
                                 _ctx(quant, cfg=full.context["cfg"]))
    assert findings and all("int8" in f.message for f in findings)
    # positive controls: graph and contract agree, both ways
    assert analysis.run_rule("payload-dtype", quant) == []
    assert analysis.run_rule("payload-dtype", full) == []
    # the quantized wire straight into a grouped kernel call
    leak = analysis.OpSite("grouped_matmul", "kernel", "fwd", (),
                           ("int8", "bfloat16", "int32"),
                           ((32, 32), (2, 32, 64), (3,)))
    findings = analysis.run_rule(
        "payload-dtype", analysis.OpGraph(quant.sites() + [leak],
                                          quant.context))
    assert [f.location for f in findings] == ["fwd/grouped_matmul"]
    assert "dequantized between the exchange" in findings[0].message


def test_known_bad_no_recompute_backward():
    """A checkpoint region around the grouped matmul re-runs the forward
    kernel in the backward — the recompute the dlhs/drhs VJP avoids."""
    cfg = MoEConfig(num_experts=4, dispatch="grouped", gate="topk", top_k=2)
    ctx = {"cfg": cfg, "direction": "grad"}
    remat = lambda f, *a: checkpoint(f, *a, use_reentrant=False)
    bad = analysis.trace_graph(
        lambda l, r, o: _grouped_loss(l, r, o, remat), *_grouped_operands(),
        grad=True, context=ctx)
    findings = analysis.run_rule("no-recompute-backward", bad)
    assert len(findings) == 1 and findings[0].level == "error"
    assert findings[0].location == "bwd/grouped_matmul"
    # the clean twin: the same product without the region
    good = analysis.trace_graph(_grouped_loss, *_grouped_operands(),
                                grad=True, context=ctx)
    assert analysis.run_rule("no-recompute-backward", good) == []
    # out of scope: a forward graph, a deliberate remat / FSDP recompute
    for kw in ({"direction": "fwd"}, {"remat": "block"}, {"fsdp": True}):
        assert analysis.run_rule("no-recompute-backward",
                                 _ctx(bad, **kw)) == []
    assert analysis.run_rule("no-recompute-backward", _ctx(
        bad, direction="fwd", expect_no_recompute=True)) != []


def test_known_bad_dtype_leak():
    """An f32 cotangent against bf16 weights at the dlhs kernel — PR 4's
    leak.  aten refuses most mixed products itself, and so does the
    wrapper; the recorded call before its check is what the rule sees."""
    g32 = torch.ones(32, 8)
    rhs16 = torch.ones(4, 8, 8, dtype=torch.bfloat16)
    offs = torch.tensor([0, 10, 16, 16, 32], dtype=torch.int32)

    def leak():
        with pytest.raises(ValueError, match="must share"):
            gffn.grouped_matmul_t(g32, rhs16, offs)
    bad = analysis.trace_graph(leak)
    findings = analysis.run_rule("dtype-leak", bad)
    assert len(findings) == 1
    assert findings[0].location == "fwd/grouped_matmul_t"
    assert "bfloat16" in findings[0].message
    assert "float32" in findings[0].message
    # one dtype (the int32 offsets exempt): clean; so is aten's f32 mm
    ok = analysis.trace_graph(lambda: (gffn.grouped_matmul_t(
        g32.bfloat16(), rhs16, offs), torch.ones(2, 3) @ torch.ones(3, 2)))
    assert ok.count("aten.mm") > 0
    assert analysis.run_rule("dtype-leak", ok) == []


def test_known_bad_donation_alias():
    z = torch.zeros((), dtype=torch.int32)
    findings = analysis.lint_probe(donated={"a": z, "b": z, "c": z + 1})
    assert len(findings) == 1
    f = findings[0]
    assert f.rule == "donation-alias" and f.level == "error"
    assert "'a'" in f.location and "'b'" in f.location
    # distinct storages: clean; views alias by byte range, not identity
    ok = {"a": torch.zeros((), dtype=torch.int32),
          "b": torch.zeros((), dtype=torch.int32)}
    assert analysis.lint_probe(donated=ok) == []
    x = torch.zeros(8)
    assert analysis.lint_probe(donated={"a": x[:4], "b": x[4:]}) == []
    assert len(analysis.lint_probe(donated={"a": x[:5], "b": x[4:]})) == 1
    assert len(analysis.lint_probe(donated=[x, x.view(2, 4)])) == 1


def test_real_train_state_is_alias_free():
    """The probe the CLI runs: a freshly initialized TrainState has no
    shared storage."""
    from repro_torch import configs
    from repro_torch.core.config import TrainConfig
    from repro_torch.training.train_step import (donation_alias_pairs,
                                                  init_train_state)

    cfg = configs.smoke_config("dbrx-132b").replace(dtype="float32")
    state = init_train_state(cfg, TrainConfig(), device="cpu")
    assert donation_alias_pairs(state) == []
    shared = state._replace(skipped=state.step)
    assert donation_alias_pairs(shared) == [(".step", ".skipped")]


def test_known_bad_retrace_budget():
    counts = {("decode", "dbrx", 1, 32): 3, ("prefill", "dbrx", 1, 32): 1}
    findings = analysis.lint_probe(trace_counts=counts)
    assert len(findings) == 1
    assert findings[0].rule == "retrace-budget"
    assert findings[0].level == "error"
    assert "3x" in findings[0].message
    assert analysis.lint_probe(trace_counts=counts, budget=3) == []


def test_known_bad_config_invalid():
    findings = analysis.lint_probe(config_error="P does not divide B",
                                   label="grouped/ep4/flat/P5")
    assert len(findings) == 1
    f = findings[0]
    assert f.rule == "config-invalid" and f.level == "error"
    assert f.location == "grouped/ep4/flat/P5"
    assert "does not divide" in f.message


def test_bad_overlap_bound_is_a_finding_not_a_traceback():
    """The validators' rejections surface as findings through the same
    lint_cell the CLI drives — no rank is needed to find them."""
    for cell in ("grouped/ep4/flat/P5", "decode/ep4/grouped/P3"):
        findings = lint.lint_cell(cell)
        assert [f.rule for f in findings] == ["config-invalid"], cell
        assert "overlap_chunks" in findings[0].message
    with pytest.raises(ValueError, match="1x4 mesh of ranks"):
        lint.lint_cell("grouped/ep4/flat/P2")


# ---------------------------------------------------------------------------
# the clean matrix and the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", lint.matrix_cells())
def test_matrix_cell_lints_clean(matrix, cell):
    assert matrix["findings"][cell] == []


def test_probes_clean(matrix):
    assert matrix["probes"] == []


def test_matrix_and_rules_are_the_reference_s():
    assert lint.matrix_cells() == jlint.matrix_cells()
    assert len(lint.matrix_cells()) == 36
    assert {n: r.level for n, r in analysis.REGISTRY.items()} == {
        n: r.level for n, r in jrules.REGISTRY.items()}
    assert all(r.kinds in (("ops",), ("probe",))
               for r in analysis.REGISTRY.values())


def test_lint_cell_rejects_unknown_vocabulary():
    for bad in ("grouped/ep4/flat", "groped/ep4/flat/P2",
                "grouped/ep4/flat/Px", "grouped/ep4/flat/P2/int4"):
        with pytest.raises(ValueError, match="bad lint cell"):
            lint.parse_cell(bad)


def _reference_counts(cell):
    spec = jlint.parse_cell(cell)
    mesh, tp = jlint._mesh(spec["mesh"])
    M, T = jlint._model_size(spec["mesh"]), jlint._tokens_per_shard(
        spec["mesh"])
    cfg = jlint._cell_cfg(spec)
    params = jmoe.init_moe_params(jax.random.PRNGKey(0), cfg, jlint.D_MODEL,
                                  jlint.D_FF, jlint.E, act="swiglu",
                                  dtype=jnp.bfloat16)
    x = jax.random.normal(jax.random.PRNGKey(1),
                          (*jlint.TOKENS, jlint.D_MODEL), jnp.bfloat16)
    g = janalysis.trace_graph(lambda p, v: jmoe.sharded_moe_apply(
        mesh, cfg, p, v, num_experts=jlint.E, act="swiglu",
        expert_tp_axis=tp), params, x)
    B = jcapacity.grouped_segment_bound(cfg, T, M)
    return {"all_to_all": g.count("all_to_all"),
            "payload": len(jrules._payload_sites(
                g, M, B // cfg.overlap_chunks, jlint.D_MODEL))}


@pytest.mark.parametrize("cell", EP_CELLS)
def test_ep_counts_equal_the_reference_jaxpr(matrix, cell):
    assert matrix["counts"][cell] == _reference_counts(cell)
    assert matrix["counts"][cell]["all_to_all"] > 0


def test_ranks_must_agree():
    same = {"findings": {"c": []}}
    lint.check_ranks_agree("ep4", ["c"], [same, same])
    other = {"findings": {"c": [{"rule": "dtype-leak"}]}}
    with pytest.raises(RuntimeError, match="rank 2 of mesh ep4"):
        lint.check_ranks_agree("ep4", ["c"], [same, same, other])


def test_committed_report_is_the_matrix_s(matrix, tmp_path):
    """``LINT_moe_torch.json`` is what the full CPU matrix and the probes
    write; its rule names and matrix are ``LINT_moe.json``'s."""
    cells = lint.matrix_cells()
    found = [f for c in cells for f in matrix["findings"][c]]
    fresh = lint.write_report(tmp_path / "lint.json", cells,
                              found + matrix["probes"],
                              sorted(analysis.REGISTRY))
    committed = json.loads((REPO / "LINT_moe_torch.json").read_text())
    assert fresh == committed
    assert committed["schema"] == lint.SCHEMA
    ref = json.loads((REPO / "LINT_moe.json").read_text())
    assert sorted(committed["rules"]) == sorted(ref["rules"])
    assert committed["matrix"] == ref["matrix"]
    assert committed["findings"] == ref["findings"] == []
    assert set(committed) == set(ref)


# ---------------------------------------------------------------------------
# the CLI (subprocess)
# ---------------------------------------------------------------------------

def _run_cli(*extra):
    env = {**os.environ, "PYTHONPATH": "src"}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_cli_bad_config_exits_nonzero_with_report(tmp_path):
    out = tmp_path / "lint.json"
    r = _run_cli("--config", "grouped/ep4/flat/P5", "--device", "cpu",
                 "--json", str(out))
    assert r.returncode == 1, r.stdout + r.stderr
    assert "Traceback" not in r.stderr
    assert "config-invalid" in r.stdout
    report = json.loads(out.read_text())
    assert report["schema"] == lint.SCHEMA
    assert report["summary"]["error"] == 1
    [finding] = report["findings"]
    assert finding["rule"] == "config-invalid"
    assert finding["config"] == "grouped/ep4/flat/P5"


def test_cli_unknown_cell_is_an_argparse_error(tmp_path):
    r = _run_cli("--config", "grouped/nope/flat/P2", "--device", "cpu",
                 "--json", str(tmp_path / "l.json"))
    assert r.returncode == 2, r.stdout + r.stderr
    assert "bad lint cell" in r.stderr
