"""The rule registry and the shipped graph-invariant rules — the port of
``repro/analysis/rules.py``, over the recorded op graphs of
``analysis/graph.py`` and the same probes.  The rules keep the
reference's names and levels; each docstring states the hazard in its
torch form (the PR number is the reference's regression it guards):

  collective-in-loop      PR 5: the overlap pipeline lost its overlap —
                          window i+1's dispatch exchange is not issued
                          before window i's grouped matmuls (eager torch
                          has no loop body to fold it into).
  overlap-chunk-count     PR 5: the grouped exchange with
                          ``overlap_chunks = P`` issues exactly
                          ``moe.expected_grouped_a2a_eqns`` AllToAlls, its
                          payloads in (M, B/P, d) windows.
  tuned-plan-consistency  PR 9: under ``"auto"`` knobs, the count and
                          windows of the plan ``core/tuning.py`` resolves.
  no-recompute-backward   PR 3: the grouped backward runs the dlhs / drhs
                          kernels; the forward grouped kernel in the
                          backward is a recompute.
  dtype-leak              PR 4: mixed float operand dtypes on a dot-like
                          op or grouped kernel call.
  payload-dtype           PR 10: the payload AllToAlls move the resolved
                          wire dtype, and no dot-like op consumes it.
  donation-alias          PR 6: two leaves of a state tree share storage.
  retrace-budget          PR 7: each serving step-cache key is built once.
  config-invalid          a config × mesh cell the validators reject.

A new rule ships with a KNOWN-BAD case in ``tests/test_torch_analysis.py``
that makes it fire, and the clean matrix shows it quiet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.analysis.graph import OpGraph, OpSite, ProbeGraph

LEVELS = ("error", "warn", "info")

# the kinds ``core/alltoall.collectives`` logs: the bulk collectives
COLLECTIVE_PRIMITIVES = frozenset({
    "all_to_all", "all_gather", "reduce_scatter", "all_reduce",
})

# dot-like sites whose float operands must agree: the aten products and
# the grouped kernels' wrappers (offsets / index operands are integral
# and exempt)
DOT_PRIMITIVES = frozenset({
    "aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm", "aten._grouped_mm",
    "grouped_matmul", "grouped_matmul_t", "grouped_drhs",
})


@dataclass(frozen=True)
class Finding:
    """One lint hit.  ``location`` is a structural path
    (``fwd/all_to_all``, ``bwd/grouped_matmul``) or a probe key;
    ``config`` is the matrix cell / graph label it was found under."""
    rule: str
    level: str
    location: str
    message: str
    config: str = ""

    def as_dict(self) -> Dict[str, str]:
        return {"rule": self.rule, "level": self.level,
                "location": self.location, "message": self.message,
                "config": self.config}


@dataclass(frozen=True)
class Rule:
    name: str
    level: str
    kinds: Tuple[str, ...]                  # graph kinds it applies to
    check: Callable[[Any], List[Finding]]   # Graph -> findings
    doc: str = ""


REGISTRY: Dict[str, Rule] = {}


def register(name: str, level: str, kinds: Tuple[str, ...]):
    """Decorator: register ``check(graph) -> [Finding]`` under ``name``.

    The wrapped checker may return ``(location, message)`` pairs; they
    are stamped here with the rule's name, level and the graph's label,
    so a rule cannot misreport its own identity.
    """
    if level not in LEVELS:
        raise ValueError(f"rule {name!r}: level must be one of {LEVELS}, "
                         f"got {level!r}")

    def wrap(fn: Callable) -> Callable:
        def check(graph) -> List[Finding]:
            out = []
            for f in fn(graph):
                if isinstance(f, Finding):
                    out.append(Finding(name, level, f.location, f.message,
                                       f.config or graph.label))
                else:  # (location, message) shorthand
                    loc, msg = f
                    out.append(Finding(name, level, loc, msg, graph.label))
            return out
        REGISTRY[name] = Rule(name, level, kinds, check, doc=fn.__doc__ or "")
        return fn
    return wrap


def rules_for(kind: str, names: Optional[Iterable[str]] = None) -> List[Rule]:
    wanted = set(names) if names is not None else None
    unknown = (wanted or set()) - set(REGISTRY)
    if unknown:
        raise ValueError(f"unknown lint rule(s) {sorted(unknown)}; "
                         f"registered: {sorted(REGISTRY)}")
    return [r for r in REGISTRY.values()
            if kind in r.kinds and (wanted is None or r.name in wanted)]


def run_rule(name: str, graph) -> List[Finding]:
    """Run ONE registered rule against a graph."""
    if name not in REGISTRY:
        raise ValueError(f"unknown lint rule {name!r}; "
                         f"registered: {sorted(REGISTRY)}")
    return REGISTRY[name].check(graph)


def lint_graph(graph, rules: Optional[Iterable[str]] = None) -> List[Finding]:
    out: List[Finding] = []
    for rule in rules_for(graph.kind, rules):
        out.extend(rule.check(graph))
    return out


def _is_float(dtype: str) -> bool:
    return getattr(torch, dtype).is_floating_point


# ---------------------------------------------------------------------------
# the grouped exchange's contract (shared by the rules below)
# ---------------------------------------------------------------------------

def _grouped_ep(graph: OpGraph, *, auto: Optional[bool]):
    """``(resolved cfg, M, T, d)`` of a forward grouped-EP graph with the
    payload context, or None where the rules do not apply.  ``auto``
    True / False keeps only configs with / without ``"auto"`` knobs
    (None: either, resolved; without the dtype an auto config cannot be
    resolved)."""
    from repro_torch.core import tuning

    ctx = graph.context
    cfg = ctx.get("cfg")
    M = int(ctx.get("model_size", 1))
    T, d = ctx.get("tokens_per_shard"), ctx.get("d_model")
    if (cfg is None or cfg.dispatch != "grouped" or M <= 1
            or ctx.get("direction", "fwd") != "fwd" or T is None
            or d is None):
        return None
    has_auto = tuning.has_auto_knobs(cfg)
    if auto is not None and has_auto != auto:
        return None
    if has_auto:
        if ctx.get("dtype") is None:
            return None
        cfg = tuning.resolve_moe_config(cfg, model_size=M,
                                        tokens_per_shard=int(T),
                                        d_model=int(d), dtype=ctx["dtype"])
    return cfg, M, int(T), int(d)


def payload_sites(graph: OpGraph, model_size: int, chunk_rows: int,
                  d_model: int) -> List[OpSite]:
    """The forward AllToAll sites that move an (…, chunk_rows, d_model)
    token window across ``model_size`` ranks — the reference's
    ``_payload_sites``.  The log records each stage's input: ``(M, B/P,
    d)`` flat, ``(inner, outer, B/P, d)`` and ``(outer, inner, B/P, d)``
    for the two stages, so the match is the trailing window plus the
    leading axes' product."""
    out = []
    for site in graph.find("all_to_all", "fwd"):
        s = site.in_shapes[0] if site.in_shapes else ()
        if (len(s) >= 3 and s[-1] == d_model and s[-2] == chunk_rows
                and math.prod(s[:-2]) == model_size):
            out.append(site)
    return out


def _count_and_windows(graph: OpGraph, cfg, M: int, T: int, d: int,
                       what: str) -> List:
    """The AllToAll count and the payload windows against ``cfg``'s."""
    from repro_torch.core import capacity
    from repro_torch.core import moe as moe_lib

    expected = moe_lib.expected_grouped_a2a_eqns(cfg, M)
    got = graph.count("all_to_all", "fwd")
    out = []
    if got != expected:
        out.append(("fwd/all_to_all",
                    f"{what} must issue {expected} all_to_all "
                    f"collectives, recorded {got} — the overlap pipeline "
                    f"folded or short-circuited"))
    B = capacity.grouped_segment_bound(cfg, T, M)
    P = cfg.overlap_chunks
    if B % P:
        return out            # bound validation owns this failure mode
    want = 2 * moe_lib.grouped_a2a_stages(cfg, M) * P
    payload = payload_sites(graph, M, B // P, d)
    if len(payload) != want:
        out.append(("fwd/all_to_all",
                    f"{what} expects {want} payload all_to_all "
                    f"collectives moving ({M}, {B // P}, {d}) windows "
                    f"(bound B={B}, P={P}), found {len(payload)} — the "
                    f"windows did not split the bound"))
    return out


# ---------------------------------------------------------------------------
# shipped rules — op graphs
# ---------------------------------------------------------------------------

@register("collective-in-loop", "error", ("ops",))
def _collective_in_loop(graph: OpGraph) -> List:
    """The overlap pipeline lost its overlap: for some window ``i <
    P-1``, window i+1's dispatch exchange (its counts AllToAll and its
    payload stages) is not issued before window i's first grouped
    matmul.  The reference's hazard is a collective folded into a
    ``scan`` body, which XLA runs one iteration at a time; eager torch
    has no loop body, and the same loss shows as the issue order —
    windows exchanged and computed one after another, so no exchange
    overlaps a matmul.  Applies to forward grouped graphs with
    ``overlap_chunks = P > 1`` over ``model_size > 1`` ranks (the
    resolved knobs where they are ``"auto"``) and no quantized wire,
    whose exchanges run synchronously by design.  ``allow_loop_
    collectives`` in the context exempts a graph.
    """
    from repro_torch.core import moe as moe_lib

    if graph.context.get("allow_loop_collectives"):
        return []
    got = _grouped_ep(graph, auto=None)
    if got is None:
        return []
    cfg, M = got[0], got[1]
    P = cfg.overlap_chunks
    if P <= 1 or cfg.payload_dtype is not None:
        return []
    stages = moe_lib.grouped_a2a_stages(cfg, M)
    fwd = graph.sites("fwd")
    a2a = [i for i, s in enumerate(fwd) if s.op == "all_to_all"]
    counts = [i for i in a2a if not _is_float(fwd[i].in_dtypes[0])]
    mms = [i for i, s in enumerate(fwd) if s.op == "grouped_matmul"]
    if len(counts) < P or not mms or len(mms) % P:
        return [("fwd/all_to_all",
                 f"overlap_chunks={P}: recorded {len(counts)} dispatch "
                 f"count exchanges and {len(mms)} grouped matmuls — not "
                 f"P windows")]
    per = len(mms) // P
    out = []
    for i in range(P - 1):
        first_mm = mms[i * per]
        # window i+1's dispatch: its counts exchange, then its stages
        tail = [j for j in a2a if j > counts[i + 1]][:stages]
        last = max([counts[i + 1]] + tail)
        if last > first_mm:
            out.append((fwd[last].describe(),
                        f"window {i + 1}'s dispatch exchange is issued "
                        f"after window {i}'s first grouped matmul (site "
                        f"{last} > {first_mm}) — the pipelined exchanges "
                        f"run one window after another and overlap no "
                        f"compute"))
    return out


@register("overlap-chunk-count", "error", ("ops",))
def _overlap_chunk_count(graph: OpGraph) -> List:
    """The grouped exchange with ``overlap_chunks = P`` must issue exactly
    ``moe.expected_grouped_a2a_eqns(cfg, model_size)`` AllToAll
    collectives in the forward — P × (1 counts + stages dispatch +
    stages combine, + 1 scales with a quantized wire) — and its payload
    exchanges must move (M, B/P, d) windows, not the whole bound.  Fewer
    means the pipeline collapsed or short-circuited; whole-bound payloads
    mean the windows never split.  Applies to forward graphs recorded
    with ``cfg``/``model_size``/``tokens_per_shard``/``d_model`` context;
    ``"auto"``-knob configs belong to ``tuned-plan-consistency``.
    """
    got = _grouped_ep(graph, auto=False)
    if got is None:
        return []
    cfg, M, T, d = got
    return _count_and_windows(
        graph, cfg, M, T, d, f"grouped dispatch with overlap_chunks="
        f"{cfg.overlap_chunks}, a2a={cfg.a2a!r}")


@register("tuned-plan-consistency", "error", ("ops",))
def _tuned_plan_consistency(graph: OpGraph) -> List:
    """A graph recorded under an ``"auto"``-knob config must match the
    knobs ``core/tuning.py`` resolves for that cell: exactly
    ``moe.expected_grouped_a2a_eqns(resolved, M)`` AllToAlls, whose
    payload exchanges move the resolved plan's ``(M, B/P, d)`` windows.
    A mismatch means the run and the tuner disagreed — a
    non-deterministic resolver, a path reading the sentinel directly, a
    stale plan cache.  Applies to forward grouped-EP graphs with
    ``cfg``/``model_size``/``tokens_per_shard``/``d_model``/``dtype``
    context where ``cfg`` carries a sentinel.
    """
    got = _grouped_ep(graph, auto=True)
    if got is None:
        return []
    cfg, M, T, d = got
    return _count_and_windows(
        graph, cfg, M, T, d, f"resolved TunedPlan (a2a={cfg.a2a!r}, "
        f"a2a_inner={cfg.a2a_inner}, overlap_chunks={cfg.overlap_chunks})")


@register("payload-dtype", "error", ("ops",))
def _payload_dtype_rule(graph: OpGraph) -> List:
    """The grouped exchange's payload AllToAlls must move the RESOLVED
    wire dtype: ``payload_dtype`` (int8 / fp8) when it is set, the
    compute dtype (``dtype``) when it is ``None`` — a payload at the
    wrong dtype means the quantize / dequantize pair was dropped (a
    full-width wire) or never undone.  With a quantized wire no dot-like
    op or grouped kernel call may take the wire dtype as an operand:
    dequantization happens between the exchange and the grouped matmul,
    which accumulates in f32.  Applies to forward grouped-EP graphs with
    ``cfg``/``model_size``/``tokens_per_shard``/``d_model``/``dtype``
    context.
    """
    from repro_torch.core import capacity

    got = _grouped_ep(graph, auto=None)
    if got is None:
        return []
    cfg, M, T, d = got
    if cfg.payload_dtype is not None:
        wire = cfg.payload_dtype
    elif graph.context.get("dtype") is not None:
        wire = str(graph.context["dtype"]).removeprefix("torch.")
    else:
        return []                     # nothing concrete to assert against
    B = capacity.grouped_segment_bound(cfg, T, M)
    P = cfg.overlap_chunks
    if B % P:
        return []                     # bound validation owns this cell
    out = []
    for site in payload_sites(graph, M, B // P, d):
        if site.in_dtypes[0] != wire:
            out.append((site.describe(),
                        f"payload all_to_all moved {site.in_dtypes[0]}, "
                        f"but the resolved payload_dtype="
                        f"{cfg.payload_dtype!r} requires {wire} on the "
                        f"wire — the quantize/dequantize pair is missing "
                        f"or misplaced"))
    if cfg.payload_dtype is not None:
        for site in graph.sites():
            if site.op in DOT_PRIMITIVES and wire in site.in_dtypes:
                out.append((site.describe(),
                            f"dot-like op consumes the {wire} wire dtype "
                            f"directly — the payload must be dequantized "
                            f"between the exchange and the grouped "
                            f"matmul (f32 accumulation)"))
    return out


@register("no-recompute-backward", "error", ("ops",))
def _no_recompute_backward(graph: OpGraph) -> List:
    """The forward grouped kernel (``grouped_matmul``) in the backward of
    a grouped-path GRADIENT graph.  The grouped matmul's backward
    (``kernels/grouped_ffn._GroupedMatmul``, PR 3's custom VJP) runs the
    dlhs and drhs kernels (``grouped_matmul_t``, ``grouped_drhs``) off
    the saved operands; the forward kernel in phase ``bwd`` is the
    forward run again (a checkpoint region, a re-derived product).
    Applies with ``expect_no_recompute`` set, or with ``direction=
    "grad"`` under a grouped config — not under ``remat`` or ``fsdp``,
    whose block recompute is deliberate (ZeRO-3 recomputes each block).
    """
    ctx = graph.context
    cfg = ctx.get("cfg")
    deliberate = ctx.get("remat") not in (None, "none") or ctx.get("fsdp")
    applies = bool(ctx.get("expect_no_recompute")) or (
        ctx.get("direction") == "grad" and cfg is not None
        and cfg.dispatch == "grouped" and not deliberate)
    if not applies:
        return []
    return [(site.describe(),
             "grouped_matmul in the backward — the grouped VJP must run "
             "the dlhs/drhs kernels off the saved operands, not re-run "
             "the forward kernel")
            for site in graph.find("grouped_matmul", "bwd")]


@register("dtype-leak", "error", ("ops",))
def _dtype_leak(graph: OpGraph) -> List:
    """Mixed float operand dtypes on a dot-like op (``aten.mm``, ``bmm``,
    ``addmm``, ``baddbmm``, ``_grouped_mm``) or grouped kernel call
    (``grouped_matmul``, ``grouped_matmul_t``, ``grouped_drhs``).  In the
    reference ``lax`` took an f32 cotangent against a bf16 operand
    silently (PR 4).  aten refuses most mixed products itself, and the
    grouped wrappers refuse mixed operands — but a call is recorded
    before its wrapper checks it, so the rule names the leak where the
    program made it.  Integral operands (offsets, indices) are exempt;
    f32 accumulation inside a kernel is intended.
    """
    out = []
    for site in graph.sites():
        if site.op not in DOT_PRIMITIVES:
            continue
        float_dts = {dt for dt in site.in_dtypes if _is_float(dt)}
        if len(float_dts) > 1:
            out.append((site.describe(),
                        f"{site.op} mixes float operand dtypes "
                        f"{sorted(float_dts)} — insert an explicit cast "
                        f"(f32 accumulation belongs inside the kernel or "
                        f"in an output cast, not in a widened operand)"))
    return out


# ---------------------------------------------------------------------------
# shipped rules — probe side (runtime evidence, no graph)
# ---------------------------------------------------------------------------

@register("donation-alias", "error", ("probe",))
def _donation_alias(graph: ProbeGraph) -> List:
    """Two leaves of a state tree share one storage (see
    ``training.train_step.donation_alias_pairs``, the single source of
    the aliasing check).  The port donates nothing; through an alias an
    in-place write (a decode step's static buffers, ``put_slot``, a
    restore) changes two leaves.  Context: ``donated`` = the tree (e.g.
    a ``TrainState``)."""
    from repro_torch.training.train_step import donation_alias_pairs

    donated = graph.context.get("donated")
    if donated is None:
        return []
    return [(f"{a} ~ {b}",
             f"state leaves {a} and {b} share storage — an in-place write "
             f"to one changes the other; build distinct tensors")
            for a, b in donation_alias_pairs(donated)]


@register("retrace-budget", "error", ("probe",))
def _retrace_budget(graph: ProbeGraph) -> List:
    """A serving step-cache key built (captured, on the card) more than
    ``budget`` times (default 1).  Context: ``trace_counts`` (the
    ``serving.engine.trace_counts`` Counter, or any mapping key→count)
    and optional ``budget``.  More than one build per key is a cache key
    that does not find its cached step."""
    from repro_torch.serving.engine import trace_budget_report

    counts = graph.context.get("trace_counts")
    if counts is None:
        return []
    budget = int(graph.context.get("budget", 1))
    return [(str(key),
             f"step-cache key built {n}x (budget {budget}) — a cache miss "
             f"on a repeated shape; check the key covers every knob that "
             f"changed")
            for key, n in trace_budget_report(budget, counts).items()]


@register("config-invalid", "error", ("probe",))
def _config_invalid(graph: ProbeGraph) -> List:
    """A config × mesh combination the port's validators reject
    (``moe.validate_dispatch_config``, ``engine.validate_decode_config``).
    The lint CLI turns the ``ValueError`` into this finding, so a bad
    overlap bound passed via ``--config`` yields a report entry and a
    nonzero exit, not a traceback.  Context: ``config_error`` = the
    validator's message, ``label`` = the cell name."""
    err = graph.context.get("config_error")
    if not err:
        return []
    return [(str(graph.context.get("label", "<config>")), str(err))]
