"""Config-matrix lint CLI — the port of ``repro/analysis/lint.py``.

  PYTHONPATH=src python -m repro_torch.analysis.lint --device cpu
  PYTHONPATH=src python -m repro_torch.analysis.lint --config NAME
  PYTHONPATH=src python -m repro_torch.analysis.lint --json out.json
  PYTHONPATH=src python -m repro_torch.analysis.lint --list

Runs the reference's dispatch config matrix — sort/grouped × {1-rank,
EP4, TP2, EP2×TP2} × flat/hier × overlap P ∈ {1, 2, 4}, one fully
auto-tuned cell per mesh (``grouped/<mesh>/auto/Pauto``), the
quantized-wire cells (a fifth ``/<payload_dtype>`` component) and the
serving step-build cells (``decode/<mesh>/<dispatch>/P<n>``) — through
``moe.sharded_moe_apply``, records each cell's forward (and, grouped
cells, its gradient) as an op graph (``analysis.trace_graph``) and runs
every registered op-graph rule over it; then the probe rules (aliased
leaves of a real ``init_train_state``, the serving step cache over two
identical ``generate`` calls).

The meshes: ``r1`` runs in this process (``make_smoke_mesh((1, 1))`` is
None); ``ep4`` is 1x4, ``tp2`` 2x1 with expert TP over ``data``,
``ep2tp2`` 2x2 with expert TP.  Each of those meshes' cells runs inside
ONE ``launch/mesh.spawn`` of its world over gloo (:func:`lint_mesh`;
the rank body :func:`mesh_rank`).  Every rank must find the same — the
padding of a rank's tokens changes its shapes, so the findings are
compared, not the sites — or the run fails naming the rank that
differed; rank 0's findings go into the report.  A config × mesh
combination the validators reject is a ``config-invalid`` FINDING, found
in this process before any rank starts, never a traceback.

The device is ``cuda`` unless ``--device cpu`` is given; without a GPU
the CLI raises (``repro_torch.resolve_device``).  On the card a cell's
forward config sets ``use_pallas_gate=True`` (the port has no layer
without its kernels there; the flag changes no exchange).

Report: ``LINT_moe_torch.json`` at the repo root (or ``--json PATH``),
``{schema, rules, matrix, findings[{rule, level, location, message,
config}], summary}`` as the reference's ``LINT_moe.json``; exit 1 on
error-level findings.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import pathlib
import sys
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

JSON_PATH = pathlib.Path(__file__).resolve().parents[3] / "LINT_moe_torch.json"
SCHEMA = "lint_moe_torch/v1"

# one token block shaped (4, 16, D): 64 tokens, cut over every rank by
# moe.rank_tokens — per-rank counts below derive from this
TOKENS = (4, 16)
D_MODEL = 32
D_FF = 64
E = 8

# mesh key → ((data, model), expert-TP axis)
MESHES: Dict[str, Tuple[Tuple[int, int], Optional[str]]] = {
    "r1":     ((1, 1), None),
    "ep4":    ((1, 4), None),
    "tp2":    ((2, 1), "data"),
    "ep2tp2": ((2, 2), "data"),
}
A2A = {"flat": ("flat", 1), "hier": ("hierarchical", 2),
       "auto": ("auto", 1)}


def _model_size(key: str) -> int:
    return MESHES[key][0][1]


def _world(key: str) -> int:
    D, M = MESHES[key][0]
    return D * M


def _tokens_per_shard(key: str) -> int:
    total, n = TOKENS[0] * TOKENS[1], _world(key)
    return (total + (-total) % n) // n


class _MeshShape(NamedTuple):
    """A mesh's shape alone: all ``engine.validate_decode_config`` reads
    of a mesh, so a decode cell validates without ranks."""
    shape: Dict[str, int]
    world: int


def matrix_cells() -> List[str]:
    """The standard config matrix, as cell names (the reference's)."""
    cells = []
    for mesh_key in MESHES:
        a2as = ("flat", "hier") if _model_size(mesh_key) > 1 else ("flat",)
        for a2a in a2as:
            cells.append(f"sort/{mesh_key}/{a2a}/P1")
            for P in (1, 2, 4):
                cells.append(f"grouped/{mesh_key}/{a2a}/P{P}")
        # fully auto-tuned cell: every grouped knob a sentinel, resolved
        # by core/tuning.py — linted by tuned-plan-consistency
        cells.append(f"grouped/{mesh_key}/auto/Pauto")
    # quantized exchange-wire cells (payload-dtype rule): int8 on the
    # flat and overlapped EP paths + the EP×TP mesh, one fp8 witness
    cells += ["grouped/ep4/flat/P1/int8", "grouped/ep4/flat/P2/int8",
              "grouped/ep4/hier/P1/float8_e4m3fn",
              "grouped/ep2tp2/flat/P2/int8"]
    # serving step-BUILD validation cells (engine.validate_decode_config)
    cells += ["decode/r1/grouped/P1", "decode/ep4/grouped/P1",
              "decode/ep4/grouped/Pauto", "decode/ep4/grouped/P1/int8"]
    return cells


def parse_cell(name: str) -> Dict:
    """``dispatch/mesh/a2a/P<n>[/payload_dtype]`` or
    ``decode/mesh/dispatch/P<n>[/payload_dtype]`` → spec dict.  Unknown
    vocabulary raises ValueError naming the options; a VALID name with an
    invalid config combination (P that does not divide the bound) parses
    fine and surfaces as a config-invalid finding from the validators."""
    from repro_torch.core.config import DISPATCH_MODES, PAYLOAD_DTYPES

    parts = name.split("/")
    err = (f"bad lint cell {name!r}: expected "
           f"dispatch/mesh/a2a/P<n>[/payload_dtype] (dispatch in "
           f"{DISPATCH_MODES}, mesh in {tuple(MESHES)}, a2a in "
           f"{tuple(A2A)}, payload_dtype in {PAYLOAD_DTYPES}) or "
           f"decode/mesh/dispatch/P<n>[/payload_dtype]")
    payload = None
    if len(parts) == 5:
        payload = parts[4]
        if payload not in PAYLOAD_DTYPES:
            raise ValueError(err)
        parts = parts[:4]
    if len(parts) != 4:
        raise ValueError(err)
    if parts[0] == "decode":
        _, mesh_key, dispatch, p = parts
        a2a = "flat"
    else:
        dispatch, mesh_key, a2a, p = parts
    if (dispatch not in DISPATCH_MODES or mesh_key not in MESHES
            or a2a not in A2A or not p.startswith("P")):
        raise ValueError(err)
    if p == "Pauto":
        P = "auto"
    else:
        try:
            P = int(p[1:])
        except ValueError:
            raise ValueError(err)
    return {"name": name, "decode": parts[0] == "decode",
            "dispatch": dispatch, "mesh": mesh_key, "a2a": a2a, "P": P,
            "payload": payload}


def _cell_cfg(spec: Dict, *, use_pallas: bool = False):
    from repro_torch.core.config import MoEConfig
    a2a, inner = A2A[spec["a2a"]]
    kw = {}
    if spec["a2a"] == "auto":
        # the fully auto-tuned cell carries every sentinel the tuner owns
        kw.update(grouped_block_m="auto", grouped_ep_bound_factor="auto")
    return MoEConfig(num_experts=E, dispatch=spec["dispatch"], gate="topk",
                     top_k=2, capacity_factor=8.0, a2a=a2a, a2a_inner=inner,
                     overlap_chunks=spec["P"], use_pallas_gate=use_pallas,
                     payload_dtype=spec.get("payload"), **kw)


def _decode_error(spec: Dict, mesh=None) -> Optional[str]:
    """The serving step-build validation of a decode cell: the cell's
    dispatch / overlap through ``engine.serve_config`` and
    ``engine.validate_decode_config`` (which folds in
    ``moe.validate_dispatch_config`` at the decode batch's tokens a
    rank), on ``mesh`` or, without one, the cell mesh's shape."""
    from repro_torch import configs
    from repro_torch.serving import engine

    if mesh is None and spec["mesh"] != "r1":
        (D, M), _ = MESHES[spec["mesh"]]
        mesh = _MeshShape({"data": D, "model": M}, D * M)
    base = configs.smoke_config("dbrx-132b")
    cfg = base.replace(moe=dataclasses.replace(
        base.moe, dispatch="grouped", overlap_chunks=spec["P"]))
    try:
        cfg = engine.serve_config(cfg, dispatch=spec["dispatch"],
                                  payload_dtype=spec.get("payload"))
        engine.validate_decode_config(cfg, 4, cache_len=32, mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


def config_error(name: str, mesh=None) -> Optional[str]:
    """The validators' message for cell ``name``, or None when it can
    run — the same checks at the same static sizes the layer and the
    serving step apply (no rank needed)."""
    import torch

    from repro_torch.core import moe

    spec = parse_cell(name)
    if spec["decode"]:
        return _decode_error(spec, mesh)
    try:
        moe.validate_dispatch_config(
            _cell_cfg(spec), model_size=_model_size(spec["mesh"]),
            tokens_per_shard=_tokens_per_shard(spec["mesh"]),
            d_model=D_MODEL, dtype=torch.bfloat16)
    except ValueError as e:
        return str(e)
    return None


def _inputs(spec: Dict, mesh, dev):
    """The rank's (params, tokens, valid): every rank draws the same
    global weights and tokens from seed 0 on ``dev`` and keeps its E/M
    experts (under expert TP their f-slice, data index ``di`` of D the
    slice ``[di·f/D, (di+1)·f/D)``) and its block of the tokens."""
    import torch

    from repro_torch import draw
    from repro_torch.core import moe

    (D, M), tp = MESHES[spec["mesh"]]
    m = 0 if mesh is None else mesh.model_index
    di = 0 if mesh is None else mesh.data_index
    n = E // M

    def cut(name, t):
        t = t[m * n:(m + 1) * n]
        if tp is not None and D > 1:
            f = t.shape[1 if name == "w_out" else 2] // D
            s = slice(di * f, (di + 1) * f)
            t = t[:, s] if name == "w_out" else t[..., s]
        return t.contiguous()

    gen = torch.Generator(device=dev).manual_seed(0)
    params = moe.init_moe_params(gen, _cell_cfg(spec), D_MODEL, D_FF, E,
                                 act="swiglu", dtype=torch.bfloat16,
                                 device=dev, cut=cut)
    x = draw(gen, (*TOKENS, D_MODEL), 1.0, device=dev, dtype=torch.bfloat16)
    xl, valid, _, _ = moe.rank_tokens(mesh, x)
    return params, xl, valid


def lint_cell(name: str, rules=None, *, mesh=None, device="cpu",
              graphs: Optional[Dict[str, Any]] = None) -> List:
    """Lint one matrix cell on this rank: record its forward (and,
    grouped cells, its gradient) graph and run the registered op-graph
    rules; a validator rejection becomes a ``config-invalid`` finding.
    ``mesh``: this rank's mesh of the cell's shape (None for ``r1``; a
    decode cell then validates against the shape alone).  ``graphs``
    (a dict) receives the recorded graphs by label (``name``,
    ``name + ":grad"``)."""
    import torch

    from repro_torch import analysis, resolve_device
    from repro_torch.core import moe

    spec = parse_cell(name)
    err = config_error(name, mesh)
    if err is not None:
        return analysis.lint_probe(config_error=err, label=name)
    if spec["decode"]:
        return []
    (D, M), tp = MESHES[spec["mesh"]]
    if (mesh is None) != (D * M == 1) or (
            mesh is not None and (mesh.shape["data"], mesh.shape["model"])
            != (D, M)):
        raise ValueError(f"lint cell {name!r} runs on a {D}x{M} mesh of "
                         f"ranks (None for 1x1), got "
                         f"{None if mesh is None else mesh.describe()}")
    dev = resolve_device(device)
    params, xl, valid = _inputs(spec, mesh, dev)
    cfg = _cell_cfg(spec, use_pallas=dev.type == "cuda")
    ctx = {"cfg": cfg, "model_size": M, "tokens_per_shard": xl.shape[0],
           "d_model": D_MODEL, "dtype": torch.bfloat16, "label": name,
           "direction": "fwd"}

    def fwd(p, v):
        return moe.sharded_moe_apply(mesh, cfg, p, v, num_experts=E,
                                     act="swiglu", valid=valid,
                                     expert_tp_axis=tp)

    g = analysis.trace_graph(fwd, params, xl, context=ctx)
    found = analysis.lint_ops(g, rules=rules)
    if graphs is not None:
        graphs[name] = g
    if spec["dispatch"] == "grouped":
        # the gradient graph through the kernels' autograd Functions: the
        # no-recompute-backward invariant lives here
        gcfg = _cell_cfg(spec, use_pallas=True)

        def loss(p, v):
            y, aux, _ = moe.sharded_moe_apply(
                mesh, gcfg, p, v, num_experts=E, act="swiglu", valid=valid,
                expert_tp_axis=tp)
            return (y.float() ** 2).sum() + aux

        gp = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        gctx = dict(ctx, cfg=gcfg, direction="grad", label=name + ":grad")
        gg = analysis.trace_graph(loss, gp, xl, context=gctx, grad=True)
        found += analysis.lint_ops(gg, rules=rules)
        if graphs is not None:
            graphs[name + ":grad"] = gg
    return found


def cell_counts(name: str, g) -> Dict[str, int]:
    """A forward graph's AllToAll count and payload-window count (the
    resolved plan's ``(M, B/P, d)`` windows), for holding them against
    the reference's jaxpr counts."""
    from repro_torch.analysis.rules import payload_sites
    from repro_torch.core import capacity, tuning

    spec = parse_cell(name)
    M, T = _model_size(spec["mesh"]), g.context["tokens_per_shard"]
    cfg = tuning.resolve_moe_config(g.context["cfg"], model_size=M,
                                    tokens_per_shard=T, d_model=D_MODEL,
                                    dtype=g.context["dtype"])
    B = capacity.grouped_segment_bound(cfg, T, M)
    P = cfg.overlap_chunks
    return {"all_to_all": g.count("all_to_all", "fwd"),
            "payload": len(payload_sites(g, M, B // P, D_MODEL))
            if B % P == 0 else 0}


def _target(name: str):
    """``module:function`` → the function (importable by name)."""
    mod, _, fn = name.partition(":")
    return getattr(importlib.import_module(mod), fn)


def mesh_rank(rank: int, mesh_key: str, cells: Sequence[str], rules, device,
              jobs: Sequence[Tuple[str, str, tuple]] = (),
              keep: Sequence[str] = ()) -> Dict[str, Any]:
    """The rank body of :func:`lint_mesh`: this rank's mesh of
    ``mesh_key``'s shape, every cell of ``cells`` linted on it
    (:func:`lint_cell`), each forward's counts (:func:`cell_counts`),
    the graphs of the cells in ``keep`` (rank 0 only) and, after the
    cells, each job ``(key, "module:function", args)`` called as
    ``function(mesh, *args)`` — a caller's own work in the same ranks
    (the tests share this spawn)."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(MESHES[mesh_key][0], device=device)
    findings, counts, graphs = {}, {}, {}
    for cell in cells:
        got: Dict[str, Any] = {}
        findings[cell] = [f.as_dict() for f in lint_cell(
            cell, rules, mesh=mesh, device=device, graphs=got)]
        if cell in got:
            counts[cell] = cell_counts(cell, got[cell])
        if rank == 0:
            graphs.update({k: v for k, v in got.items()
                           if k.split(":")[0] in keep})
    return {"findings": findings, "counts": counts, "graphs": graphs,
            "jobs": {key: _target(fn)(mesh, *args)
                     for key, fn, args in jobs}}


def check_ranks_agree(mesh_key: str, cells: Sequence[str],
                      ranks: Sequence[Dict[str, Any]]) -> None:
    """Raise ``RuntimeError`` naming the first rank whose findings on a
    cell differ from rank 0's."""
    base = ranks[0]["findings"]
    for r, out in enumerate(ranks[1:], start=1):
        for cell in cells:
            if out["findings"][cell] != base[cell]:
                raise RuntimeError(
                    f"lint: rank {r} of mesh {mesh_key} found "
                    f"{out['findings'][cell]} on {cell}, rank 0 found "
                    f"{base[cell]} — every rank must find the same")


def lint_mesh(mesh_key: str, cells: Sequence[str], rules=None,
              device: str = "cpu", *, jobs: Sequence = (),
              keep: Sequence[str] = (), threads: Optional[int] = 1
              ) -> List[Dict[str, Any]]:
    """Lint ``cells`` (all of mesh ``mesh_key``) in ONE spawn of its
    world over gloo; every rank's :func:`mesh_rank` result, in rank
    order, once every rank found what rank 0 found
    (:func:`check_ranks_agree`)."""
    from repro_torch.launch.mesh import spawn

    ranks = spawn(mesh_rank, _world(mesh_key), backend="gloo",
                  threads=threads, args=(mesh_key, list(cells), rules,
                                         str(device), list(jobs), list(keep)))
    check_ranks_agree(mesh_key, cells, ranks)
    return ranks


def lint_cells(cells: Sequence[str], rules=None, device="cpu", *,
               jobs: Optional[Dict[str, Sequence]] = None,
               keep: Sequence[str] = ()
               ) -> Tuple[Dict[str, List], Dict[str, List[Dict[str, Any]]]]:
    """Lint ``cells`` as the CLI does: the validators in this process
    first (a rejected cell's ``config-invalid`` finding needs no rank),
    then the ``r1`` cells here and each other mesh's cells in one spawn
    of its ranks (:func:`lint_mesh`, with ``jobs[mesh_key]`` and
    ``keep``; the meshes' spawns run at once).  Returns ``(findings by
    cell, every spawned mesh's ranks' results by mesh key)``; a rank's
    findings are rank 0's."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.analysis.rules import Finding

    by_cell: Dict[str, List] = {}
    groups: Dict[str, List[str]] = {}
    for cell in cells:
        spec = parse_cell(cell)
        if config_error(cell) is not None or spec["mesh"] == "r1":
            by_cell[cell] = lint_cell(cell, rules, device=device)
        else:
            groups.setdefault(spec["mesh"], []).append(cell)
    with ThreadPoolExecutor(max(len(groups), 1)) as pool:
        running = {k: pool.submit(lint_mesh, k, group, rules, device,
                                  jobs=(jobs or {}).get(k, ()), keep=keep)
                   for k, group in groups.items()}
        meshes = {k: f.result() for k, f in running.items()}
    for mesh_key, group in groups.items():
        for cell in group:
            by_cell[cell] = [Finding(**f) for f in
                             meshes[mesh_key][0]["findings"][cell]]
    return {cell: by_cell[cell] for cell in cells}, meshes


def lint_probes(device="cpu", arch: str = "dbrx-132b", smoke: bool = True,
                report: Optional[Dict[str, Any]] = None) -> List:
    """Runtime-evidence probes: aliased leaves of a real
    ``init_train_state`` (``arch``'s smoke config, or its published
    config without ``smoke``, in f32), and the serving step cache across
    two identical ``generate`` calls on one device (each key built — on
    the card captured — once).  ``report`` (a dict) receives ``params``,
    the train state's parameter count, and ``builds``: ``(kind, graph,
    builds)`` of every step-cache key, ``graph`` whether a decode key's
    step is a captured CUDA graph (None for a prefill)."""
    import torch

    from repro_torch import analysis, configs, resolve_device, tree
    from repro_torch.core.config import TrainConfig
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import engine
    from repro_torch.training.train_step import init_train_state

    dev = resolve_device(device)
    cfg = (configs.smoke_config(arch) if smoke
           else configs.get_config(arch)).replace(dtype="float32")
    state = init_train_state(cfg, TrainConfig(), device=dev)
    findings = analysis.lint_probe(donated=state, label="probe/donation")
    if report is not None:
        report["params"] = sum(t.numel() for t in tree.leaves(state.params))
    del state
    model = Transformer(cfg, device=dev, seed=0)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    engine.clear_step_cache()
    for _ in range(2):   # identical shapes: every key must build once
        engine.generate(model, prompt, steps=3, dispatch="grouped")
    findings += analysis.lint_probe(trace_counts=dict(engine.trace_counts),
                                    label="probe/retrace")
    if report is not None:
        # a decode key carries its graph flag after (kind, cfg, model,
        # cache_len, batch, long_context): engine.build_decode
        report["builds"] = [(k[0], k[6] if k[0] == "decode" else None,
                             int(n)) for k, n in engine.trace_counts.items()]
    engine.clear_step_cache(model)
    return findings


def write_report(path: pathlib.Path, cells: List[str], findings: List,
                 rules_run: List[str]) -> Dict:
    from repro_torch.analysis.rules import REGISTRY
    summary = {"error": 0, "warn": 0, "info": 0}
    for f in findings:
        summary[f.level] = summary.get(f.level, 0) + 1
    report = {
        "schema": SCHEMA,
        "rules": {n: {"level": REGISTRY[n].level,
                      "doc": (REGISTRY[n].doc or "").strip()
                      .split("\n")[0].strip()}
                  for n in sorted(rules_run)},
        "matrix": cells,
        "findings": [f.as_dict() for f in findings],
        "summary": dict(summary, cells=len(cells)),
    }
    path.write_text(json.dumps(report, indent=2) + "\n")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="graph-invariant lint over the MoE dispatch config "
                    "matrix; exit 1 on error-level findings")
    ap.add_argument("--config", default=None, metavar="NAME",
                    help="lint ONE cell (e.g. grouped/ep4/hier/P2 or "
                         "decode/ep4/grouped/P5); default: full matrix")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help=f"report path (default {JSON_PATH.name} at the "
                         f"repo root)")
    ap.add_argument("--rules", default=None,
                    help="comma list restricting which rules run")
    ap.add_argument("--no-probes", action="store_true",
                    help="skip the runtime probes (aliasing, step cache)")
    ap.add_argument("--list", action="store_true",
                    help="print matrix cells and registered rules")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the cells and probes run (default cuda; "
                         "without a GPU only --device cpu runs)")
    args = ap.parse_args(argv)

    from repro_torch import analysis, resolve_device

    rules = args.rules.split(",") if args.rules else None
    if rules:
        try:
            analysis.rules_for("ops", rules)
        except ValueError as e:
            ap.error(str(e))
    if args.list:
        for c in matrix_cells():
            print(c)
        for name, rule in sorted(analysis.REGISTRY.items()):
            print(f"rule {name} [{rule.level}] kinds={','.join(rule.kinds)}")
        return 0
    if args.config:
        try:
            cells = [parse_cell(args.config)["name"]]
        except ValueError as e:
            ap.error(str(e))
    else:
        cells = matrix_cells()
    device = str(resolve_device(args.device))

    def say(line):
        print(line)
        sys.stdout.flush()

    by_cell, _ = lint_cells(cells, rules, device)
    findings = []
    for cell, found in by_cell.items():
        say(f"# {cell}: "
            f"{'clean' if not found else f'{len(found)} finding(s)'}")
        for f in found:
            say(f"#   [{f.level}] {f.rule} @ {f.location}: {f.message}")
        findings += found
    if not args.config and not args.no_probes:
        probe_findings = lint_probes(device)
        say(f"# probes: "
            f"{'clean' if not probe_findings else len(probe_findings)}")
        findings += probe_findings

    rules_run = rules if rules is not None else sorted(analysis.REGISTRY)
    path = pathlib.Path(args.json) if args.json else JSON_PATH
    report = write_report(path, cells, findings, rules_run)
    n_err = report["summary"]["error"]
    say(f"# lint: {len(cells)} cells, {len(findings)} finding(s), "
        f"{n_err} error(s) -> {path}")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
