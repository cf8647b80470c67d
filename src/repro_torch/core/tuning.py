"""Auto-tuned dispatch plans: the ``"auto"`` MoE knobs resolved from the
α–β cost model — the port of ``repro/core/tuning.py``.

``MoEConfig`` sentinels (``"auto"`` on ``a2a``, ``overlap_chunks``,
``grouped_block_m``, ``grouped_ep_bound_factor``, ``payload_dtype``)
become a frozen :class:`TunedPlan` per ``(cfg, model size, static token
count, width, dtype)`` cell, scored with ``alltoall.cost_flat`` /
``cost_hierarchical`` / ``cost_pipelined`` over a fabric: a named
``LinkSpec`` pair of ``alltoall.FABRICS`` (``pcie_eth100``, the default),
or a measure-once calibration over the mesh's model group
(:func:`calibrate_fabric`, persisted to ``TUNE_moe_torch.json`` at the root
of the checkout, listed in ``.gitignore``).

Contract, as in the reference: explicit values are honored verbatim (a
config with no ``"auto"`` comes back as the same object); resolution is
deterministic given (config, shape, fabric, compute rate) — pure
arithmetic, so every rank resolves the same plan; the tuner never changes
numerics (``grouped_ep_bound_factor`` resolves to None, dropless).

The overlap choice weighs the exchange against an estimate of the expert
FFN's time at ``COMPUTE_FLOPS``: the H100 SXM's dense bf16 peak (NVIDIA's
data sheet).  ``set_tuning(flops=)`` replaces it (the tests set the
reference's own constant to compare resolutions).

On one device there is no exchange to score: ``d_model`` and ``dtype``
may be omitted at ``model_size=1``.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import alltoall, capacity
from repro_torch.core.alltoall import LinkSpec
from repro_torch.core.config import AUTO, MoEConfig

TUNED_KNOBS = ("a2a", "overlap_chunks", "grouped_block_m",
               "grouped_ep_bound_factor", "payload_dtype")
TUNE_MODES = ("auto", "off", "calibrate")

# payload_dtype="auto" quantizes the wire to int8 only when the α–β model
# predicts at least this relative saving on the dispatch exchange; fp8 is
# never auto-picked (the same 1-byte wire, less accurate).
QUANT_MIN_SAVING = 0.15

# overlap_chunks candidate ladder (filtered to divisors of the bound)
OVERLAP_LADDER = (1, 2, 4, 8)

# the reference kernel's default row block (repro/kernels/grouped_ffn.py)
DEFAULT_BLOCK_M = 128

# dense bf16 peak of one H100 SXM (NVIDIA's data sheet), the compute rate
# the overlap choice weighs the exchange against
COMPUTE_FLOPS = 989e12

# measure-once calibration file (machine-local, not committed)
TUNE_SCHEMA = "tune_moe_torch/v1"
TUNE_PATH = pathlib.Path(__file__).resolve().parents[3] / "TUNE_moe_torch.json"


def has_auto_knobs(cfg: MoEConfig) -> bool:
    """True iff any tuner-owned knob carries the ``"auto"`` sentinel."""
    return any(getattr(cfg, k) == AUTO for k in TUNED_KNOBS)


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """One resolved cell: the knob values and the α–β costs they were
    chosen on (seconds of one dispatch exchange; the serial and the
    overlapped layer times)."""
    a2a: str
    a2a_inner: int
    overlap_chunks: int
    grouped_block_m: Optional[int]
    grouped_ep_bound_factor: Optional[float]
    payload_dtype: Optional[str]
    fabric: str
    payload_bytes: int
    cost_flat: float
    cost_chosen: float
    cost_serial: float
    cost_overlapped: float


# ---------------------------------------------------------------------------
# process-wide tuning state (set from the CLI; tests save and restore it)
# ---------------------------------------------------------------------------

_MODE: str = "auto"
_FABRIC: Tuple[str, Tuple[LinkSpec, LinkSpec]] = (
    "pcie_eth100", alltoall.FABRICS["pcie_eth100"])
_FLOPS: float = COMPUTE_FLOPS

_PLAN_CACHE: Dict[tuple, TunedPlan] = {}
_CFG_CACHE: Dict[tuple, MoEConfig] = {}


def set_tuning(mode: Optional[str] = None, fabric=None,
               flops: Optional[float] = None):
    """Set the process tuning mode, default fabric and/or compute rate.
    Returns the previous ``(mode, fabric, flops)`` so tests can restore
    it (``set_tuning(*prev)``).  ``fabric`` is ``(name, (fast, slow))``
    or a name of ``alltoall.FABRICS``."""
    global _MODE, _FABRIC, _FLOPS
    prev = (_MODE, _FABRIC, _FLOPS)
    if mode is not None:
        if mode not in ("auto", "off"):
            raise ValueError(
                f"tuning mode must be 'auto' or 'off' (calibrate is a CLI "
                f"action, not a steady state), got {mode!r}")
        _MODE = mode
    if fabric is not None:
        _FABRIC = _coerce_fabric(fabric)
    if flops is not None:
        _FLOPS = float(flops)
    return prev


def get_tuning() -> Tuple[str, Tuple[str, Tuple[LinkSpec, LinkSpec]]]:
    return _MODE, _FABRIC


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()
    _CFG_CACHE.clear()


def _coerce_fabric(fabric) -> Tuple[str, Tuple[LinkSpec, LinkSpec]]:
    if isinstance(fabric, str):
        if fabric not in alltoall.FABRICS:
            raise ValueError(
                f"unknown fabric {fabric!r}; valid fabrics: "
                f"{tuple(alltoall.FABRICS)}")
        return fabric, alltoall.FABRICS[fabric]
    name, (fast, slow) = fabric
    return str(name), (fast, slow)


# ---------------------------------------------------------------------------
# the resolver
# ---------------------------------------------------------------------------

def _dtype_bytes(dtype) -> int:
    """Itemsize of the compute dtype the payload crosses at; None is an
    error (an assumed bf16 mis-scores an f32 payload by 2×)."""
    if dtype is None:
        raise ValueError(
            "_dtype_bytes(None): plan resolution needs the concrete "
            "activation dtype (payload bytes scale α–β costs); pass "
            "dtype=x.dtype at the choke point")
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty((), dtype=dtype).element_size()


def _round_up(n: int, align: int = 8) -> int:
    return -(-n // align) * align


def _ffn_seconds(cfg: MoEConfig, rows: int, d_model: int) -> float:
    """Rough expert-FFN time of ``rows`` rows: 3 matmuls of d×f, 2 FLOPs a
    MAC, at the compute rate."""
    f = cfg.d_ff_expert or 4 * d_model
    return rows * d_model * f * 3 * 2 / _FLOPS


def _factoring(model_size: int, inner: int) -> Tuple[int, int]:
    """(N, G) nodes × GPUs: G the fast inner group, N the slow outer."""
    if 1 < inner < model_size and model_size % inner == 0:
        return model_size // inner, inner
    return model_size, 1


def resolve_plan(cfg: MoEConfig, *, model_size: int, tokens_per_shard: int,
                 d_model: Optional[int] = None, dtype=None,
                 fabric=None) -> TunedPlan:
    """Resolve one cell into a frozen :class:`TunedPlan` (deterministic,
    cached); the knobs it emits always pass
    ``moe.validate_dispatch_config``."""
    mode, default_fab = get_tuning()
    fab_name, (fast, slow) = (_coerce_fabric(fabric) if fabric is not None
                              else default_fab)
    if model_size > 1:
        isz = _dtype_bytes(dtype)
        if d_model is None:
            raise ValueError("resolve_plan: model_size > 1 needs d_model")
    else:
        isz = 0 if dtype is None else _dtype_bytes(dtype)
        d_model = d_model or 1
    key = (cfg, model_size, tokens_per_shard, d_model, isz, mode,
           fab_name, fast, slow, _FLOPS)
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        return plan

    # knob 1 — grouped_ep_bound_factor: AUTO → None (never lossy)
    factor = (None if cfg.grouped_ep_bound_factor == AUTO
              else cfg.grouped_ep_bound_factor)
    base = dataclasses.replace(
        cfg, grouped_ep_bound_factor=factor, a2a="flat", a2a_inner=1,
        overlap_chunks=1, grouped_block_m=None)

    T = int(tokens_per_shard)
    grouped = cfg.dispatch == "grouped"
    ep = grouped and model_size > 1
    if ep:
        B = capacity.grouped_segment_bound(base, T, model_size)
        buffer_rows = model_size * B
        payload = model_size * B * d_model * isz
    elif grouped:
        B = capacity.grouped_tp_gather_bound(base, T)
        buffer_rows = B
        payload = 0
    else:
        E = cfg.num_experts
        C = capacity.expert_capacity(base, T, E)
        B = 0
        buffer_rows = E * C
        payload = (E * C * d_model * isz) if model_size > 1 else 0

    # knob 0 — payload_dtype: only the grouped-EP exchange quantizes
    qdt = None if cfg.payload_dtype == AUTO else cfg.payload_dtype
    if cfg.payload_dtype == AUTO and mode != "off" and ep and payload:
        full_c = alltoall.cost_flat(payload, model_size, 1, fast, slow)
        quant_c = alltoall.cost_flat(payload // isz, model_size, 1,
                                     fast, slow)
        if full_c > 0 and (full_c - quant_c) / full_c >= QUANT_MIN_SAVING:
            qdt = "int8"
    if qdt is not None and ep:
        payload = payload // isz     # every wire dtype is 1 byte

    if mode == "off":
        plan = TunedPlan(a2a="flat", a2a_inner=1, overlap_chunks=1,
                         grouped_block_m=None, grouped_ep_bound_factor=factor,
                         payload_dtype=qdt, fabric=fab_name,
                         payload_bytes=payload, cost_flat=0.0,
                         cost_chosen=0.0, cost_serial=0.0,
                         cost_overlapped=0.0)
        _PLAN_CACHE[key] = plan
        return plan

    # knob 2 — a2a mode (+ inner): flat and two-stage scored at the same
    # (N, G) for every factoring; two-stage wins only when strictly cheaper
    flat_cost = (alltoall.cost_flat(payload, model_size, 1, fast, slow)
                 if payload else 0.0)
    a2a_mode, a2a_inner = "flat", 1
    chosen_cost = flat_cost
    if cfg.a2a == AUTO:
        if payload:
            best = None
            for inner in range(2, model_size):
                if model_size % inner:
                    continue
                N, G = model_size // inner, inner
                hc = alltoall.cost_hierarchical(payload, N, G, fast, slow)
                if best is None or hc < best[0]:
                    best = (hc, alltoall.cost_flat(payload, N, G, fast,
                                                   slow), inner)
            if best is not None:
                flat_cost = best[1]
                if best[0] < flat_cost:
                    a2a_mode, a2a_inner = "hierarchical", best[2]
                    chosen_cost = best[0]
                else:
                    chosen_cost = flat_cost
    else:
        a2a_mode, a2a_inner = cfg.a2a, cfg.a2a_inner
        N, G = _factoring(model_size, a2a_inner if a2a_mode == "hierarchical"
                          else 1)
        if payload:
            flat_cost = alltoall.cost_flat(payload, N, G, fast, slow)
            chosen_cost = (alltoall.cost_hierarchical(payload, N, G, fast,
                                                      slow)
                           if G > 1 else flat_cost)
    N, G = _factoring(model_size, a2a_inner if a2a_mode == "hierarchical"
                      else 1)
    cost_fn = alltoall.cost_hierarchical if G > 1 else alltoall.cost_flat

    # knob 3 — overlap_chunks: the divisor ladder's argmin of the
    # pipelined layer time (only the grouped-EP path has an exchange)
    ffn_s = _ffn_seconds(cfg, buffer_rows, d_model) if grouped else 0.0
    serial = 2 * chosen_cost + ffn_s

    def pipe_cost(P: int) -> float:
        if P <= 1:
            return serial
        return alltoall.cost_pipelined(payload, N, G, fast, slow,
                                       n_chunks=P, compute_s=ffn_s,
                                       cost_fn=cost_fn)

    overlap = 1
    if cfg.overlap_chunks == AUTO:
        if ep and payload:
            best = serial
            for P in OVERLAP_LADDER:
                if P > 1 and B % P == 0 and pipe_cost(P) < best:
                    overlap, best = P, pipe_cost(P)
    else:
        overlap = cfg.overlap_chunks
    overlapped = pipe_cost(overlap)

    # knob 4 — grouped_block_m: the row block clamped to one window
    if cfg.grouped_block_m == AUTO:
        if grouped:
            window_rows = buffer_rows // max(overlap, 1)
            block_m = max(8, min(DEFAULT_BLOCK_M, _round_up(window_rows)))
        else:
            block_m = None
    else:
        block_m = cfg.grouped_block_m

    plan = TunedPlan(a2a=a2a_mode, a2a_inner=a2a_inner,
                     overlap_chunks=overlap, grouped_block_m=block_m,
                     grouped_ep_bound_factor=factor,
                     payload_dtype=qdt, fabric=fab_name,
                     payload_bytes=payload, cost_flat=flat_cost,
                     cost_chosen=chosen_cost, cost_serial=serial,
                     cost_overlapped=overlapped)
    _PLAN_CACHE[key] = plan
    return plan


def apply_plan(cfg: MoEConfig, plan: TunedPlan) -> MoEConfig:
    """The concrete config: plan values fill only the ``"auto"`` fields."""
    kw = {}
    if cfg.a2a == AUTO:
        kw["a2a"] = plan.a2a
        kw["a2a_inner"] = plan.a2a_inner
    if cfg.overlap_chunks == AUTO:
        kw["overlap_chunks"] = plan.overlap_chunks
    if cfg.grouped_block_m == AUTO:
        kw["grouped_block_m"] = plan.grouped_block_m
    if cfg.grouped_ep_bound_factor == AUTO:
        kw["grouped_ep_bound_factor"] = plan.grouped_ep_bound_factor
    if cfg.payload_dtype == AUTO:
        kw["payload_dtype"] = plan.payload_dtype
    return dataclasses.replace(cfg, **kw) if kw else cfg


def resolve_moe_config(cfg: MoEConfig, *, model_size: int,
                       tokens_per_shard: int, d_model: Optional[int] = None,
                       dtype=None, fabric=None) -> MoEConfig:
    """``cfg`` with every ``"auto"`` knob resolved for this cell; a config
    with no autos comes back as the same object."""
    if not has_auto_knobs(cfg):
        return cfg
    mode, (fab_name, _) = get_tuning()
    isz = None if dtype is None else _dtype_bytes(dtype)
    key = (cfg, model_size, int(tokens_per_shard), d_model, isz, mode,
           fab_name, fabric, _FLOPS)
    out = _CFG_CACHE.get(key)
    if out is None:
        plan = resolve_plan(cfg, model_size=model_size,
                            tokens_per_shard=tokens_per_shard,
                            d_model=d_model, dtype=dtype, fabric=fabric)
        out = apply_plan(cfg, plan)
        _CFG_CACHE[key] = out
    return out


def describe_resolution(auto_cfg: MoEConfig, resolved: MoEConfig) -> str:
    """What each ``"auto"`` became — appended to validation errors."""
    parts = []
    if auto_cfg.a2a == AUTO:
        parts.append(f"a2a={resolved.a2a!r} (a2a_inner="
                     f"{resolved.a2a_inner})")
    if auto_cfg.overlap_chunks == AUTO:
        parts.append(f"overlap_chunks={resolved.overlap_chunks}")
    if auto_cfg.grouped_block_m == AUTO:
        parts.append(f"grouped_block_m={resolved.grouped_block_m}")
    if auto_cfg.grouped_ep_bound_factor == AUTO:
        parts.append(
            f"grouped_ep_bound_factor={resolved.grouped_ep_bound_factor}")
    if auto_cfg.payload_dtype == AUTO:
        parts.append(f"payload_dtype={resolved.payload_dtype!r}")
    return "auto-tuned: resolved " + ", ".join(parts) if parts else ""


# ---------------------------------------------------------------------------
# measure-once calibration (--tune calibrate)
# ---------------------------------------------------------------------------

def fit_alpha_beta(points) -> LinkSpec:
    """Least-squares fit of ``time = α + β·bytes`` over ``(bytes, s)``
    samples, clamped positive."""
    import numpy as np
    pts = [(float(b), float(t)) for b, t in points]
    if len(pts) < 2:
        raise ValueError(
            f"fit_alpha_beta needs >= 2 (bytes, seconds) samples, got "
            f"{len(pts)}")
    b = np.array([p[0] for p in pts])
    t = np.array([p[1] for p in pts])
    A = np.stack([np.ones_like(b), b], axis=1)
    (alpha, beta), *_ = np.linalg.lstsq(A, t, rcond=None)
    return LinkSpec(alpha=float(max(alpha, 1e-9)),
                    beta=float(max(beta, 1e-15)))


def _card_name() -> Optional[str]:
    """The card's name as ``nvidia-smi`` gives it, or None without one."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and \
        out.stdout.strip() else None


def _measure_a2a(mesh, rows: int, d: int, *, iters: int = 5) -> float:
    """Median wall seconds of one flat AllToAll of (M·rows, d) f32 over the
    model group, the slowest rank's (all-reduced MAX, so every rank fits
    the same points)."""
    import torch.distributed as dist
    M = mesh.shape["model"]
    x = torch.zeros((M, rows, d), dtype=torch.float32, device=mesh.device)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
    alltoall._a2a(x, mesh.model_group)              # warm-up
    sync()
    times = []
    for _ in range(iters):
        dist.barrier(group=mesh.model_group)
        t0 = time.perf_counter()
        alltoall._a2a(x, mesh.model_group)
        sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    t = torch.tensor([times[len(times) // 2]], dtype=torch.float64,
                     device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.model_group)
    return float(t.cpu()[0])


def calibration_label(backend: str, world: int, device_type: str) -> str:
    """The fabric name a calibration carries: what it measured.  Gloo
    ranks on one card exchange through the host, so their fit is host
    staging, never an H100 fabric."""
    if backend == "gloo":
        where = "cpu" if device_type == "cpu" else "card-host-staged"
        return f"calibrated:gloo-{where}-{world}ranks"
    return f"calibrated:{backend}-{world}ranks"


def save_calibration(path, fast: LinkSpec, slow: LinkSpec, points=None, *,
                     label: str, backend: str, world: int,
                     card: Optional[str]) -> None:
    doc = {"schema": TUNE_SCHEMA, "label": label, "backend": backend,
           "world": world, "card": card,
           "fast": {"alpha": fast.alpha, "beta": fast.beta},
           "slow": {"alpha": slow.alpha, "beta": slow.beta},
           "points": [[float(b), float(t)] for b, t in (points or [])]}
    pathlib.Path(path).write_text(json.dumps(doc, indent=2) + "\n")


def load_calibration(path=None, *, backend: Optional[str] = None,
                     world: Optional[int] = None):
    """``(label, (fast, slow))`` from a calibration file, or None when it
    is missing, unreadable, of another schema, carries non-positive
    constants, or was measured over another backend or world size."""
    p = pathlib.Path(path) if path is not None else TUNE_PATH
    try:
        doc = json.loads(p.read_text())
        if doc.get("schema") != TUNE_SCHEMA:
            return None
        if backend is not None and doc.get("backend") != backend:
            return None
        if world is not None and doc.get("world") != world:
            return None
        specs = []
        for level in ("fast", "slow"):
            alpha = float(doc[level]["alpha"])
            beta = float(doc[level]["beta"])
            if alpha <= 0 or beta <= 0:
                return None
            specs.append(LinkSpec(alpha=alpha, beta=beta))
        return str(doc["label"]), (specs[0], specs[1])
    except (OSError, ValueError, KeyError, TypeError):
        return None


def calibrate_fabric(mesh=None, *, path=None, remeasure: bool = False):
    """Measure-once α–β calibration over ``mesh``'s model group: reuse an
    intact calibration file of the same backend and world size, else time
    a few flat AllToAll payloads and fit one level, used as both fast and
    slow (one measured level: the strategy crossovers then come from
    message counts alone).  Rank 0 writes the file.  Without a model axis
    to exchange across, the default pair is saved under its own name.
    Returns ``(label, (fast, slow))``."""
    import torch.distributed as dist
    p = pathlib.Path(path) if path is not None else TUNE_PATH
    if mesh is None or mesh.shape["model"] <= 1:
        name, pair = get_tuning()[1]
        return name, pair
    backend, world = mesh.backend, mesh.world
    if not remeasure:
        loaded = load_calibration(p, backend=backend, world=world)
        if loaded is not None:
            return loaded
    d = 128
    points = [(mesh.shape["model"] * rows * d * 4,
               _measure_a2a(mesh, rows, d)) for rows in (8, 64, 512)]
    spec = fit_alpha_beta(points)
    label = calibration_label(backend, world, mesh.device.type)
    if dist.get_rank() == 0:
        save_calibration(p, spec, spec, points, label=label, backend=backend,
                         world=world, card=(_card_name()
                                            if mesh.device.type == "cuda"
                                            else None))
    return label, (spec, spec)


def configure(mode: str = "auto", fabric=None, *, mesh=None,
              path=None) -> Tuple[str, str]:
    """CLI entry for ``--tune``/``--fabric``; returns ``(mode,
    fabric_name)`` for the launcher's banner."""
    if mode not in TUNE_MODES:
        raise ValueError(
            f"--tune must be one of {TUNE_MODES}, got {mode!r}")
    if mode == "off":
        set_tuning(mode="off", fabric=fabric)
        return "off", get_tuning()[1][0]
    if mode == "calibrate":
        fab = calibrate_fabric(mesh, path=path)
    else:
        fab = fabric
    set_tuning(mode="auto", fabric=fab)
    return mode, get_tuning()[1][0]
