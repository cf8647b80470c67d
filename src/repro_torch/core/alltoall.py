"""Flat and hierarchical AllToAll (paper §3.2, Figs. 5–7) over the model
group of a ``launch/mesh.Mesh`` — the port of ``repro/core/alltoall.py``.

The paper's setting: N nodes × G GPUs, one NIC per node.  A flat AllToAll
moves B/(N·G)-byte messages — latency-bound on the slow link.  HetuMoE
instead (1) exchanges within each node over the fast fabric, (2)
layout-transforms so each node's outbound data is contiguous per
destination node, (3) runs the inter-node AllToAll with G×-aggregated
messages.  The model group factors as ``outer × inner``: ``inner``
consecutive ranks form a node, ``outer`` strided ranks cross nodes
(``Mesh.hierarchical_groups``).  The stage transpose is a copy
(``.transpose(0, 1).contiguous()``), as the reference's ``swapaxes``.

Both forms are functionally identical (a test holds them bitwise); the
win is in message count and size, captured by the α–β model below.

Chunk convention: input ``(M, c, …)`` destination-major (chunk i → model
rank i); output ``(M, c, …)`` source-major — ``lax.all_to_all(tiled=True)``'s.

Every exchange is an equal-split ``all_to_all_single`` of the payload's
bytes (so any dtype crosses any backend), a ``torch.autograd.Function``
whose backward is the inverse exchange (the hierarchical stages in
reverse order).  Nothing reads a count back to the host: the count
matrices travel as device tensors.  ``exchanges`` counts the AllToAll
collectives issued (one per stage); it stands in for the reference's
jaxpr witness ``moe.expected_grouped_a2a_eqns``.

Expert tensor parallelism (decode) runs two more collectives over the
data group: the tiled all-gather (:func:`tp_all_gather`, its backward a
reduce-scatter) and the tiled reduce-scatter (:func:`tp_reduce_scatter`,
its backward an all-gather); ``tp_collectives`` counts them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.config import A2A_MODES

exchanges = 0          # AllToAll collectives issued since the caller reset it


def _a2a(x: torch.Tensor, group, pending: Optional[list] = None
         ) -> torch.Tensor:
    """One equal-split ``all_to_all_single`` over ``group`` along dim 0,
    moving bytes.  With ``pending`` (a list) the call is issued
    ``async_op=True`` and its work appended; the caller waits
    (:func:`wait`) before reading the result."""
    global exchanges
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel():
        work = dist.all_to_all_single(out.view(torch.uint8).reshape(
            x.shape[0], -1), x.view(torch.uint8).reshape(x.shape[0], -1),
            group=group, async_op=pending is not None)
        if pending is not None:
            pending.append(work)
    exchanges += 1
    return out


def wait(pending: List) -> None:
    """Wait for every exchange issued with ``pending``."""
    while pending:
        pending.pop(0).wait()


@dataclasses.dataclass(frozen=True)
class Route:
    """How a payload crosses the model axis: ``groups`` the stages' process
    groups (one for flat; the inner then the outer group for the
    two-stage form), ``outer``/``inner`` the factoring (1, M for flat)."""
    groups: Tuple
    outer: int = 1
    inner: int = 1


def _run(x: torch.Tensor, route: Route, inverse: bool,
         pending: Optional[list] = None) -> torch.Tensor:
    """The forward exchange, or with ``inverse`` its inverse: the outer
    stage first, then the inner one.  ``pending`` (forward only) issues
    the last stage asynchronously."""
    if len(route.groups) == 1:
        return _a2a(x, route.groups[0], pending)
    M, c = x.shape[0], x.shape[1:]
    o, i = route.outer, route.inner
    inner_g, outer_g = route.groups
    if not inverse:
        # [dest_o, dest_i] → [dest_i, dest_o]; stage A over the node
        y = x.reshape(o, i, *c).transpose(0, 1).contiguous()
        y = _a2a(y, inner_g)                     # [src_i, dest_o]
        # the layout transform: per-destination-node data contiguous
        y = y.transpose(0, 1).contiguous()       # [dest_o, src_i]
        y = _a2a(y, outer_g, pending)            # [src_o, src_i]
        return y.reshape(M, *c)
    y = _a2a(x.reshape(o, i, *c), outer_g)       # undo stage B
    y = y.transpose(0, 1).contiguous()           # [src_i, dest_o]
    y = _a2a(y, inner_g)                         # undo stage A
    return y.transpose(0, 1).reshape(M, *c)


class _Exchange(torch.autograd.Function):
    """A payload exchange whose backward is the inverse exchange (run
    synchronously); with ``pending`` the forward's last stage is issued
    asynchronously."""

    @staticmethod
    def forward(ctx, x, route, pending=None):
        ctx.route = route
        return _run(x, route, inverse=False, pending=pending)

    @staticmethod
    def backward(ctx, g):
        return _run(g, ctx.route, inverse=True), None, None


def _route(mesh, mode: str, inner: int, outer: Optional[int] = None
           ) -> Route:
    """Validate ``(mode, inner)`` against the model axis as the reference's
    :func:`all_to_all` does (its ``ValueError``s word for word) and
    return the exchange's route."""
    if mode not in A2A_MODES:
        raise ValueError(
            f"all_to_all: unknown mode {mode!r} (MoEConfig.a2a); valid "
            f"modes: {A2A_MODES}")
    if inner < 1:
        raise ValueError(
            f"all_to_all: inner={inner} (MoEConfig.a2a_inner) must be "
            f">= 1 — 1 degenerates to the flat exchange; 0 or negative "
            f"would silently disable the hierarchical path")
    flat = Route((mesh.model_group,))
    if mode == "flat" or inner == 1:
        return flat
    M = mesh.shape["model"]
    axis_name = "model"
    if M % inner != 0:
        raise ValueError(
            f"hierarchical AllToAll: axis {axis_name!r} has size {M} "
            f"(the expert-parallel model_size), which inner={inner} "
            f"(MoEConfig.a2a_inner) does not divide — pick a2a_inner "
            f"from the divisors of {M}, or use a2a='flat'")
    if outer is None:
        outer = M // inner
    if outer * inner != M:
        raise ValueError(
            f"hierarchical AllToAll: outer={outer} · inner={inner} != "
            f"axis size {M} (axis {axis_name!r})")
    if outer <= 1:
        return flat
    return Route(mesh.hierarchical_groups(inner), outer, inner)


def flat_all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Vanilla AllToAll over ``group`` (a model group; None = the world),
    differentiable."""
    return _Exchange.apply(x, Route((group,)))


def hierarchical_all_to_all(x: torch.Tensor, mesh, *, inner: int,
                            outer: int) -> torch.Tensor:
    """Two-stage AllToAll over the model axis of ``mesh`` (size
    ``outer·inner``): model rank r = o·inner + i; stage A exchanges over
    the destination inner index within each node, the transpose makes
    each node's data for one destination node contiguous, stage B crosses
    nodes with inner×-larger messages."""
    M = outer * inner
    if x.shape[0] != M:
        raise ValueError(f"hierarchical_all_to_all: leading dim "
                         f"{x.shape[0]} != outer·inner = {M}")
    return _Exchange.apply(x, Route(mesh.hierarchical_groups(inner), outer,
                                    inner))


def all_to_all(x: torch.Tensor, mesh, *, mode: str = "flat",
               inner: int = 1, outer: Optional[int] = None,
               pending: Optional[list] = None) -> torch.Tensor:
    """Mode-dispatching entry point used by the MoE layer: the reference's
    checks and their ``ValueError``s, then the flat or two-stage
    exchange over ``mesh``'s model group.  With ``pending`` (a list) the
    last stage is issued ``async_op=True`` and its work appended: the
    overlap pipeline issues a window's exchange before the previous
    window's matmuls and waits (:func:`wait`) at use.  The backward is the
    synchronous inverse exchange."""
    return _Exchange.apply(x, _route(mesh, mode, inner, outer), pending)


def grouped_all_to_all(tokens: torch.Tensor, counts: torch.Tensor, mesh, *,
                       mode: str = "flat", inner: int = 1,
                       pending: Optional[list] = None):
    """Grouped-EP exchange: bounded token segments plus their counts.

    ``tokens`` ``(M, B, d)`` destination-major, ``counts`` ``(M,
    E_local)`` per-(rank, local expert) rows.  Returns the source-major
    ``(recv_tokens, recv_counts)``.  The counts go first and always flat
    (their bytes are noise next to their latency); the payload rides the
    flat or the two-stage exchange.  With ``pending`` the payload's last
    stage is issued asynchronously (:func:`all_to_all`)."""
    recv_counts = _a2a(counts, mesh.model_group)
    return (all_to_all(tokens, mesh, mode=mode, inner=inner,
                       pending=pending), recv_counts)


# ---------------------------------------------------------------------------
# Quantized exchange payloads (MegaScale-MoE): int8/fp8 on the wire with one
# f32 amax scale per leading-axis chunk; the receive side dequantizes.
# ---------------------------------------------------------------------------

# Largest representable magnitude per wire dtype: a chunk's amax maps
# onto it.  int8 uses the symmetric [-127, 127] grid; the fp8 values are
# torch.finfo(dt).max.
PAYLOAD_QMAX = {
    "int8": 127.0,
    "float8_e4m3fn": 448.0,
    "float8_e5m2": 57344.0,
}


def _payload_dtype(payload_dtype: str) -> torch.dtype:
    if payload_dtype not in PAYLOAD_QMAX:
        raise ValueError(
            f"unknown payload dtype {payload_dtype!r} "
            f"(MoEConfig.payload_dtype); valid: {sorted(PAYLOAD_QMAX)}")
    return getattr(torch, payload_dtype)


def quantize_payload(x: torch.Tensor, payload_dtype: str):
    """Per-chunk symmetric quantization of ``(M, …)`` payloads: ``(q,
    scales)``, ``scales`` (M,) f32, an all-zero chunk's scale 1.  int8
    rounds half to even (``torch.round``, as ``jnp.round``)."""
    dt = _payload_dtype(payload_dtype)
    xf = x.float()
    amax = xf.abs().amax(dim=tuple(range(1, x.dim())))
    scales = torch.where(amax > 0, amax / PAYLOAD_QMAX[payload_dtype],
                         torch.ones_like(amax))
    y = xf / scales.reshape(scales.shape + (1,) * (x.dim() - 1))
    if payload_dtype == "int8":
        q = torch.clamp(torch.round(y), -127.0, 127.0).to(dt)
    else:
        q = y.to(dt)
    return q, scales


def dequantize_payload(q: torch.Tensor, scales: torch.Tensor,
                       dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_payload`: widen to f32, scale, then cast
    to ``dtype`` once."""
    s = scales.reshape(scales.shape + (1,) * (q.dim() - 1))
    return (q.float() * s).to(dtype)


def quantized_grouped_all_to_all(tokens: torch.Tensor,
                                 counts: Optional[torch.Tensor], mesh, *,
                                 mode: str = "flat", inner: int = 1,
                                 payload_dtype: str):
    """Quantized :func:`grouped_all_to_all`: the ``(M, B, d)`` window
    crosses at ``payload_dtype``; the per-chunk f32 scales ride the count
    exchange as an extra int32 column (their bits), so the dispatch
    direction issues as many collectives as the unquantized one.  With
    ``counts=None`` (the combine direction) the scales take their own
    flat exchange.  Returns source-major ``(recv_tokens, recv_counts,
    recv_scales)``, the tokens still at the wire dtype."""
    q, scales = quantize_payload(tokens, payload_dtype)
    if counts is not None:
        packed = torch.cat([counts.to(torch.int32),
                            scales.view(torch.int32)[:, None]], dim=1)
        r = _a2a(packed, mesh.model_group)
        recv_counts = r[:, :-1].to(counts.dtype)
        recv_scales = r[:, -1].contiguous().view(torch.float32)
    else:
        recv_counts = None
        recv_scales = _a2a(scales, mesh.model_group)
    recv = _run(q, _route(mesh, mode, inner), inverse=False)
    return recv, recv_counts, recv_scales


class _QuantizedExchange(torch.autograd.Function):
    """quantize → AllToAll → dequantize; the backward sends the cotangent
    through the same low-precision wire (the inverse exchange and a flat
    scales exchange), the forward's scales treated as constants."""

    @staticmethod
    def forward(ctx, tokens, counts, mesh, mode, inner, payload_dtype,
                out_dtype):
        rq, rcounts, rscales = quantized_grouped_all_to_all(
            tokens, counts, mesh, mode=mode, inner=inner,
            payload_dtype=payload_dtype)
        ctx.meta = (mesh, mode, inner, payload_dtype, tokens.dtype)
        recv = dequantize_payload(rq, rscales, out_dtype or tokens.dtype)
        if rcounts is not None:
            ctx.mark_non_differentiable(rcounts)
        return recv, rcounts

    @staticmethod
    def backward(ctx, g, _):
        mesh, mode, inner, payload_dtype, dtype = ctx.meta
        gq, gscales = quantize_payload(g, payload_dtype)
        rgq = _run(gq, _route(mesh, mode, inner), inverse=True)
        rgs = _a2a(gscales, mesh.model_group)
        return (dequantize_payload(rgq, rgs, dtype), None, None, None, None,
                None, None)


def quantized_exchange(tokens: torch.Tensor, counts: Optional[torch.Tensor],
                       mesh, *, mode: str = "flat", inner: int = 1,
                       payload_dtype: str, out_dtype=None):
    """Differentiable quantize → AllToAll → dequantize round trip into
    ``out_dtype`` (default ``tokens.dtype``; the combine direction passes
    f32).  Returns ``(recv, recv_counts)``; ``recv_counts`` is None when
    ``counts`` is."""
    return _QuantizedExchange.apply(tokens, counts, mesh, mode, inner,
                                    payload_dtype, out_dtype)


# ---------------------------------------------------------------------------
# Reductions over a group, with the backward the per-rank loss needs
# ---------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``; the backward passes the cotangent through
    unchanged.  Every rank computes the same global value and back-
    propagates it into its own contribution, and the trainer sums those
    contributions over the ranks afterwards, so the total gradient is
    the reference's."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (None = the world)."""
    return _AllReduceSum.apply(x, group)


# ---------------------------------------------------------------------------
# Expert tensor parallelism: the tiled all-gather and reduce-scatter over the
# data group (the reference's lax.all_gather / psum_scatter, tiled=True)
# ---------------------------------------------------------------------------

tp_collectives = 0     # TP all-gathers and reduce-scatters since the reset


def gather_rows(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every rank's ``x`` of the ``n``-rank ``group`` (None = the world)
    concatenated along dim 0 in group-rank order; the bytes cross (any
    dtype crosses any backend).  Not differentiable."""
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    if x.numel():
        dist.all_gather_into_tensor(out.view(torch.uint8).reshape(-1),
                                    x.view(torch.uint8).reshape(-1),
                                    group=group)
    return out


def _tp_gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """Group rank r's ``x`` as block r of the output along ``dim``."""
    global tp_collectives
    out = gather_rows(x.movedim(dim, 0), group, n)
    tp_collectives += 1
    return out.movedim(0, dim)


def _tp_reduce_scatter(x: torch.Tensor, group, n: int,
                       dim: int) -> torch.Tensor:
    """Block r (of ``n`` along ``dim``) of the sum of every group rank's
    ``x``, to group rank r."""
    global tp_collectives
    xm = x.movedim(dim, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError(f"reduce-scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not divide over {n} ranks")
    out = xm.new_empty((xm.shape[0] // n, *xm.shape[1:]))
    if xm.numel():
        dist.reduce_scatter_tensor(out, xm, group=group)
    tp_collectives += 1
    return out.movedim(0, dim)


class _TPAllGather(torch.autograd.Function):
    """Tiled all-gather; the backward reduce-scatters the cotangent (each
    gathered block's cotangent summed over the ranks that used it)."""

    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.meta = (group, n, dim)
        return _tp_gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _tp_reduce_scatter(g, *ctx.meta), None, None, None


class _TPReduceScatter(torch.autograd.Function):
    """Tiled reduce-scatter; the backward all-gathers the cotangent."""

    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.meta = (group, n, dim)
        return _tp_reduce_scatter(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _tp_gather(g, *ctx.meta), None, None, None


def tp_all_gather(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """Every data rank's ``x`` concatenated along ``dim`` in data-index
    order (the reference's ``lax.all_gather(x, "data", axis=dim,
    tiled=True)``), differentiable; an integer tensor (the count matrices)
    crosses the same way, without a gradient."""
    return _TPAllGather.apply(x, mesh.data_group, mesh.shape["data"], dim)


def tp_reduce_scatter(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """The sum of every data rank's ``x``, cut into ``D`` blocks along
    ``dim``: block ``di`` to the rank of data index ``di`` (the reference's
    ``lax.psum_scatter(x, "data", scatter_dimension=dim, tiled=True)``),
    differentiable."""
    return _TPReduceScatter.apply(x, mesh.data_group, mesh.shape["data"],
                                  dim)


# ---------------------------------------------------------------------------
# α–β (latency–bandwidth) cost model — the tuner's objective.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One fabric level.  alpha: per-message latency (s); beta: per-byte
    time (s/B) = 1/bandwidth."""
    alpha: float
    beta: float


# The paper's commodity GPU cluster (its Fig. 7): PCIe inside a node, one
# ~100 Gb Ethernet/RoCE NIC per node — nominal levels, not measurements.
# The NIC α includes the per-message rendezvous cost the paper attacks.
PCIE = LinkSpec(alpha=5e-6, beta=1 / 12e9)
ETH100 = LinkSpec(alpha=50e-6, beta=1 / 12.5e9)

# Named (fast, slow) fabric pairs — the vocabulary of ``--fabric``
# (``launch/mesh.parse_fabric``) and the tuner's static table; a
# calibration (``core/tuning.calibrate_fabric``) replaces it with measured
# fits.  An H100 fabric entry comes only from calibration on the card.
FABRICS = {
    "pcie_eth100": (PCIE, ETH100),  # the paper's GPU cluster (Fig. 7)
}


def cost_flat(bytes_per_device: float, N: int, G: int,
              fast: LinkSpec, slow: LinkSpec) -> float:
    """Flat AllToAll on N nodes × G GPUs, per-node NIC-centric: each GPU
    sends M-1 messages of B/M bytes; the G·G·(N-1) inter-node messages of
    one node serialize through its one NIC (the paper's Fig. 5)."""
    M = N * G
    msg = bytes_per_device / M
    intra = (G - 1) * (fast.alpha + msg * fast.beta)
    n_nic_msgs = G * G * (N - 1)
    nic_bytes = G * (M - G) / M * bytes_per_device
    inter = n_nic_msgs * slow.alpha + nic_bytes * slow.beta
    return intra + inter


def cost_hierarchical(bytes_per_device: float, N: int, G: int,
                      fast: LinkSpec, slow: LinkSpec) -> float:
    """Two-stage AllToAll: the same NIC bytes in G× fewer, G× larger
    inter-node messages.  Stage A: G-1 messages of B/G per GPU (fast);
    stage B: per node, G·(N-1) messages of B/N through the NIC."""
    a = (G - 1) * (fast.alpha + (bytes_per_device / G) * fast.beta)
    n_nic_msgs = G * (N - 1)
    nic_bytes = G * (N - 1) / N * bytes_per_device
    b = n_nic_msgs * slow.alpha + nic_bytes * slow.beta
    return a + b


def cost_pipelined(bytes_per_device: float, N: int, G: int,
                   fast: LinkSpec, slow: LinkSpec, *, n_chunks: int,
                   compute_s: float, cost_fn=cost_hierarchical) -> float:
    """The P-window exchange ↔ expert-compute pipeline: only the fill (the
    first dispatch) and the drain (the last combine) stay exposed,

        T ≈ a2a(B/P) + (P-1)·max(a2a(B/P), T_ffn/P) + T_ffn/P + a2a(B/P).
    """
    per = cost_fn(bytes_per_device / n_chunks, N, G, fast, slow)
    per_ffn = compute_s / n_chunks
    return per + (n_chunks - 1) * max(per, per_ffn) + per_ffn + per
