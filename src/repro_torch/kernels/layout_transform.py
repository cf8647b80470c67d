"""Row gather of the layout transform (paper §3.2, Fig. 4):
``out[i] = src[idx[i]]``, a zero row where ``idx[i] < 0`` — and its VJP,
the row scatter-add ``out[idx[i]] += g[i]``.

``gather_rows`` replaces the TPU kernel ``repro/kernels/layout_transform.py:
_gather_rows_kernel`` and ``scatter_add_rows`` its VJP
``_scatter_add_kernel``, with the CUDA kernels of
``csrc/layout_transform.cu``.  On the H100 both are bound by bytes: every
row is read once and written once (32 MiB at 4096 rows of d=2048 bf16:
10.0 us at an H100 SXM's 3.35 TB/s, 700 W limit).  Design: a warp per row
over raw bytes (one kernel for every dtype), 8 independent 16-byte loads a
lane in flight.  The gather has two forms.  Given only ``idx`` a warp per
output row reads ``src[idx[i]]``.  Given also ``dest`` (N, K), the inverse
of ``idx`` that the layout plans carry, the fan-out form reads each source
row once and writes it to its K rows (zeros where ``idx < 0``): at top-4
the plain gather read every token 4 times from device memory.  The
dispatches pass ``dest``; the combine and the scatter-add's backward read
each row at most once and keep the gather form.  The scatter-add is the
gather turned around, and deterministic: a one-block plan inverts ``idx``
on the device into compressed rows (:func:`scatter_plan` is its plain
twin), then a warp per (output row, column chunk) sums that row's input
rows in ascending order in f32 and rounds once to the gradient's dtype —
no (n, d) scratch, no atomics on the data, the same bits on every run and
the plain version's for any number of addends per row.  Each is
differentiable, with the other as its backward, as the reference's
``custom_vjp`` of the gather is.

``gather_rows_rowstep`` replaces the seed's row-per-step kernel
``_gather_row_kernel``, the baseline that ``benchmarks/bench_layout.py``
measures the blocked gather against: one CUDA block per output row, its
own kernel (no code shared with the gather), no backward.  It is on no
serving or training path.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0           # gather kernel launches since the caller last reset it
scatter_launches = 0   # scatter-add kernel launches, likewise
rowstep_launches = 0   # row-per-step gather kernel launches, likewise


def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the wrapper's path for a CPU tensor."""
    keep = (idx >= 0)[:, None]
    rows = src[idx.clamp(min=0).long()]
    return torch.where(keep, rows, torch.zeros((), dtype=src.dtype,
                                               device=src.device))


def gather_rows_fanout_plain(src: torch.Tensor, idx: torch.Tensor,
                             dest: torch.Tensor) -> torch.Tensor:
    """The plain twin of the fan-out form: each source row ``t`` written
    to the output rows ``dest[t, k] >= 0``, zeros elsewhere — the gather
    ``out[i] = src[idx[i]]`` when ``dest`` is the inverse of ``idx``.  The
    wrapper's path for a CPU tensor with ``dest``."""
    N, K = dest.shape
    flat = dest.reshape(-1).long()
    tok = torch.arange(N, device=src.device).repeat_interleave(K)
    keep = flat >= 0
    out = torch.zeros((idx.shape[0], src.shape[1]), dtype=src.dtype,
                      device=src.device)
    out[flat[keep]] = src[tok[keep]]
    return out


def _gather_rows(src: torch.Tensor, idx: torch.Tensor,
                 dest: Optional[torch.Tensor] = None) -> torch.Tensor:
    global launches
    if not build.dispatch_device("gather_rows", src):
        if dest is None:
            return gather_rows_plain(src, idx)
        return gather_rows_fanout_plain(src, idx, dest)
    if not (src.is_contiguous() and idx.is_contiguous()
            and (dest is None or dest.is_contiguous())):
        raise ValueError("gather_rows: src, idx and dest must be contiguous")
    N, d = src.shape
    M = idx.shape[0]
    out = torch.empty((M, d), dtype=src.dtype, device=src.device)
    lib = build.load()
    if dest is None:
        rc = lib.gather_rows(build.ptr(src), build.ptr(idx), build.ptr(out),
                             N, M, d * src.element_size(), build.stream(src))
    else:
        rc = lib.gather_rows_fanout(
            build.ptr(src), build.ptr(idx), build.ptr(dest), build.ptr(out),
            N, M, dest.shape[1], d * src.element_size(), build.stream(src))
    build.check(rc, "gather_rows")
    launches += 1
    return out


class _GatherRows(torch.autograd.Function):
    """``gather_rows`` with the scatter-add kernel as its backward (the
    reference's ``_gather_rows_bwd``): d src = scatter_add(g, idx, N),
    whichever form ran forward."""

    @staticmethod
    def forward(ctx, src, idx, dest):
        ctx.save_for_backward(idx)
        ctx.n = src.shape[0]
        return _gather_rows(src, idx, dest)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return scatter_add_rows(g.contiguous(), idx, ctx.n), None, None


def gather_rows(src: torch.Tensor, idx: torch.Tensor,
                dest: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out (M, d) with out[i] = src[idx[i]] (0 where idx[i] < 0);
    src (N, d) of any dtype, idx (M,) int32.  With ``dest`` (N, K) int32,
    the inverse of ``idx`` (the output rows of source row t, -1 for none:
    ``idx[dest[t, k]] == t``, every i with ``idx[i] >= 0`` among them),
    the fan-out form runs: each source row is read once and written to
    its K rows — the same result.  Differentiable in ``src``."""
    if src.dim() != 2 or idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"gather_rows: need src (N, d) and idx (M,) int32, "
                         f"got {tuple(src.shape)} and {tuple(idx.shape)} "
                         f"{idx.dtype}")
    if idx.device != src.device:
        raise ValueError(f"gather_rows: src on {src.device}, idx on "
                         f"{idx.device}")
    if dest is not None:
        if (dest.dim() != 2 or dest.shape[0] != src.shape[0]
                or dest.dtype != torch.int32):
            raise ValueError(f"gather_rows: dest must be (N={src.shape[0]}, "
                             f"K) int32, got {tuple(dest.shape)} "
                             f"{dest.dtype}")
        if dest.device != src.device:
            raise ValueError(f"gather_rows: src on {src.device}, dest on "
                             f"{dest.device}")
    return _GatherRows.apply(src, idx, dest)


def gather_rows_rowstep_plain(src: torch.Tensor,
                              idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``gather_rows_rowstep``: the wrapper's
    path for a CPU tensor (the same function as ``gather_rows_plain``)."""
    return gather_rows_plain(src, idx)


def gather_rows_rowstep(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out (M, d) with out[i] = src[idx[i]] (0 where idx[i] < 0); src (N, d)
    bfloat16 or float32, idx (M,) int32.  The seed's one-row-per-step
    kernel, kept as a benchmark baseline; it has no backward, as the
    reference has none."""
    global rowstep_launches
    if src.dim() != 2 or idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"gather_rows_rowstep: need src (N, d) and idx (M,) "
                         f"int32, got {tuple(src.shape)} and "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if src.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gather_rows_rowstep: src must be bfloat16 or "
                         f"float32, got {src.dtype}")
    if idx.device != src.device:
        raise ValueError(f"gather_rows_rowstep: src on {src.device}, idx on "
                         f"{idx.device}")
    build.reject_grad("gather_rows_rowstep", src)
    if not build.dispatch_device("gather_rows_rowstep", src):
        return gather_rows_rowstep_plain(src, idx)
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows_rowstep: src and idx must be "
                         "contiguous")
    N, d = src.shape
    M = idx.shape[0]
    out = torch.empty((M, d), dtype=src.dtype, device=src.device)
    rc = build.load().gather_rows_rowstep(
        build.ptr(src), build.ptr(idx), build.ptr(out), N, M, d,
        src.element_size(), build.stream(src))
    build.check(rc, "gather_rows_rowstep")
    rowstep_launches += 1
    return out


def scatter_plan(idx: torch.Tensor, n: int):
    """The scatter-add's plan, inverse of ``idx``: (starts (n+1,) int32,
    rows (V,) int32) with ``rows[starts[r]:starts[r+1]]`` the input rows i
    with ``idx[i] == r`` in ascending i; rows with ``idx < 0`` or ``>= n``
    appear nowhere.  The plain twin of ``scatter_plan_kernel`` followed by
    the ascending walk of ``scatter_sum_kernel`` (``csrc/
    layout_transform.cu``), whose placement is unordered within a row."""
    i = idx.long()
    key = torch.where((i >= 0) & (i < n), i, n)
    order = torch.sort(key, stable=True).indices
    counts = torch.zeros(n + 1, dtype=torch.int64, device=idx.device)
    counts.index_add_(0, key, torch.ones_like(key))
    starts = torch.zeros(n + 1, dtype=torch.int64, device=idx.device)
    starts[1:] = torch.cumsum(counts[:n], 0)
    return starts.to(torch.int32), order[:int(starts[n])].to(torch.int32)


def scatter_add_rows_plain(g: torch.Tensor, idx: torch.Tensor,
                           n: int) -> torch.Tensor:
    """The plain PyTorch version: for each output row the f32 sum of its
    rows of ``g`` in ascending input row (:func:`scatter_plan`), rounded
    once to ``g``'s dtype — on any device the same bits, since pass k adds
    each row's k-th addend by an ``index_add_`` with no index twice."""
    starts, rows = scatter_plan(idx, n)
    counts = (starts[1:] - starts[:-1]).long()
    owner = torch.repeat_interleave(
        torch.arange(n, device=g.device), counts)
    rank = torch.arange(rows.shape[0], device=g.device) - starts[owner].long()
    acc = torch.zeros((n, g.shape[1]), dtype=torch.float32, device=g.device)
    for k in range(int(counts.max()) if n else 0):
        pick = rank == k
        acc.index_add_(0, owner[pick], g[rows[pick].long()].float())
    return acc.to(g.dtype)


def _scatter_add_rows(g: torch.Tensor, idx: torch.Tensor,
                      n: int) -> torch.Tensor:
    global scatter_launches
    if g.dim() != 2 or idx.shape != (g.shape[0],) or idx.dtype != torch.int32:
        raise ValueError(f"scatter_add_rows: need g (M, d) and idx (M,) "
                         f"int32, got {tuple(g.shape)} and "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if g.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"scatter_add_rows: g must be bfloat16 or float32, "
                         f"got {g.dtype}")
    if idx.device != g.device:
        raise ValueError(f"scatter_add_rows: g on {g.device}, idx on "
                         f"{idx.device}")
    if not build.dispatch_device("scatter_add_rows", g):
        return scatter_add_rows_plain(g, idx, n)
    if not (g.is_contiguous() and idx.is_contiguous()):
        raise ValueError("scatter_add_rows: g and idx must be contiguous")
    M, d = g.shape
    out = torch.empty((n, d), dtype=g.dtype, device=g.device)
    scratch = torch.empty(2 * n + 1 + M, dtype=torch.int32, device=g.device)
    starts, cursor, slots = scratch.split([n + 1, n, M])
    rc = build.load().scatter_add_rows(
        build.ptr(g), build.ptr(idx), build.ptr(starts), build.ptr(cursor),
        build.ptr(slots), build.ptr(out), n, M, d,
        int(g.dtype == torch.bfloat16), build.stream(g))
    build.check(rc, "scatter_add_rows")
    scatter_launches += 1
    return out


class _ScatterAddRows(torch.autograd.Function):
    """``scatter_add_rows`` with the gather kernel as its backward:
    d g[i] = dout[idx[i]], 0 where ``idx[i]`` was skipped."""

    @staticmethod
    def forward(ctx, g, idx, n):
        ctx.save_for_backward(idx)
        ctx.n = n
        return _scatter_add_rows(g, idx, n)

    @staticmethod
    def backward(ctx, dout):
        idx, = ctx.saved_tensors
        kept = torch.where(idx < ctx.n, idx, -1)
        return _gather_rows(dout.contiguous(), kept), None, None


def scatter_add_rows(g: torch.Tensor, idx: torch.Tensor,
                     n: int) -> torch.Tensor:
    """out (n, d) with out[idx[i]] += g[i] (idx[i] < 0 or >= n skipped;
    duplicates summed in f32 in ascending i and rounded once, so the
    result is the same on every run); g (M, d) bfloat16 or float32, idx
    (M,) int32.  Output in ``g``'s dtype; differentiable in ``g``."""
    return _ScatterAddRows.apply(g, idx, n)
