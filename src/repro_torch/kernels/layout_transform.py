"""Row gather of the layout transform (paper §3.2, Fig. 4):
``out[i] = src[idx[i]]``, a zero row where ``idx[i] < 0`` — and its VJP,
the row scatter-add ``out[idx[i]] += g[i]``.

``gather_rows`` replaces the TPU kernel ``repro/kernels/layout_transform.py:
_gather_rows_kernel`` and ``scatter_add_rows`` its VJP
``_scatter_add_kernel``, with the CUDA kernels of
``csrc/layout_transform.cu``.  On the H100 both are bound by bytes: every
row is read once and written once.  Design: the paper's warp-per-row
gather over raw bytes (one kernel for every dtype), 16-byte vectors where
the row width and pointers allow; the scatter-add is a warp per input row
adding into an f32 scratch with atomics, rounded once to the gradient's
dtype.  The same gather runs the grouped dispatch, the sort dispatch
(inverse row map) and the sort combine (slot map); ``gather_rows`` is
differentiable, with the scatter-add as its backward, as the reference's
``custom_vjp`` is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = 0           # gather kernel launches since the caller last reset it
scatter_launches = 0   # scatter-add kernel launches, likewise


def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the wrapper's path for a CPU tensor."""
    keep = (idx >= 0)[:, None]
    rows = src[idx.clamp(min=0).long()]
    return torch.where(keep, rows, torch.zeros((), dtype=src.dtype,
                                               device=src.device))


def _gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    global launches
    if not build.dispatch_device("gather_rows", src):
        return gather_rows_plain(src, idx)
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows: src and idx must be contiguous")
    N, d = src.shape
    M = idx.shape[0]
    out = torch.empty((M, d), dtype=src.dtype, device=src.device)
    lib = build.load()
    rc = lib.gather_rows(build.ptr(src), build.ptr(idx), build.ptr(out),
                         N, M, d * src.element_size(), build.stream(src))
    build.check(rc, "gather_rows")
    launches += 1
    return out


class _GatherRows(torch.autograd.Function):
    """``gather_rows`` with the scatter-add kernel as its backward (the
    reference's ``_gather_rows_bwd``): d src = scatter_add(g, idx, N)."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.n = src.shape[0]
        return _gather_rows(src, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return scatter_add_rows(g.contiguous(), idx, ctx.n), None


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out (M, d) with out[i] = src[idx[i]] (0 where idx[i] < 0);
    src (N, d) of any dtype, idx (M,) int32.  Differentiable in ``src``."""
    if src.dim() != 2 or idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"gather_rows: need src (N, d) and idx (M,) int32, "
                         f"got {tuple(src.shape)} and {tuple(idx.shape)} "
                         f"{idx.dtype}")
    if idx.device != src.device:
        raise ValueError(f"gather_rows: src on {src.device}, idx on "
                         f"{idx.device}")
    return _GatherRows.apply(src, idx)


def scatter_add_rows_plain(g: torch.Tensor, idx: torch.Tensor,
                           n: int) -> torch.Tensor:
    """The plain PyTorch version: an f32 ``index_add_`` of the rows with
    ``0 <= idx < n``, rounded once to ``g``'s dtype."""
    keep = (idx >= 0) & (idx < n)
    acc = torch.zeros((n + 1, g.shape[1]), dtype=torch.float32,
                      device=g.device)
    acc.index_add_(0, torch.where(keep, idx, n).long(), g.float())
    return acc[:n].to(g.dtype)


def scatter_add_rows(g: torch.Tensor, idx: torch.Tensor,
                     n: int) -> torch.Tensor:
    """out (n, d) with out[idx[i]] += g[i] (idx[i] < 0 skipped, duplicates
    accumulated in f32 and rounded once); g (M, d) bfloat16 or float32,
    idx (M,) int32.  Output in ``g``'s dtype."""
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
    acc = torch.zeros((n, d), dtype=torch.float32, device=g.device)
    bf16 = g.dtype == torch.bfloat16
    out = torch.empty((n, d), dtype=g.dtype, device=g.device) if bf16 else acc
    lib = build.load()
    rc = lib.scatter_add_rows(build.ptr(g), build.ptr(idx), build.ptr(acc),
                              build.ptr(out), n, M, d, int(bf16),
                              build.stream(g))
    build.check(rc, "scatter_add_rows")
    scatter_launches += 1
    return out
