"""Row gather of the layout transform (paper §3.2, Fig. 4):
``out[i] = src[idx[i]]``, a zero row where ``idx[i] < 0``.

Replaces the TPU kernel ``repro/kernels/layout_transform.py:
_gather_rows_kernel`` (forward only; its scatter-add VJP comes with the
training slice) with the CUDA kernel ``csrc/layout_transform.cu``.  On the
H100 it is bound by bytes: every output row is read once and written
once.  Design: the paper's warp-per-row gather over raw bytes (one kernel
for every dtype), 16-byte vectors where the row width and pointers allow.
The same kernel runs the grouped dispatch, the sort dispatch (inverse row
map) and the sort combine (slot map).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = 0       # kernel launches since the caller last reset it


def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the wrapper's path for a CPU tensor."""
    keep = (idx >= 0)[:, None]
    rows = src[idx.clamp(min=0).long()]
    return torch.where(keep, rows, torch.zeros((), dtype=src.dtype,
                                               device=src.device))


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out (M, d) with out[i] = src[idx[i]] (0 where idx[i] < 0);
    src (N, d) of any dtype, idx (M,) int32."""
    global launches
    if src.dim() != 2 or idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"gather_rows: need src (N, d) and idx (M,) int32, "
                         f"got {tuple(src.shape)} and {tuple(idx.shape)} "
                         f"{idx.dtype}")
    if idx.device != src.device:
        raise ValueError(f"gather_rows: src on {src.device}, idx on "
                         f"{idx.device}")
    build.reject_grad("gather_rows", src)
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
