"""Fused softmax statistics + top-k gate (paper §3.2 "Gate Optimization").

Replaces the TPU kernel ``repro/kernels/topk_gate.py:_topk_gate_kernel``
with the CUDA kernel ``csrc/topk_gate.cu``.  On the H100 it is bound by
its bytes — 256 KiB of logits at S=4096, E=16 — so the launch is most of
its cost.  Design: one warp per row, warp-shuffle reductions for the max,
Σexp (``expf``) and k rounds of argmax with lowest-index ties; no -inf
padding, since rows are bounded by S.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

MAX_K = 8          # TOPK_MAX_K in csrc/topk_gate.cu
launches = 0       # kernel launches since the caller last reset it


def topk_gate_plain(logits: torch.Tensor, k: int):
    """The plain PyTorch version: k-step ``argmax`` masking.  Not
    ``torch.topk``, which does not promise lowest-index ties."""
    x = logits.float()
    rowmax = x.max(dim=-1, keepdim=True).values
    sumexp = torch.exp(x - rowmax).sum(dim=-1, keepdim=True)
    cur = x.clone()
    vals, idx = [], []
    for _ in range(k):
        am = cur.argmax(dim=-1, keepdim=True)     # first maximal index
        vals.append(cur.gather(-1, am))
        idx.append(am)
        cur.scatter_(-1, am, float("-inf"))
    return (torch.cat(vals, -1), torch.cat(idx, -1).to(torch.int32),
            rowmax, sumexp)


def fused_topk_gate(logits: torch.Tensor, k: int):
    """One pass: ``(vals (S,k) f32, idx (S,k) i32, rowmax (S,1),
    sumexp (S,1))`` from logits (S, E) f32."""
    global launches
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise ValueError(f"fused_topk_gate: logits must be (S, E) float32, "
                         f"got {tuple(logits.shape)} {logits.dtype}")
    S, E = logits.shape
    if not 1 <= k <= min(E, MAX_K):
        raise ValueError(f"fused_topk_gate: k={k} must be in [1, "
                         f"min(E={E}, {MAX_K})]")
    build.reject_grad("fused_topk_gate", logits)
    if not build.dispatch_device("fused_topk_gate", logits):
        return topk_gate_plain(logits, k)
    if not logits.is_contiguous():
        raise ValueError("fused_topk_gate: logits must be contiguous")
    dev = logits.device
    vals = torch.empty((S, k), dtype=torch.float32, device=dev)
    idx = torch.empty((S, k), dtype=torch.int32, device=dev)
    rowmax = torch.empty((S, 1), dtype=torch.float32, device=dev)
    sumexp = torch.empty((S, 1), dtype=torch.float32, device=dev)
    lib = build.load()
    rc = lib.topk_gate_f32(build.ptr(logits), build.ptr(vals), build.ptr(idx),
                           build.ptr(rowmax), build.ptr(sumexp), S, E, k,
                           build.stream(logits))
    build.check(rc, "topk_gate")
    launches += 1
    return vals, idx, rowmax, sumexp
