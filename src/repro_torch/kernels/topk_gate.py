"""Fused softmax statistics + top-k gate (paper §3.2 "Gate Optimization").

Replaces the TPU kernel ``repro/kernels/topk_gate.py:_topk_gate_kernel``
with the CUDA kernel ``csrc/topk_gate.cu``.  On the H100 its bytes are
tiny (4 MiB of logits at S=8192, E=128), so one launch is most of its
cost.  Design: each row held in registers, loaded once as 16-byte vectors
over a row's lanes (4 lanes and 8 rows a warp at E=16, 16 lanes of two
vectors at E=128); sub-warp shuffle butterflies for the argmax, whose
first round is the row max, and for Σexp (``expf``); a winner masked to
-inf in the register that holds it, lowest-index ties; one instance per k
(1..8) and lanes per row, picked by the host.  A scalar path serves E
that is not a multiple of 4 (E up to ``MAX_E``).  No -inf padding, since
rows are bounded by S.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ops

MAX_K = 8          # TOPK_MAX_K in csrc/topk_gate.cu
MAX_E = 512        # TOPK_MAX_E
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


def cost(call: ops.KernelCall) -> ops.Cost:
    """logits (S, E) f32 read once; vals and idx (S, k), rowmax and sumexp
    (S, 1) written; 4·S·E f32 operations (the max, the exp, the sum and
    the argmax passes over the row)."""
    (S, E), (k,) = call.shapes[0], call.statics
    return ops.Cost(4 * S * E, S * E * 4 + S * (8 * k + 8), ops.F32_FLOPS)


@ops.logged("topk_gate", cost)
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
    if E > MAX_E:
        raise ValueError(f"fused_topk_gate: E={E} experts, at most {MAX_E}")
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
    if build.is_fake(logits):
        return vals, idx, rowmax, sumexp
    lib = build.load()
    rc = lib.topk_gate_f32(build.ptr(logits), build.ptr(vals), build.ptr(idx),
                           build.ptr(rowmax), build.ptr(sumexp), S, E, k,
                           build.stream(logits))
    build.check(rc, "topk_gate")
    launches += 1
    return vals, idx, rowmax, sumexp
