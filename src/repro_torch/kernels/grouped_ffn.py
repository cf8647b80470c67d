"""Grouped (ragged) expert matmuls for the dropless dispatch mode:
``y[offs[e]:offs[e+1]] = x[offs[e]:offs[e+1]] @ w[e]``.

Replaces the TPU kernel ``repro/kernels/grouped_ffn.py:
_grouped_matmul_kernel`` in its forward form (``transpose_rhs=False``;
the dlhs and drhs backward kernels come with the training slice) with the
CUDA kernel ``csrc/grouped_ffn.cu``.  On the H100 the prefill product
(M=4096, K=N=2048, E=16) is bound by the bytes of the expert weights;
decode reads at most one expert's weights per routed token.  Design: a
64x64 output tile per block, masked per-expert K loops accumulating in
f32 (bf16 on the tensor cores through WMMA, f32 with FMAs); see the
source.  The reference's ``grouped_block_m`` is a TPU tiling knob — the
port resolves it for config parity, but this kernel picks its own tile.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import build

MAX_EXPERTS = 1024     # GMM_MAX_E in csrc/grouped_ffn.cu
launches = 0           # kernel launches since the caller last reset it


def grouped_matmul_plain(lhs: torch.Tensor, rhs: torch.Tensor,
                         offsets: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: per-segment f32 products, rounded once
    to ``lhs.dtype``; rows past ``offsets[E]`` are zero."""
    M = lhs.shape[0]
    out = torch.zeros((M, rhs.shape[2]), dtype=torch.float32,
                      device=lhs.device)
    offs = offsets.tolist()
    for e in range(rhs.shape[0]):
        lo, hi = max(offs[e], 0), min(offs[e + 1], M)
        if hi > lo:
            out[lo:hi] = lhs[lo:hi].float() @ rhs[e].float()
    return out.to(lhs.dtype)


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """y (M, N) with y[seg_e] = lhs[seg_e] @ rhs[e]; lhs (M, K), rhs
    (E, K, N) of one dtype (bfloat16 or float32), offsets (E+1,) int32."""
    global launches
    if lhs.dim() != 2 or rhs.dim() != 3 or lhs.shape[1] != rhs.shape[1]:
        raise ValueError(f"grouped_matmul: need lhs (M, K) and rhs (E, K, N),"
                         f" got {tuple(lhs.shape)} and {tuple(rhs.shape)}")
    E = rhs.shape[0]
    if offsets.shape != (E + 1,) or offsets.dtype != torch.int32:
        raise ValueError(f"grouped_matmul: offsets must be ({E + 1},) int32, "
                         f"got {tuple(offsets.shape)} {offsets.dtype}")
    if lhs.dtype != rhs.dtype or lhs.dtype not in (torch.bfloat16,
                                                   torch.float32):
        raise ValueError(f"grouped_matmul: lhs and rhs must share bfloat16 or"
                         f" float32, got {lhs.dtype} and {rhs.dtype}")
    if not lhs.device == rhs.device == offsets.device:
        raise ValueError("grouped_matmul: operands on different devices")
    build.reject_grad("grouped_matmul", lhs, rhs)
    if not build.dispatch_device("grouped_matmul", lhs):
        return grouped_matmul_plain(lhs, rhs, offsets)
    if not (lhs.is_contiguous() and rhs.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError("grouped_matmul: operands must be contiguous")
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"grouped_matmul: E={E} outside [1, {MAX_EXPERTS}]")
    M, K = lhs.shape
    N = rhs.shape[2]
    out = torch.empty((M, N), dtype=lhs.dtype, device=lhs.device)
    lib = build.load()
    fn = (lib.grouped_matmul_bf16 if lhs.dtype == torch.bfloat16
          else lib.grouped_matmul_f32)
    rc = fn(build.ptr(lhs), build.ptr(rhs), build.ptr(offsets),
            build.ptr(out), M, K, N, E, build.stream(lhs))
    build.check(rc, "grouped_matmul")
    launches += 1
    return out


def grouped_ffn(params: Dict[str, torch.Tensor], xs: torch.Tensor,
                offsets: torch.Tensor, act: str) -> torch.Tensor:
    """Expert FFN over the expert-sorted (M, d) buffer — the dropless twin
    of ``moe.expert_ffn``.  Each matmul accumulates in f32 and rounds back
    to the compute dtype, as the sort path's product does."""
    if "w_gate" in params and params["w_gate"].shape != params["w_up"].shape:
        raise ValueError(
            f"grouped_ffn: w_gate shape {tuple(params['w_gate'].shape)} != "
            f"w_up shape {tuple(params['w_up'].shape)}")
    h = grouped_matmul(xs, params["w_up"], offsets)
    if act in ("swiglu", "geglu"):
        gt = grouped_matmul(xs, params["w_gate"], offsets)
        h = h * (torch.nn.functional.silu(gt) if act == "swiglu"
                 else torch.nn.functional.gelu(gt, approximate="tanh"))
    elif act == "gelu":
        h = torch.nn.functional.gelu(h, approximate="tanh")
    else:
        h = torch.relu(h)
    return grouped_matmul(h, params["w_out"], offsets)
