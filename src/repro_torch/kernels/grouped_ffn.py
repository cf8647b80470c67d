"""Grouped (ragged) expert matmuls for the dropless dispatch mode:
``y[offs[e]:offs[e+1]] = x[offs[e]:offs[e+1]] @ w[e]``, and its backward.

Replaces the TPU kernels ``repro/kernels/grouped_ffn.py:
_grouped_matmul_kernel`` in both its forms (the forward, and
``transpose_rhs=True`` for dlhs) and ``_grouped_drhs_kernel`` with the
CUDA kernels of ``csrc/grouped_ffn.cu``.  On the H100 the prefill and
training products (M=4096, K=N=2048, E=16) are bound by bytes: the
forward and dlhs by the 128 MiB of expert weights, drhs by its 256 MiB
f32 output; decode reads at most one expert's weights per routed token.
Design of the forward and dlhs: a tile schedule over (segment, row tile,
column tile) that each block finds on the device from ``offsets``
(:func:`tile_schedule` is its plain twin), on a grid fixed by M, N and E
alone, so no launch reads the offsets on the host; one expert per block;
a cp.async-pipelined mma.sync main loop (bf16 in, f32 accumulators) on
128x128 tiles, or 16x64 tiles for decode-sized M (:func:`block_m`); f32
keeps FMAs.  dlhs reads the weights transposed tile by tile (no
transposed copy in device memory); drhs gives each block one tile of one
expert's gradient and walks that expert's rows; see the source.
``grouped_matmul`` is differentiable through dlhs and drhs, as the
reference's ``custom_vjp`` is.  The reference's ``grouped_block_m`` is a
TPU tiling knob — the port resolves it for config parity, but these
kernels pick their own tile.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import build

MAX_EXPERTS = 1024     # GMM_MAX_E in csrc/grouped_ffn.cu
launches = 0           # forward kernel launches since the caller last reset
dlhs_launches = 0      # transposed-rhs (dlhs) kernel launches, likewise
drhs_launches = 0      # drhs kernel launches, likewise


SMALL_M = 256          # SMALL_M in csrc/grouped_ffn.cu


def block_m(M: int, dtype: torch.dtype) -> int:
    """Rows per tile of the forward and dlhs kernels: 16 for bf16 at M <=
    SMALL_M (decode), else 128; 64 for f32."""
    if dtype == torch.float32:
        return 64
    return 16 if M <= SMALL_M else 128


def tile_schedule(offsets, M: int, bm: int) -> list:
    """The forward and dlhs kernels' row tiles, in schedule order, as
    (expert, row0, row1) with expert -1 for a tile of zero rows — the plain
    twin of ``find_tile`` in ``csrc/grouped_ffn.cu``.  Offsets clamped
    into [0, M] cut the rows into a zero head [0, c_0), expert e's
    [c_e, c_{e+1}) and a zero tail [c_E, M); each is cut into ``bm``-row
    tiles from its first row, so there are at most ceil(M/bm) + E + 1
    (the kernels' grid)."""
    c = [min(max(int(x), 0), M) for x in offsets]
    E = len(c) - 1
    bounds = [(-1, 0, c[0])] + [(e, c[e], c[e + 1]) for e in range(E)] + [
        (-1, c[E], M)]
    tiles = []
    for e, lo, hi in bounds:
        tiles += [(e, r, min(hi, r + bm)) for r in range(lo, max(hi, lo), bm)]
    return tiles


def _segments(offsets: torch.Tensor, M: int):
    offs = offsets.tolist()
    for e in range(len(offs) - 1):
        lo, hi = max(offs[e], 0), min(offs[e + 1], M)
        if hi > lo:
            yield e, lo, hi


def grouped_matmul_plain(lhs: torch.Tensor, rhs: torch.Tensor,
                         offsets: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: per-segment f32 products, rounded once
    to ``lhs.dtype``; rows past ``offsets[E]`` are zero."""
    M = lhs.shape[0]
    out = torch.zeros((M, rhs.shape[2]), dtype=torch.float32,
                      device=lhs.device)
    for e, lo, hi in _segments(offsets, M):
        out[lo:hi] = lhs[lo:hi].float() @ rhs[e].float()
    return out.to(lhs.dtype)


def grouped_matmul_t_plain(g: torch.Tensor, rhs: torch.Tensor,
                           offsets: torch.Tensor) -> torch.Tensor:
    """Plain dlhs: ``out[seg_e] = g[seg_e] @ rhs[e]ᵀ`` per segment in f32,
    rounded once to ``g.dtype``; rows past ``offsets[E]`` are zero."""
    M = g.shape[0]
    out = torch.zeros((M, rhs.shape[1]), dtype=torch.float32,
                      device=g.device)
    for e, lo, hi in _segments(offsets, M):
        out[lo:hi] = g[lo:hi].float() @ rhs[e].float().T
    return out.to(g.dtype)


def grouped_drhs_plain(lhs: torch.Tensor, g: torch.Tensor,
                       offsets: torch.Tensor) -> torch.Tensor:
    """Plain drhs: ``out[e] = lhs[seg_e]ᵀ @ g[seg_e]`` in f32, (E, K, N);
    an empty segment gives zeros, rows past ``offsets[E]`` add nothing."""
    E = offsets.shape[0] - 1
    out = torch.zeros((E, lhs.shape[1], g.shape[1]), dtype=torch.float32,
                      device=lhs.device)
    for e, lo, hi in _segments(offsets, lhs.shape[0]):
        out[e] = lhs[lo:hi].float().T @ g[lo:hi].float()
    return out


def _check(name: str, lhs: torch.Tensor, rhs: torch.Tensor,
           offsets: torch.Tensor, transpose: bool = False) -> None:
    """lhs (M, K) against rhs (E, K, N) — (M, N) with ``transpose``."""
    if (lhs.dim() != 2 or rhs.dim() != 3
            or lhs.shape[1] != rhs.shape[2 if transpose else 1]):
        raise ValueError(f"{name}: operand shapes {tuple(lhs.shape)} and "
                         f"{tuple(rhs.shape)} do not match")
    E = rhs.shape[0]
    if offsets.shape != (E + 1,) or offsets.dtype != torch.int32:
        raise ValueError(f"{name}: offsets must be ({E + 1},) int32, "
                         f"got {tuple(offsets.shape)} {offsets.dtype}")
    if lhs.dtype != rhs.dtype or lhs.dtype not in (torch.bfloat16,
                                                   torch.float32):
        raise ValueError(f"{name}: operands must share bfloat16 or "
                         f"float32, got {lhs.dtype} and {rhs.dtype}")
    if not lhs.device == rhs.device == offsets.device:
        raise ValueError(f"{name}: operands on different devices")


def _launch(name: str, fn_bf16: str, fn_f32: str, a: torch.Tensor,
            b: torch.Tensor, offsets: torch.Tensor, out: torch.Tensor,
            M: int, K: int, N: int, E: int) -> None:
    if not (a.is_contiguous() and b.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"{name}: E={E} outside [1, {MAX_EXPERTS}]")
    lib = build.load()
    fn = getattr(lib, fn_bf16 if a.dtype == torch.bfloat16 else fn_f32)
    rc = fn(build.ptr(a), build.ptr(b), build.ptr(offsets), build.ptr(out),
            M, K, N, E, build.stream(a))
    build.check(rc, name)


def _grouped_matmul(lhs, rhs, offsets):
    global launches
    if not build.dispatch_device("grouped_matmul", lhs):
        return grouped_matmul_plain(lhs, rhs, offsets)
    (M, K), (E, _, N) = lhs.shape, rhs.shape
    out = torch.empty((M, N), dtype=lhs.dtype, device=lhs.device)
    _launch("grouped_matmul", "grouped_matmul_bf16", "grouped_matmul_f32",
            lhs, rhs, offsets, out, M, K, N, E)
    launches += 1
    return out


def grouped_matmul_t(g: torch.Tensor, rhs: torch.Tensor,
                     offsets: torch.Tensor) -> torch.Tensor:
    """dlhs (M, K) with dlhs[seg_e] = g[seg_e] @ rhs[e]ᵀ; g (M, N), rhs
    (E, K, N) of one dtype (bfloat16 or float32), offsets (E+1,) int32."""
    global dlhs_launches
    _check("grouped_matmul_t", g, rhs, offsets, transpose=True)
    if not build.dispatch_device("grouped_matmul_t", g):
        return grouped_matmul_t_plain(g, rhs, offsets)
    M, (E, K, N) = g.shape[0], rhs.shape
    out = torch.empty((M, K), dtype=g.dtype, device=g.device)
    _launch("grouped_matmul_t", "grouped_matmul_t_bf16",
            "grouped_matmul_t_f32", g, rhs, offsets, out, M, K, N, E)
    dlhs_launches += 1
    return out


def grouped_drhs(lhs: torch.Tensor, g: torch.Tensor,
                 offsets: torch.Tensor) -> torch.Tensor:
    """drhs (E, K, N) f32 with drhs[e] = lhs[seg_e]ᵀ @ g[seg_e]; lhs (M, K)
    and g (M, N) of one dtype (bfloat16 or float32), offsets (E+1,)
    int32."""
    global drhs_launches
    if (lhs.dim() != 2 or g.dim() != 2 or lhs.shape[0] != g.shape[0]
            or offsets.dim() != 1 or offsets.dtype != torch.int32):
        raise ValueError(f"grouped_drhs: need lhs (M, K), g (M, N) and "
                         f"offsets (E+1,) int32, got {tuple(lhs.shape)}, "
                         f"{tuple(g.shape)}, {tuple(offsets.shape)} "
                         f"{offsets.dtype}")
    if lhs.dtype != g.dtype or lhs.dtype not in (torch.bfloat16,
                                                 torch.float32):
        raise ValueError(f"grouped_drhs: lhs and g must share bfloat16 or "
                         f"float32, got {lhs.dtype} and {g.dtype}")
    if not lhs.device == g.device == offsets.device:
        raise ValueError("grouped_drhs: operands on different devices")
    if not build.dispatch_device("grouped_drhs", lhs):
        return grouped_drhs_plain(lhs, g, offsets)
    (M, K), N, E = lhs.shape, g.shape[1], offsets.shape[0] - 1
    out = torch.empty((E, K, N), dtype=torch.float32, device=lhs.device)
    _launch("grouped_drhs", "grouped_drhs_bf16", "grouped_drhs_f32", lhs, g,
            offsets, out, M, K, N, E)
    drhs_launches += 1
    return out


class _GroupedMatmul(torch.autograd.Function):
    """``grouped_matmul`` with the reference's ``_grouped_bwd``: ``g`` cast
    to ``lhs.dtype``; dlhs (the transposed-rhs kernel) in ``lhs.dtype``;
    drhs computed in f32 and returned in ``rhs.dtype``."""

    @staticmethod
    def forward(ctx, lhs, rhs, offsets):
        ctx.save_for_backward(lhs, rhs, offsets)
        return _grouped_matmul(lhs, rhs, offsets)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, offsets = ctx.saved_tensors
        g = g.to(lhs.dtype).contiguous()
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = grouped_matmul_t(g, rhs, offsets)
        if ctx.needs_input_grad[1]:
            drhs = grouped_drhs(lhs, g, offsets).to(rhs.dtype)
        return dlhs, drhs, None


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """y (M, N) with y[seg_e] = lhs[seg_e] @ rhs[e]; lhs (M, K), rhs
    (E, K, N) of one dtype (bfloat16 or float32), offsets (E+1,) int32.
    Differentiable in ``lhs`` and ``rhs``."""
    _check("grouped_matmul", lhs, rhs, offsets)
    return _GroupedMatmul.apply(lhs, rhs, offsets)


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
