"""Grouped (ragged) expert matmuls for the dropless dispatch mode:
``y[offs[e]:offs[e+1]] = x[offs[e]:offs[e+1]] @ w[e]``, and its backward.

Replaces the TPU kernels ``repro/kernels/grouped_ffn.py:
_grouped_matmul_kernel`` in both its forms (the forward, and
``transpose_rhs=True`` for dlhs) and ``_grouped_drhs_kernel`` with the
CUDA kernels of ``csrc/grouped_ffn.cu``.  On the H100 the prefill and
training products (M=4096, K=N=2048, E=16) are bound by bytes: the
forward and dlhs by the 128 MiB of expert weights (50.1 us at an H100
SXM's 3.35 TB/s, 700 W limit), drhs by its output (128 MiB in bf16, 50.1
us; 256 MiB in f32, 90.1 us); decode reads at most one expert's weights
per routed token.  Design of the forward and dlhs: a tile schedule over
(segment, row tile, column tile) that each block finds on the device from
``offsets`` (:func:`tile_schedule` is its plain twin), on a grid fixed by
M, N and E alone, so no launch reads the offsets on the host; one expert
per block; a cp.async-pipelined mma.sync main loop (bf16 in, f32
accumulators) on 128x128 tiles, or 16x64 tiles for decode-sized M
(:func:`block_m`); f32 keeps FMAs.  dlhs reads the weights transposed tile
by tile (no transposed copy in device memory).  drhs runs the same
machinery with the expert's rows as the contraction: one 128x128 tile of
one expert's gradient per block, its rows through a 3-stage cp.async ring,
both operands through ldmatrix.trans; its epilogue writes f32 or rounds
each sum once to bf16 (``out_dtype``), which is where the backward's cast
to ``rhs.dtype`` happens.  Nothing is split or added across blocks, so
every gradient is the same on every run.
``grouped_matmul`` is differentiable through dlhs and drhs, as the
reference's ``custom_vjp`` is.  The reference's ``grouped_block_m`` is a
TPU tiling knob — the port resolves it for config parity, but these
kernels pick their own tile.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import build, ops

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
            M: int, K: int, N: int, E: int, *bf16_args: int,
            strided_rhs: bool = False) -> None:
    """``bf16_args``: what the bf16 entry point takes after E.  With
    ``strided_rhs`` ``b`` is the (E, K, N) weight, which may be a view with
    unit column stride (an expert-TP f-slice): its expert and row strides
    are passed after E."""
    if strided_rhs:
        if b.stride(2) != 1:
            raise ValueError(f"{name}: rhs needs unit column stride, got "
                             f"strides {b.stride()}")
        strides = (b.stride(0), b.stride(1))
    elif b.is_contiguous():
        strides = ()
    else:
        raise ValueError(f"{name}: operands must be contiguous")
    if not (a.is_contiguous() and offsets.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"{name}: E={E} outside [1, {MAX_EXPERTS}]")
    lib = build.load()
    bf16 = a.dtype == torch.bfloat16
    fn = getattr(lib, fn_bf16 if bf16 else fn_f32)
    rc = fn(build.ptr(a), build.ptr(b), build.ptr(offsets), build.ptr(out),
            M, K, N, E, *strides, *(bf16_args if bf16 else ()),
            build.stream(a))
    build.check(rc, name)


def _gmm_cost(M: int, K: int, N: int, E: int, dtype: str,
              out_size: int) -> ops.Cost:
    """2·M·K·N operations; the (M, ·) operand and ``offsets`` read, the
    (E, K, N) weights read once each — every expert's, the most a call
    can need (an empty segment's are not read; a fake tensor holds no
    offsets) — and the output written (``out_size`` bytes)."""
    size = ops.itemsize(dtype)
    return ops.Cost(2 * M * K * N, M * K * size + E * K * N * size
                    + (E + 1) * 4 + out_size, ops.peak_of(dtype), True)


def matmul_cost(call: ops.KernelCall) -> ops.Cost:
    """lhs (M, K) @ rhs[e] (K, N) → (M, N): :func:`_gmm_cost`."""
    (M, K), (E, _, N) = call.shapes[:2]
    dt = call.dtypes[0]
    return _gmm_cost(M, K, N, E, dt, M * N * ops.itemsize(dt))


def matmul_t_cost(call: ops.KernelCall) -> ops.Cost:
    """g (M, N) @ rhs[e]ᵀ → (M, K): :func:`_gmm_cost` with g as the
    operand."""
    (M, N), (E, K, _) = call.shapes[:2]
    dt = call.dtypes[0]
    return _gmm_cost(M, N, K, E, dt, M * K * ops.itemsize(dt))


def drhs_cost(call: ops.KernelCall) -> ops.Cost:
    """lhs (M, K)ᵀ @ g (M, N) per segment → (E, K, N) in ``out_dtype``:
    2·M·K·N operations, lhs, g and ``offsets`` read, the gradient
    written."""
    (M, K), (_, N), (E1,) = call.shapes[:3]
    dt = call.dtypes[0]
    out = call.statics[0] if call.statics else torch.float32
    size = ops.itemsize(dt)
    return ops.Cost(2 * M * K * N, M * (K + N) * size + E1 * 4
                    + (E1 - 1) * K * N * out.itemsize, ops.peak_of(dt),
                    True)


@ops.logged("grouped_matmul", matmul_cost)
def _grouped_matmul(lhs, rhs, offsets):
    global launches
    if not build.dispatch_device("grouped_matmul", lhs):
        return grouped_matmul_plain(lhs, rhs, offsets)
    (M, K), (E, _, N) = lhs.shape, rhs.shape
    out = torch.empty((M, N), dtype=lhs.dtype, device=lhs.device)
    if build.is_fake(lhs):
        return out
    _launch("grouped_matmul", "grouped_matmul_bf16", "grouped_matmul_f32",
            lhs, rhs, offsets, out, M, K, N, E, strided_rhs=True)
    launches += 1
    return out


@ops.logged("grouped_matmul_t", matmul_t_cost)
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
    if build.is_fake(g):
        return out
    _launch("grouped_matmul_t", "grouped_matmul_t_bf16",
            "grouped_matmul_t_f32", g, rhs, offsets, out, M, K, N, E,
            strided_rhs=True)
    dlhs_launches += 1
    return out


@ops.logged("grouped_drhs", drhs_cost)
def grouped_drhs(lhs: torch.Tensor, g: torch.Tensor, offsets: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """drhs (E, K, N) with drhs[e] = lhs[seg_e]ᵀ @ g[seg_e], summed in f32;
    lhs (M, K) and g (M, N) of one dtype (bfloat16 or float32), offsets
    (E+1,) int32.  ``out_dtype`` float32 (the reference's
    ``_grouped_drhs_impl``) or ``lhs.dtype``: each f32 sum rounded once,
    in the kernel — the reference's ``drhs.astype(rhs.dtype)``, bitwise."""
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
    if out_dtype not in (torch.float32, lhs.dtype):
        raise ValueError(f"grouped_drhs: out_dtype must be float32 or "
                         f"{lhs.dtype}, got {out_dtype}")
    if not lhs.device == g.device == offsets.device:
        raise ValueError("grouped_drhs: operands on different devices")
    if not build.dispatch_device("grouped_drhs", lhs):
        return grouped_drhs_plain(lhs, g, offsets).to(out_dtype)
    (M, K), N, E = lhs.shape, g.shape[1], offsets.shape[0] - 1
    out = torch.empty((E, K, N), dtype=out_dtype, device=lhs.device)
    if build.is_fake(lhs):
        return out
    _launch("grouped_drhs", "grouped_drhs_bf16", "grouped_drhs_f32", lhs, g,
            offsets, out, M, K, N, E, int(out_dtype == torch.bfloat16))
    drhs_launches += 1
    return out


class _GroupedMatmul(torch.autograd.Function):
    """``grouped_matmul`` with the reference's ``_grouped_bwd``: ``g`` cast
    to ``lhs.dtype``; dlhs (the transposed-rhs kernel) in ``lhs.dtype``;
    drhs summed in f32 and rounded once to ``rhs.dtype`` by the kernel."""

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
            drhs = grouped_drhs(lhs, g, offsets, out_dtype=rhs.dtype)
        return dlhs, drhs, None


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """y (M, N) with y[seg_e] = lhs[seg_e] @ rhs[e]; lhs (M, K), rhs
    (E, K, N) of one dtype (bfloat16 or float32), offsets (E+1,) int32.
    ``rhs`` may be a view with unit column stride (expert TP's f-slice of
    a wider weight): the kernels read it in place, forward and dlhs.
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
