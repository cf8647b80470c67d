"""Flash attention, forward and backward: online-softmax GQA attention with
q/k position vectors (``k_pos < 0`` marks an invalid key), causal and
sliding-window masks and an optional logit softcap.

Replaces the TPU kernels ``repro/kernels/flash_attention.py: _fwd_kernel``,
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` with the CUDA kernels of
``csrc/flash_attention.cu``.  The layout is the reference's, head-major:
q (B, H, Sq, d), k and v (B, KV, Sk, d), head ``h`` reading kv head
``h // (H / KV)``; positions are int32 (Sq,) and (Sk,).  The forward
returns o in q's dtype and the per-row logsumexp in f32; the backward
takes Δ = rowsum(dO∘O) and gives dq, and dk, dv summed over the G = H/KV
query heads of each kv head.  p and dS stay in f32 (bf16 inputs widened
exactly), as in the reference kernels, which is what sets this path apart
from the chunked ``_attend`` (that one rounds p to v's dtype).

Head dims: every kernel takes the multiples of 16 up to 128, 120
(h2o-danube3) and 256 (gemma2) (:data:`HEAD_DIMS`), in the forward and
the backward.

``flash_attention`` is differentiable through the dq and dk/dv kernels,
as the reference's ``custom_vjp`` is.  The reference's ``block_q`` is a
TPU tiling knob; the CUDA kernels pick their own 64-row tiles, which
changes only the order of the f32 sums.  The forward and dq skip the k
tiles that no row of a group of their queries may see
(:func:`visited_k_tiles` is the plain twin of that rule); dk/dv skips the
q tiles that may see none of its keys, but visits for dv a q tile that
holds a row with no allowed key (:func:`visited_q_tiles`).  In bf16 every
product runs on the tensor cores, the products of p and dS with each
split into two bf16 parts, x = hi + lo, leaving at most 2⁻¹⁶·|x| of it
out.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ops

NEG = -1e30            # the reference's mask value (flash_attention.py:37)
# the head dims the CUDA kernels take (head_dim in csrc/flash_attention.cu)
HEAD_DIMS = tuple(range(16, 129, 16)) + (120, 256)
fwd_launches = 0       # forward kernel launches since the caller last reset
dq_launches = 0        # dq kernel launches, likewise
dkv_launches = 0       # dk/dv kernel launches, likewise


# ---------------------------------------------------------------------------
# the plain versions: the reference kernels' formulas over whole (Sq, Sk)
# score tensors in f32
# ---------------------------------------------------------------------------

def _mask(q_pos, k_pos, causal: bool, window: Optional[int]):
    """(Sq, Sk) bool, as the reference's ``_mask``."""
    m = (k_pos >= 0)[None, :]
    if causal:
        m = m & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        m = m & (k_pos[None, :] > q_pos[:, None] - window)
    return m


TILE = 64              # FA_TILE in csrc/flash_attention.cu: keys per tile
GROUP = 16             # FB_GROUP: query rows of a warp of the bf16 kernels


def visited_k_tiles(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                    window: Optional[int], rows: int = GROUP) -> torch.Tensor:
    """(ceil(Sq/rows), ceil(Sk/64)) bool: the 64-key tiles each group of
    ``rows`` queries visits in the CUDA forward and dq — the plain twin
    of ``plan_k_tiles`` (groups of 16 rows in bf16, of 64 in f32).  Every
    tile when a row of the group has no allowed key (the reference then
    gives it p = 1 for every key); else each tile holding a valid key at
    most the group's largest q position (causal) and above its smallest
    minus the window (window)."""
    Sq, Sk = q_pos.shape[0], k_pos.shape[0]
    allowed = _mask(q_pos, k_pos, causal, window).expand(Sq, Sk)
    nk = -(-Sk // TILE)
    kp = torch.nn.functional.pad(k_pos.long(), (0, nk * TILE - Sk),
                                 value=-1)
    out = []
    for q0 in range(0, Sq, rows):
        qp = q_pos[q0:q0 + rows].long()
        if not bool(allowed[q0:q0 + rows].any(dim=1).all()):
            out.append(torch.ones(nk, dtype=torch.bool))
            continue
        ok = kp >= 0
        if causal:
            ok = ok & (kp <= qp.max())
        if window is not None:
            ok = ok & (kp > qp.min() - window)
        out.append(ok.reshape(nk, TILE).any(dim=1).cpu())
    return torch.stack(out)


SKIP, VISIT, NO_MASK, DV_ONLY = 0, 1, 2, 3    # the codes of plan_q_tiles


def visited_q_tiles(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                    window: Optional[int]) -> torch.Tensor:
    """(ceil(Sk/64), ceil(Sq/64)) int8: what the CUDA dk/dv block of each
    64-key tile does with each 64-query tile — the plain twin of
    ``plan_q_tiles``.  ``VISIT`` when the k tile holds a valid key at most
    the q tile's largest position (causal) and above its smallest minus
    the window (window), ``NO_MASK`` when all 64 keys are valid and every
    row of the q tile may see every one of them; else ``DV_ONLY`` when a
    row of the q tile has no allowed key at all (the reference's dk/dv
    uses p unmasked, and such a row's lse is NEG, so p = 1 for every key
    and its dO lands in dv of every key, while its dS is 0), else
    ``SKIP``."""
    Sq, Sk = q_pos.shape[0], k_pos.shape[0]
    nokey = ~_mask(q_pos, k_pos, causal, window).expand(Sq, Sk).any(dim=1)
    nk = -(-Sk // TILE)
    kp = torch.nn.functional.pad(k_pos.long(), (0, nk * TILE - Sk),
                                 value=-1).reshape(nk, TILE)
    out = []
    for q0 in range(0, Sq, TILE):
        qp = q_pos[q0:q0 + TILE].long()
        seen = every = kp >= 0
        if causal:
            seen, every = seen & (kp <= qp.max()), every & (kp <= qp.min())
        if window is not None:
            seen = seen & (kp > qp.min() - window)
            every = every & (kp > qp.max() - window)
        fallback = DV_ONLY if bool(nokey[q0:q0 + TILE].any()) else SKIP
        code = torch.where(seen.any(dim=1), VISIT, fallback)
        out.append(torch.where(every.all(dim=1), NO_MASK, code).cpu())
    return torch.stack(out, dim=1).to(torch.int8)


def aligned_tiles(Sq: int, Sk: int, causal: bool, window: Optional[int],
                  rows: int) -> int:
    """The (group of ``rows`` queries, 64-key tile) pairs the kernels
    visit when the queries hold the last ``Sq`` of ``Sk`` contiguous
    positions, every key valid (a prefill or a training row): what
    :func:`visited_k_tiles` (``rows`` = :data:`GROUP`) and the visited
    entries of :func:`visited_q_tiles` (``rows`` = :data:`TILE`) count
    on those positions, without their (Sq, Sk) mask.  A group sees the
    tiles from the one holding its smallest position less the window
    (plus one) to the one holding its largest (causal; else the last)."""
    nk = -(-Sk // TILE)
    off = Sk - Sq
    n = 0
    for q0 in range(0, Sq, rows):
        lo, hi = off + q0, off + min(q0 + rows, Sq) - 1
        t_hi = min(nk - 1, hi // TILE) if causal else nk - 1
        t_lo = 0 if window is None else max(0, (lo - window + 1) // TILE)
        n += max(0, t_hi - t_lo + 1)
    return n


def _grouped(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """(B, H, S, d) → (B, KV, G, S, d) in f32: the query heads of one kv
    head side by side."""
    B, H, S, d = q.shape
    return q.float().reshape(B, kv_heads, H // kv_heads, S, d)


def _scores(q, k, q_pos, k_pos, scale, causal, window, cap):
    """(B, KV, G, Sq, Sk): the masked (capped) scores, the mask, and
    tanh(s/cap) for the backward (None without a cap)."""
    s = torch.einsum("bkgqd,bksd->bkgqs", _grouped(q, k.shape[1]),
                     k.float()) * scale
    t = None
    if cap is not None:
        t = torch.tanh(s / cap)
        s = cap * t
    msk = _mask(q_pos, k_pos, causal, window)
    return torch.where(msk, s, NEG), msk, t


def flash_fwd_plain(q, k, v, q_pos, k_pos, scale: float, causal: bool,
                    window: Optional[int], cap: Optional[float]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """o (B, H, Sq, d) in q's dtype and lse (B, H, Sq) f32.  A row whose
    keys are all masked gives the mean of v and lse = NEG + log Sk, as the
    reference kernel does (each key adds p = exp(0))."""
    B, H, Sq, d = q.shape
    s, _, _ = _scores(q, k, q_pos, k_pos, scale, causal, window, cap)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float()) / l[..., None]
    lse = m + torch.log(l)
    return (o.reshape(B, H, Sq, d).to(q.dtype), lse.reshape(B, H, Sq))


def _probs_and_ds(q, k, v, do, lse, delta, q_pos, k_pos, scale, causal,
                  window, cap):
    """p = exp(s - lse) (unmasked, as the reference's dk/dv kernel uses it)
    and ds = p·(dP - Δ)·(1 - t²), masked to 0."""
    KV = k.shape[1]
    s, msk, t = _scores(q, k, q_pos, k_pos, scale, causal, window, cap)
    B, _, G, Sq, _ = s.shape
    p = torch.exp(s - lse.reshape(B, KV, G, Sq)[..., None])
    dp = torch.einsum("bkgqd,bksd->bkgqs", _grouped(do, KV), v.float())
    ds = p * (dp - delta.reshape(B, KV, G, Sq)[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    return p, torch.where(msk, ds, 0.0)


def flash_dq_plain(q, k, v, do, lse, delta, q_pos, k_pos, scale: float,
                   causal: bool, window: Optional[int],
                   cap: Optional[float]) -> torch.Tensor:
    """dq (B, H, Sq, d) in q's dtype = (dS @ k) · scale."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, q_pos, k_pos, scale,
                          causal, window, cap)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.float()) * scale
    return dq.reshape(q.shape).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, q_pos, k_pos, scale: float,
                    causal: bool, window: Optional[int],
                    cap: Optional[float]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk = Σ_g (dSᵀ @ q) · scale and dv = Σ_g Pᵀ @ dO, (B, KV, Sk, d) in
    k's and v's dtypes."""
    KV = k.shape[1]
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, q_pos, k_pos, scale,
                          causal, window, cap)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, _grouped(q, KV)) * scale
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, _grouped(do, KV))
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the wrappers: the CUDA kernel for a CUDA tensor, the plain version for a
# CPU tensor
# ---------------------------------------------------------------------------

def _cost(call: ops.KernelCall, q_like: int, kv_like: int, rows: int,
          tile_products) -> ops.Cost:
    """``q_like`` (B, H, Sq, d) and ``kv_like`` (B, KV, Sk, d) tensors
    and ``rows`` f32 (B, H, Sq) rows read or written, and the positions;
    the operations of the kernel's own products over the tiles it visits
    (:func:`aligned_tiles`: a fake tensor holds no positions, so they
    are taken contiguous, the queries the last Sq — exact for a prefill
    or a training row, the most a context-parallel chunk visits),
    ``tile_products(k_tiles, q_tiles, split)`` 64x64 products of 2·d
    operations a pair, for each (b, h); ``split`` is 1 in bf16, whose
    products of p and dS run twice (hi and lo), 0 in f32, whose k tiles
    are visited by groups of 64 queries."""
    (B, H, Sq, d), (_, KV, Sk, _) = call.shapes[:2]
    _, causal, window, _ = call.statics
    dt = call.dtypes[0]
    size = ops.itemsize(dt)
    nbytes = (q_like * B * H * Sq * d + kv_like * B * KV * Sk * d) * size \
        + rows * B * H * Sq * 4 + (Sq + Sk) * 4
    split = int(dt == "bfloat16")
    group = GROUP if split else TILE
    k_tiles = aligned_tiles(Sq, Sk, causal, window, group) * group / TILE
    q_tiles = aligned_tiles(Sq, Sk, causal, window, TILE)
    tile = 2 * B * H * TILE ** 2 * d
    return ops.Cost(tile_products(k_tiles, q_tiles, split) * tile, nbytes,
                    ops.peak_of(dt), True)


def fwd_cost(call: ops.KernelCall) -> ops.Cost:
    """q, o; k, v; lse; q kᵀ and P v a k tile."""
    return _cost(call, 2, 2, 1, lambda kt, qt, split: (2 + split) * kt)


def dq_cost(call: ops.KernelCall) -> ops.Cost:
    """q, dO, dq; k, v; lse, Δ; q kᵀ, dO vᵀ and dS k a k tile."""
    return _cost(call, 3, 2, 2, lambda kt, qt, split: (3 + split) * kt)


def dkv_cost(call: ops.KernelCall) -> ops.Cost:
    """q, dO; k, v, dk, dv; lse, Δ; K Qᵀ, V dOᵀ, Pᵀ dO and dSᵀ q a
    visited q tile (no row lacks a key on contiguous positions)."""
    return _cost(call, 2, 4, 2,
                 lambda kt, qt, split: (4 + 2 * split) * qt)


def _check(name, q, k, v, q_pos, k_pos, *extra) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: need q (B, H, Sq, d) and k, v (B, KV, Sk,"
                         f" d), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, d = q.shape
    if k.shape[0] != B or k.shape[3] != d or H % k.shape[1]:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)}"
                         f" do not match (H must be a multiple of KV)")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError(f"{name}: q, k, v must share bfloat16 or float32, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if (q_pos.shape != (Sq,) or k_pos.shape != (k.shape[2],)
            or q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32):
        raise ValueError(f"{name}: positions must be int32 ({Sq},) and "
                         f"({k.shape[2]},), got {tuple(q_pos.shape)} "
                         f"{q_pos.dtype} and {tuple(k_pos.shape)} "
                         f"{k_pos.dtype}")
    tensors = (q, k, v, q_pos, k_pos, *extra)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: operands on different devices")


def _launch(name: str, fn: str, q, k, tensors, outs, scale, causal, window,
            cap) -> None:
    """Call the C entry point ``fn_{bf16,f32}`` on contiguous operands."""
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if not all(t.is_contiguous() for t in (*tensors, *outs)):
        raise ValueError(f"{name}: operands must be contiguous")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not taken by the kernel "
                         f"({HEAD_DIMS})")
    lib = build.load()
    suffix = "bf16" if q.dtype == torch.bfloat16 else "f32"
    rc = getattr(lib, f"{fn}_{suffix}")(
        *(build.ptr(t) for t in (*tensors, *outs)), B, H, KV, Sq, Sk, d,
        float(scale), int(causal), int(window or 0), int(window is not None),
        float(cap or 0.0), int(cap is not None), build.stream(q))
    build.check(rc, name)


@ops.logged("flash_fwd", fwd_cost)
def flash_fwd(q, k, v, q_pos, k_pos, scale: float, causal: bool,
              window: Optional[int], cap: Optional[float]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """o (B, H, Sq, d) in q's dtype and lse (B, H, Sq) f32."""
    global fwd_launches
    _check("flash_fwd", q, k, v, q_pos, k_pos)
    if not build.dispatch_device("flash_fwd", q):
        return flash_fwd_plain(q, k, v, q_pos, k_pos, scale, causal, window,
                               cap)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if build.is_fake(q):
        return o, lse
    _launch("flash_fwd", "flash_fwd", q, k, (q, k, v, q_pos, k_pos),
            (o, lse), scale, causal, window, cap)
    fwd_launches += 1
    return o, lse


def _check_bwd(name, q, k, v, do, lse, delta, q_pos, k_pos) -> None:
    _check(name, q, k, v, q_pos, k_pos, do, lse, delta)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{name}: dO must match q, got {tuple(do.shape)} "
                         f"{do.dtype}")
    if (lse.shape != q.shape[:3] or delta.shape != q.shape[:3]
            or lse.dtype != torch.float32 or delta.dtype != torch.float32):
        raise ValueError(f"{name}: lse and delta must be f32 "
                         f"{tuple(q.shape[:3])}")


@ops.logged("flash_dq", dq_cost)
def flash_dq(q, k, v, do, lse, delta, q_pos, k_pos, scale: float,
             causal: bool, window: Optional[int], cap: Optional[float]
             ) -> torch.Tensor:
    """dq (B, H, Sq, d) in q's dtype, from dO (q's dtype), the forward's
    lse and Δ = rowsum(dO∘O) (both (B, H, Sq) f32)."""
    global dq_launches
    _check_bwd("flash_dq", q, k, v, do, lse, delta, q_pos, k_pos)
    if not build.dispatch_device("flash_dq", q):
        return flash_dq_plain(q, k, v, do, lse, delta, q_pos, k_pos, scale,
                              causal, window, cap)
    dq = torch.empty_like(q)
    if build.is_fake(q):
        return dq
    _launch("flash_dq", "flash_dq", q, k,
            (q, k, v, do, lse, delta, q_pos, k_pos), (dq,), scale, causal,
            window, cap)
    dq_launches += 1
    return dq


@ops.logged("flash_dkv", dkv_cost)
def flash_dkv(q, k, v, do, lse, delta, q_pos, k_pos, scale: float,
              causal: bool, window: Optional[int], cap: Optional[float]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk, dv (B, KV, Sk, d) in k's dtype, each summed over the G query
    heads of its kv head and over all queries."""
    global dkv_launches
    _check_bwd("flash_dkv", q, k, v, do, lse, delta, q_pos, k_pos)
    if not build.dispatch_device("flash_dkv", q):
        return flash_dkv_plain(q, k, v, do, lse, delta, q_pos, k_pos, scale,
                               causal, window, cap)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    # scratch: whether each 64-row q tile holds a row with no allowed key
    nokey = torch.empty(-(-q.shape[2] // TILE), dtype=torch.int32,
                        device=q.device)
    if build.is_fake(q):
        return dk, dv
    _launch("flash_dkv", "flash_dkv", q, k,
            (q, k, v, do, lse, delta, q_pos, k_pos), (dk, dv, nokey), scale,
            causal, window, cap)
    dkv_launches += 1
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp`` (``_fa_fwd`` / ``_fa_bwd``): the
    forward saves q, k, v, the positions, o and lse; the backward computes
    Δ from the saved o in its own dtype (widened to f32), then runs the
    dq and the dk/dv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, scale, causal, window, cap):
        o, lse = flash_fwd(q, k, v, q_pos, k_pos, scale, causal, window, cap)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, o, lse)
        ctx.static = (scale, causal, window, cap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, k_pos, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        args = (q, k, v, do, lse, delta, q_pos, k_pos, *ctx.static)
        dq = flash_dq(*args) if ctx.needs_input_grad[0] else None
        dk = dv = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dk, dv = flash_dkv(*args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor, scale: float,
                    causal: bool, window: Optional[int],
                    cap: Optional[float], block_q: int = 512
                    ) -> torch.Tensor:
    """q (B, H, Sq, d), k/v (B, KV, Sk, d), positions int32 (Sq,)/(Sk,) →
    o (B, H, Sq, d); ``k_pos < 0`` marks invalid slots.  Differentiable in
    q, k and v.  ``block_q`` keeps the reference's signature and is
    ignored: the kernels tile by 64 rows."""
    return FlashAttention.apply(q, k, v, q_pos, k_pos, scale, causal,
                                window, cap)
