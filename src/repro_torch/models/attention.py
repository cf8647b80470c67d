"""Grouped-query attention with RoPE and KV caches — the port of
``repro/models/attention.py`` on one device.

``full_attention`` (training, prefill) takes two paths, as the
reference's does: up to ``q_chunk`` tokens the plain ``_attend`` (scores
and softmax in f32, the value product with p rounded to v's dtype);
longer sequences the flash-attention kernels
(``kernels/flash_attention.py``: forward, dq and dk/dv, every product in
f32), differentiable through their ``autograd.Function``.  Decode steps
attend over the cache with ``_attend``: a linear cache (slot = position)
or, for a windowed layer whose cache is as long as its window, a ring
(position p at slot p % W), which holds a window's keys at any sequence
length.  ``REPRO_FLASH=0`` (:func:`use_flash`) turns the flash path
into the reference's chunked baseline: each chunk of ``q_chunk`` query
rows attended by ``_attend`` against every key, under
``torch.utils.checkpoint``, so one chunk's scores live at a time.

Across ranks a rank's queries are its own token block
(``launch/mesh.token_block``).  When ``n`` ranks share a row (``block``
with ``n > 1``) each holds a chunk of S/n positions: q stays local, k and
v are all-gathered over the row group (``launch/shard.row_gather``, whose
backward reduce-scatters dk and dv back to their chunks), and the
chunk's q positions attend the whole row's k positions — the
reference's context-parallel ``_flash_path`` (q's sequence over
``model``, k and v gathered once), as a layout of the same function.
The path is chosen by the whole row's length against ``q_chunk``, as
the reference chooses by its global S.

Served across ranks, a rank stores only its block of each decode cache
(``launch/shard.cache_layout_for``, the reference's ``cache_shardings``):
its rows, and over the ``model`` group one inner dim, described by a
``models/cache_cut.CacheCut``.  ``heads``: the rank's kv heads (GQA groups are
contiguous, so kv heads ``[m·KV/M, (m+1)·KV/M)`` serve query heads
``[m·H/M, (m+1)·H/M)``): a decode step computes q, k and v for those heads
only, from column views of the whole ``wq``/``wk``/``wv``, attends over
its cache slice, all-gathers the heads' outputs over ``model`` and
applies the whole ``wo``.  ``positions``: the rank's W/M of the cache's
slots: the slot's owner writes the new k/v, every rank attends over its
slots and returns ``(o, row max, row sum)`` in f32, and the partial
results are merged over ``model`` by the log-sum-exp rule.
``channels`` (neither the kv heads nor the slots divide): the rank's
hd/M of each head's channels: q, k and v are computed whole (RoPE pairs
channels across the head), every rank writes its channel block of the
new k and v, the partial scores ``q_blk · k_blkᵀ`` are summed over
``model`` in f32 before the scale, softcap, mask and softmax, and the
rank's ``p · v_blk`` is all-gathered on hd before the whole ``wo``.
``whole``: no cut over ``model`` (one model rank, or no inner dim
divides).  :func:`fill_cache` writes the rank's block of a prefill's
whole-row keys and values.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import draw
from repro_torch.core.config import AttentionConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.cache_cut import CacheCut
from repro_torch.models.layers import rms_norm, softcap as _softcap


def init_attention(generator: torch.Generator, cfg: AttentionConfig,
                   d_model: int, *, device=None,
                   dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The projections drawn in ``dtype`` (each cast after its draw); the
    qk-norm scales stay f32, as they are used."""
    hd = cfg.head_dim or d_model // cfg.num_heads

    def randn(scale, *shape):
        return draw(generator, shape, scale, device=device, dtype=dtype)

    s = d_model ** -0.5
    p = {"wq": randn(s, d_model, cfg.num_heads * hd),
         "wk": randn(s, d_model, cfg.num_kv_heads * hd),
         "wv": randn(s, d_model, cfg.num_kv_heads * hd),
         "wo": randn((cfg.num_heads * hd) ** -0.5, cfg.num_heads * hd,
                     d_model)}
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), device=device)
        p["k_norm"] = torch.zeros((hd,), device=device)
    return p


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x (..., S, n, hd), positions (..., S) → rotated x."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq                # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _qkv(params, x, cfg: AttentionConfig, positions):
    B, S, d = x.shape
    hd = cfg.head_dim or d // cfg.num_heads
    dt = x.dtype
    q = (x @ params["wq"].to(dt)).reshape(B, S, cfg.num_heads, hd)
    k = (x @ params["wk"].to(dt)).reshape(B, S, cfg.num_kv_heads, hd)
    v = (x @ params["wv"].to(dt)).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(q, k, v, q_pos, k_pos, *, causal: bool, window: Optional[int],
            cap: Optional[float], scale: float, partial=None):
    """q (B,Q,H,hd), k/v (B,S,KV,hd), positions (Q,)/(S,); k_pos < 0 marks
    an invalid slot.  GQA: head h reads kv head h // (H/KV).  Scores and
    softmax in f32, the value product in v's dtype.  ``partial``: q and k
    are blocks of the head's channels, and ``partial`` sums their f32
    scores over the blocks before the scale.  Returns (B,Q,H,hd)."""
    B, Q, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Q, KV, H // KV, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    if partial is not None:
        s = partial(s)
    s = s * scale
    if cap is not None:
        s = _softcap(s, cap)
    m = (k_pos >= 0)[None, :]
    if causal:
        m = m & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        m = m & (k_pos[None, :] > q_pos[:, None] - window)
    s = torch.where(m, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return o.reshape(B, Q, H, hd)


def full_attention(params: Dict[str, torch.Tensor], x: torch.Tensor,
                   cfg: AttentionConfig, *, positions: torch.Tensor,
                   causal: bool = True, window: Optional[int] = None,
                   q_chunk: int = 512, block=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Train/prefill pass over x (B, S, d) at ``positions`` (S,).  Returns
    (y, kv) — kv, the (B, row, KV, hd) keys and values of this rank's
    whole rows (gathered over the row group when ``block`` splits them),
    fills caches.
    ``block`` (a ``launch/mesh.TokenBlock`` with ``n > 1``: x is this
    rank's chunk of its rows, ``positions`` the chunk's) attends over
    the whole rows, k and v gathered over the row group (module
    docstring)."""
    B, S, d = x.shape
    q, k, v = _qkv(params, x, cfg, positions[None, :])
    k_pos = positions
    if block is not None and block.n > 1:
        from repro_torch.launch import shard
        both = shard.row_gather(torch.stack([k, v]), block, dim=2)
        k, v = both[0], both[1]
        k_pos = torch.arange(block.S, dtype=positions.dtype,
                             device=positions.device)
    kv = {"k": k, "v": v}
    row = k.shape[1]                       # the whole row's length
    scale = q.shape[-1] ** -0.5
    st = dict(causal=causal, window=window if window is not None
              else cfg.window, cap=cfg.attn_softcap, scale=scale)
    if row <= q_chunk:
        o = _attend(q, k, v, positions, k_pos, **st)
    elif use_flash():
        o = _flash_path(q, k, v, positions, k_pos, **st)
    else:
        if row % q_chunk:
            raise ValueError(f"the chunked path (REPRO_FLASH=0) needs S={row} "
                             f"divisible by q_chunk={q_chunk}")
        o = _chunked_path(q, k, v, positions, k_pos, q_chunk, **st)
    y = o.reshape(B, S, -1).to(x.dtype) @ params["wo"].to(x.dtype)
    return y, kv


def use_flash() -> bool:
    """The flash path toggle: on unless ``REPRO_FLASH=0``, which turns
    sequences past ``q_chunk`` to the reference's chunked baseline."""
    return os.environ.get("REPRO_FLASH", "1") == "1"


def _chunked_path(q, k, v, q_pos, k_pos, q_chunk, **st):
    """The reference's ``REPRO_FLASH=0`` path: ``_attend`` over chunks of
    at most ``q_chunk`` of this rank's query rows, each against every key
    and recomputed in the backward (``torch.utils.checkpoint``), so only
    one chunk's (q_chunk, S) scores are kept."""
    def one(qi, pi):
        return _attend(qi, k, v, pi, k_pos, **st)
    outs = [checkpoint(one, qi, pi, use_reentrant=False)
            if torch.is_grad_enabled() else one(qi, pi)
            for qi, pi in zip(q.split(q_chunk, dim=1),
                              q_pos.split(q_chunk), strict=True)]
    return torch.cat(outs, dim=1)


def _flash_path(q, k, v, q_pos, k_pos, *, causal, window, cap, scale):
    """The flash kernels over (B, Sq, H, hd) q and (B, Sk, KV, hd) k, v: to
    the kernels' head-major layout and back, as the reference's
    ``_flash_path``."""
    def heads(t):
        return t.transpose(1, 2).contiguous()
    o = flash_attention(heads(q), heads(k), heads(v),
                        q_pos.to(torch.int32), k_pos.to(torch.int32), scale,
                        causal, window, cap)
    return o.transpose(1, 2)


# ---------------------------------------------------------------------------
# decode caches: {"k", "v": (B, L, KV, hd), "pos": 0-d int32 tensor on the
# cache's device}, updated in place (the reference returns new arrays;
# writing the slot in place saves a copy of the whole cache per step).  No
# tensor of a cache changes its address, and a decode step reads nothing
# on the host, so a CUDA graph can hold the step (serving/engine.py).
# ---------------------------------------------------------------------------

def init_cache(cfg: AttentionConfig, batch: int, cache_len: int,
               d_model: int, dtype, device=None) -> Dict[str, object]:
    hd = cfg.head_dim or d_model // cfg.num_heads
    shape = (batch, cache_len, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def cache_length(cache: Dict[str, object],
                 cut: Optional[CacheCut] = None) -> int:
    """The slots of the whole cache ``cache`` is this rank's block of."""
    if cut is not None and cut.cuts and cut.form == "positions":
        return cut.length
    return cache["k"].shape[1]


def _cut_slice(cut: Optional[CacheCut], size: int) -> slice:
    """This rank's block of ``size`` (kv heads or slots) under ``cut``."""
    if cut is None or not cut.cuts:
        return slice(0, size)
    b = size // cut.n
    return slice(cut.index * b, (cut.index + 1) * b)


def fill_cache(cache: Dict[str, object], kv: Dict[str, torch.Tensor], *,
               ring: bool = False,
               cut: Optional[CacheCut] = None) -> Dict[str, object]:
    """Write a prefill's (B, S, KV, hd) keys/values into the cache.  A ring
    cache of W slots keeps position p at slot p % W, so that decode's slot
    arithmetic continues after a prefill of S >= W tokens, of which it
    keeps the last W (the reference's ``fill_cache(ring=True)``).  With
    ``cut`` the cache is this rank's block and ``kv`` the whole rows':
    the rank's kv heads or channels of them, or its slots of the whole
    cache's image (a ring's rolled first, then cut)."""
    S = kv["k"].shape[1]
    W = cache_length(cache, cut)
    if cut is not None and cut.block_dim is not None:
        kv = {n: cut.take(kv[n], cut.block_dim) for n in ("k", "v")}
    slots = (_cut_slice(cut, W) if cut is not None
             and cut.form == "positions" else slice(0, W))
    if ring and S >= W:
        # row i of the last W holds position S - W + i, slot (S - W + i) % W
        for n in ("k", "v"):
            whole = torch.roll(kv[n][:, S - W:], shifts=S % W, dims=1)
            cache[n].copy_(whole[:, slots])
        cache["pos"].fill_(S)
        return cache
    if S > W:
        raise ValueError(f"prefill of {S} tokens does not fit a cache of "
                         f"{W}")
    lo, hi = slots.start, min(slots.stop, S)
    if hi > lo:
        cache["k"][:, :hi - lo] = kv["k"][:, lo:hi].to(cache["k"].dtype)
        cache["v"][:, :hi - lo] = kv["v"][:, lo:hi].to(cache["v"].dtype)
    cache["pos"].fill_(S)
    return cache


def _slot_positions(pos, idx, W: int, ring: bool):
    """The position each slot ``idx`` of a cache of ``W`` slots holds at
    decode position ``pos`` (-1: none yet)."""
    if ring:
        # slot s holds position pos - ((pos - s) mod W); negatives invalid
        k_pos = pos - torch.remainder(pos - idx, W)
        return torch.where(k_pos >= 0, k_pos, -1)
    return torch.where(idx <= pos, idx, -1)


def decode_attention(params: Dict[str, torch.Tensor], x: torch.Tensor,
                     cache: Dict[str, object], cfg: AttentionConfig, *,
                     ring: bool = False, window: Optional[int] = None,
                     cut: Optional[CacheCut] = None
                     ) -> Tuple[torch.Tensor, Dict[str, object]]:
    """One-token decode.  x (B, 1, d).  ``ring=True``: the cache is a ring
    of W slots (its length the window), written at slot pos % W — W
    positions of memory at any sequence length.  The position is read on
    the device only: a linear cache that is full is the caller's to refuse
    (the host mirrors of ``engine.generate`` and ``SlotServer``).
    ``cut``: the cache is this rank's block over the ``model`` group, in
    the ``heads`` form (q, k and v of the rank's heads, their outputs
    all-gathered over ``model`` before the whole ``wo``), the
    ``channels`` form (the partial scores summed over ``model``, the
    outputs' channel blocks all-gathered) or the ``positions`` form
    (module docstring)."""
    B, one, d = x.shape
    if one != 1:
        raise ValueError(f"decode_attention takes one token, got {one}")
    form = cut.form if cut is not None and cut.cuts else "whole"
    if form == "positions":
        return _decode_positions(params, x, cache, cfg, ring, window, cut)
    proj, acfg = (_head_view(params, cfg, cut, d) if form == "heads"
                  else (params, cfg))
    pos = cache["pos"]
    W = cache["k"].shape[1]
    pos_t = pos.reshape(1)
    q, k_new, v_new = _qkv(proj, x, acfg, pos_t[None, :])
    scale = q.shape[-1] ** -0.5
    if form == "channels":
        q, k_new, v_new = (cut.take(t, cut.block_dim)
                           for t in (q, k_new, v_new))
    slot = (torch.remainder(pos_t, W) if ring else pos_t).long()
    cache["k"].index_copy_(1, slot, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v_new.to(cache["v"].dtype))
    idx = torch.arange(W, dtype=torch.int32, device=x.device)
    k_pos = _slot_positions(pos, idx, W, ring)
    win = window if window is not None else cfg.window
    o = _attend(q, cache["k"], cache["v"], pos_t, k_pos, causal=True,
                window=win, cap=cfg.attn_softcap, scale=scale,
                partial=cut.sum if form == "channels" else None)
    if cut is not None and cut.block_dim is not None:
        o = cut.gather(o, cut.block_dim)
    y = o.reshape(B, 1, -1).to(x.dtype) @ params["wo"].to(x.dtype)
    pos.add_(1)
    return y, cache


def _head_view(params, cfg: AttentionConfig, cut: CacheCut, d: int):
    """The ``heads`` form's projections: column views of the whole
    ``wq``/``wk``/``wv`` for the rank's kv heads and their query heads
    (GQA groups are contiguous), and the config of that many heads."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    hd = cfg.head_dim or d // H
    qh, kh = _cut_slice(cut, H), _cut_slice(cut, KV)
    view = dict(params)
    view["wq"] = params["wq"][:, qh.start * hd:qh.stop * hd]
    view["wk"] = params["wk"][:, kh.start * hd:kh.stop * hd]
    view["wv"] = params["wv"][:, kh.start * hd:kh.stop * hd]
    return view, dataclasses.replace(cfg, num_heads=qh.stop - qh.start,
                                     num_kv_heads=kh.stop - kh.start,
                                     head_dim=hd)


def _decode_positions(params, x, cache, cfg: AttentionConfig, ring, window,
                      cut: CacheCut):
    """The ``positions`` form: the slot's owner writes the new k/v (the
    others write back what they hold, so no rank reads the position on
    the host); each rank attends over its slots, the partial ``(o, row
    max, row sum)`` in f32 all-gathered over the model group and merged
    by the log-sum-exp rule."""
    from repro_torch.core import alltoall
    B, _, d = x.shape
    W, Wl = cut.length, cache["k"].shape[1]
    lo = cut.index * Wl
    pos = cache["pos"]
    pos_t = pos.reshape(1)
    q, k_new, v_new = _qkv(params, x, cfg, pos_t[None, :])
    slot = torch.remainder(pos_t, W) if ring else pos_t
    local = (slot - lo).long()
    mine = (local >= 0) & (local < Wl)
    at = local.clamp(0, Wl - 1)
    for n, new in (("k", k_new), ("v", v_new)):
        old = cache[n].index_select(1, at)
        cache[n].index_copy_(1, at, torch.where(
            mine, new.to(cache[n].dtype), old))
    idx = lo + torch.arange(Wl, dtype=torch.int32, device=x.device)
    k_pos = _slot_positions(pos, idx, W, ring)
    win = window if window is not None else cfg.window
    H, hd = q.shape[2], q.shape[3]
    KV = cache["k"].shape[2]
    qg = q.reshape(B, 1, KV, H // KV, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                     cache["k"].float()) * hd ** -0.5
    if cfg.attn_softcap is not None:
        s = _softcap(s, cfg.attn_softcap)
    m = (k_pos >= 0) & (k_pos <= pos_t)
    if win is not None:
        m = m & (k_pos > pos_t - win)
    s = torch.where(m, s, -1e30)
    mx = s.amax(-1, keepdim=True)                          # (B,KV,G,1,1)
    p = torch.where(m, torch.exp(s - mx), 0.0)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, cache["v"].float())
    part = torch.cat([o, mx, p.sum(-1, keepdim=True)], dim=-1)
    parts = alltoall.gather_dim(part.reshape(B, H, hd + 2).contiguous(),
                                cut.group, cut.n, 0, "model")
    parts = parts.reshape(cut.n, B, H, hd + 2)
    o_i, m_i, l_i = parts[..., :hd], parts[..., hd:hd + 1], parts[..., hd + 1:]
    w = torch.exp(m_i - m_i.amax(0, keepdim=True))
    o = (w * o_i).sum(0) / (w * l_i).sum(0)                # (B, H, hd)
    y = o.reshape(B, 1, -1).to(x.dtype) @ params["wo"].to(x.dtype)
    pos.add_(1)
    return y, cache
