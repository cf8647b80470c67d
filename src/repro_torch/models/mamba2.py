"""Mamba-2 (SSD) block — chunked scan for train/prefill, O(1) decode — the
port of ``repro/models/mamba2.py``.

State-space duality form (Dao & Gu 2024), scalar decay per head:

    S_t = a_t · S_{t-1} + Δ_t · (x_t ⊗ B_t)       S ∈ R^{hd×N}
    y_t = S_t C_t + D ⊙ x_t,   a_t = exp(-exp(A_log)·Δ_t)

Within a chunk of L tokens (the largest divisor of S no larger than
``chunk_size``) the pairwise decay ``exp(cum_l − cum_m)`` is at most 1 on
and below the diagonal; above it the exponent is a positive sum that
overflows f32 at the published sizes (A up to 16, 128 tokens).  The
reference forms the exponential over the whole (L, L) square and masks it
afterwards, so its backward multiplies a zero cotangent by ``inf`` and its
gradient is NaN at chunk 128.  Here the mask is applied to the exponent,
before ``exp`` (``−inf`` above the diagonal): the same forward, and a
finite gradient equal to the reference's at a chunk short enough not to
overflow (the chunked form has no clip, so it does not depend on L).

With ``n_groups`` groups of B and C shared by ``H / G`` heads each, the
products C·Bᵀ are formed once per group and broadcast over its heads
(the reference repeats B and C over the heads first): the same products,
summed in another order.  The reference scans the chunks one by one; here
every chunk's own terms are computed at once, batched over the chunks,
and only the carry of the state runs chunk by chunk (:func:`_ssd_chunk`).
With grad enabled the scan is recomputed in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` does
each chunk's body: its inputs stay alive, not the (L, L) decays of every
chunk.  The scan runs in f32; ``A_log``, ``D``,
``dt_bias`` and ``norm`` are used in f32 whatever the compute dtype.

Used by zamba2 (``models/transformer.py``: ``mamba`` and ``mamba_sa``).
The reference's ``_head_constraint`` is a sharding hint for a device mesh,
which the one-device port does not have.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import draw
from repro_torch.core.config import SSMConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.rwkv6 import chunk_len

# leaves used in f32 whatever the compute dtype
F32_LEAVES = ("A_log", "D", "dt_bias", "norm")


def _dims(cfg: SSMConfig, d: int):
    d_in = cfg.expand * d
    H = d_in // cfg.head_dim
    return d_in, H, cfg.n_groups, cfg.d_state


def init_mamba_block(generator: torch.Generator, cfg: SSMConfig, d: int, *,
                     device=None, dtype=torch.float32
                     ) -> Dict[str, torch.Tensor]:
    """One Mamba-2 block, drawn from ``generator`` in a fixed order (the
    reference's leaves and scales); ``w_in``, ``conv_w``, ``conv_b`` and
    ``w_out`` cast to ``dtype`` after their draws, the ``F32_LEAVES``
    kept f32."""
    d_in, H, G, N = _dims(cfg, d)
    conv_ch = d_in + 2 * G * N
    kw = dict(device=device, dtype=dtype)
    w_in = draw(generator, (d, 2 * d_in + 2 * G * N + H), d ** -0.5, **kw)
    conv_w = draw(generator, (cfg.conv_width, conv_ch),
                  cfg.conv_width ** -0.5, **kw)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt0 = torch.exp(torch.rand((H,), generator=generator, device=device)
                    * (hi - lo) + lo)
    return {
        "w_in": w_in,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_ch,), **kw),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)),
        "D": torch.ones((H,), device=device),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "norm": torch.zeros((d_in,), device=device),
        "w_out": draw(generator, (d_in, d), d_in ** -0.5, **kw),
    }


def _split_proj(p, u, cfg: SSMConfig, d: int):
    d_in, H, G, N = _dims(cfg, d)
    h = u @ p["w_in"].to(u.dtype)
    z = h[..., :d_in]
    xBC = h[..., d_in:2 * d_in + 2 * G * N]
    dt = h[..., 2 * d_in + 2 * G * N:]
    return z, xBC, dt


def _causal_conv(xBC, w, b, *, state=None):
    """Depthwise causal conv, width K.  xBC (B, S, C); ``state`` (B, K-1,
    C) holds the previous K-1 inputs (the decode carry).  Returns (out,
    new state), the new state a view of a fresh tensor (never of
    ``state``: a caller may copy it into the buffer it read)."""
    K = w.shape[0]
    if state is None:
        state = torch.zeros((xBC.shape[0], K - 1, xBC.shape[-1]),
                            dtype=xBC.dtype, device=xBC.device)
    full = torch.cat([state.to(xBC.dtype), xBC], dim=1)
    S = xBC.shape[1]
    out = sum(full[:, i:i + S] * w[i].to(xBC.dtype) for i in range(K))
    out = F.silu(out + b.to(xBC.dtype))
    return out, full[:, -(K - 1):]


def _ssd_chunk(C, Bm, X, loga, dt, L: int):
    """The reference's ``_ssd_chunk`` for every chunk of L tokens at once,
    then its loop over chunk states.  C/Bm (B, S, G, N) f32, X (B, S, H,
    hd), loga/dt (B, S, H).  Everything within a chunk depends only on
    the chunk's own inputs, so it runs batched over the chunks; only the
    carry S_{c+1} = exp(cum_L) S_c + Σ_s exp(cum_L − cum_s) Δ_s (x_s ⊗
    B_s) is sequential, two elementwise ops a chunk.  Returns (y (B, S,
    H, hd), the final state (B, H, hd, N))."""
    B, S, G, N = C.shape
    H, hd = X.shape[2:]
    n, R = S // L, H // G
    C, Bm = (a.reshape(B, n, L, G, N) for a in (C, Bm))
    X = X.reshape(B, n, L, H, hd)
    dt = dt.reshape(B, n, L, H)
    cum = torch.cumsum(loga.reshape(B, n, L, H), dim=2)  # within each chunk
    # the carry's terms: exp(cum_L) and Σ_s exp(cum_L − cum_s) Δ_s x_s ⊗ B_s
    # (chunk-major, so that each chunk's terms are contiguous in the loop)
    wlast = torch.exp(cum[:, :, -1:] - cum) * dt         # (B,n,L,H)
    xw = (X * wlast[..., None]).reshape(B, n, L, G, R, hd)
    ds = torch.einsum("bnlgrp,bnlgk->nbgrpk", xw, Bm).reshape(
        n, B, H, hd, N).contiguous()
    decay = torch.exp(cum[:, :, -1]).transpose(0, 1).contiguous()[
        ..., None, None]                                 # (n,B,H,1,1)
    state = torch.zeros((B, H, hd, N), dtype=X.dtype, device=X.device)
    entering = []
    for c in range(n):
        entering.append(state)
        state = torch.addcmul(ds[c], decay[c], state)
    s0 = torch.stack(entering).reshape(n, B, G, R, hd, N)
    # inter-chunk: y_t = exp(cum_t) · C_t S0
    y = torch.einsum("bnlgk,nbgrpk->bnlgrp", C, s0).reshape(B, n, L, H, hd)
    y = y * torch.exp(cum)[..., None]
    # intra-chunk: pairwise scalar decays exp(cum_l − cum_m), masked in
    # the exponent so that nothing above the diagonal overflows; C·Bᵀ once
    # per group
    cum_t = cum.transpose(2, 3)                          # (B,n,H,L)
    diff = cum_t[..., :, None] - cum_t[..., None, :]     # (B,n,H,L,L)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=X.device))
    pair = torch.exp(torch.where(mask, diff, -math.inf))
    cb = torch.einsum("bnlgk,bnmgk->bnglm", C, Bm)       # (B,n,G,L,L)
    scores = (cb[:, :, :, None] * pair.reshape(B, n, G, R, L, L)
              * dt.transpose(2, 3).reshape(B, n, G, R, 1, L))
    y = y + torch.einsum("bnhlm,bnmhp->bnlhp", scores.reshape(B, n, H, L, L),
                         X)
    return y.reshape(B, S, H, hd), state


def mamba_forward(p: Dict[str, torch.Tensor], u: torch.Tensor,
                  cfg: SSMConfig, d: int
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence pass.  u (B, S, d) → (y (B, S, d), the final state
    {s (B, H, hd, N) f32, conv (B, K-1, C), pos})."""
    B, S, _ = u.shape
    d_in, H, G, N = _dims(cfg, d)
    hd = cfg.head_dim
    z, xBC, dt = _split_proj(p, u, cfg, d)
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    x = xBC[..., :d_in].reshape(B, S, H, hd).float()
    Bm = xBC[..., d_in:d_in + G * N].reshape(B, S, G, N).float()
    Cm = xBC[..., d_in + G * N:].reshape(B, S, G, N).float()
    dt = F.softplus(dt.float() + p["dt_bias"].float())          # (B,S,H)
    loga = -torch.exp(p["A_log"].float())[None, None] * dt      # log a_t ≤ 0
    args = (Cm, Bm, x, loga, dt, chunk_len(S, cfg.chunk_size))
    y, state = (checkpoint(_ssd_chunk, *args, use_reentrant=False)
                if torch.is_grad_enabled() else _ssd_chunk(*args))
    y = y + p["D"].float()[None, None, :, None] * x
    y = y.reshape(B, S, d_in).to(u.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    pos = torch.full((), S, dtype=torch.int32, device=u.device)
    return y @ p["w_out"].to(u.dtype), {"s": state, "conv": conv_state,
                                        "pos": pos}


def init_mamba_state(cfg: SSMConfig, batch: int, d: int,
                     device=None) -> Dict[str, torch.Tensor]:
    d_in, H, G, N = _dims(cfg, d)
    return {"s": torch.zeros((batch, H, cfg.head_dim, N), device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1,
                                 d_in + 2 * G * N), device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def mamba_decode_step(p: Dict[str, torch.Tensor], u: torch.Tensor, state,
                      cfg: SSMConfig, d: int
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token.  u (B, 1, d) → (y (B, 1, d), the new state)."""
    B = u.shape[0]
    d_in, H, G, N = _dims(cfg, d)
    hd = cfg.head_dim
    R = H // G
    z, xBC, dt = _split_proj(p, u, cfg, d)
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                   state=state["conv"])
    x = xBC[:, 0, :d_in].reshape(B, H, hd).float()
    Bm = xBC[:, 0, d_in:d_in + G * N].reshape(B, G, N).float()
    Cm = xBC[:, 0, d_in + G * N:].reshape(B, G, N).float()
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"].float())    # (B,H)
    a = torch.exp(-torch.exp(p["A_log"].float())[None] * dt)
    xdt = (x * dt[..., None]).reshape(B, G, R, hd)
    s_new = a[..., None, None] * state["s"] + torch.einsum(
        "bgrp,bgn->bgrpn", xdt, Bm).reshape(B, H, hd, N)
    y = torch.einsum("bgrpn,bgn->bgrp", s_new.reshape(B, G, R, hd, N),
                     Cm).reshape(B, H, hd) + p["D"].float()[None, :, None] * x
    y = y.reshape(B, 1, d_in).to(u.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    return y @ p["w_out"].to(u.dtype), {"s": s_new, "conv": conv_state,
                                        "pos": state["pos"] + 1}
