"""RWKV-6 "Finch" time mix (arXiv:2404.05892) — the port of
``repro/models/rwkv6.py``.

The per-channel decay ``w_t`` is data-dependent (a low-rank MLP of the
token-shifted input), as is the token-shift interpolation itself.
Recurrence per head (state S ∈ R^{hd×hd}):

    S_t = diag(w_t) · S_{t-1} + k_tᵀ v_t
    o_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)

Training and prefill use the chunked form (:func:`rwkv_time_mix`): within
a chunk of L tokens the pairwise decay factors as exp(cum_{t-1} − cum_s)
with cum = Σ log w, so the intra-chunk term is a masked (r̃ k̃ᵀ) product
and the inter-chunk term is carried by a loop over chunk states.  The
``exp(−cum)`` side is clipped at e³⁰ (``_CLIP``), so the result depends on
the chunk length L: the largest divisor of S no larger than
``chunk_size``, the reference's rule.  The reference scans the chunks one
by one; here every chunk's own terms are computed at once, batched over
the chunks, and only the carry of the state runs chunk by chunk
(:func:`_chunk_scan`): the same terms, a few launches a chunk instead of
a few dozen.  With grad enabled the scan is recomputed in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` does
each chunk's body: its inputs stay alive, not the (L, L) scores of every
chunk.  The scan runs in f32 on f32 r/k/v/log w,
and the decay LoRA (``decay_a``, ``decay_b``, ``w0``), ``u`` and ``ln_x``
are used in f32 whatever the compute dtype.

Decode (:func:`rwkv_decode_step`) is the raw recurrence: O(1) time and
memory per token.  Both return the new state; the caller writes it into
its cache (``models/transformer.py``, in place).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import draw
from repro_torch.core.config import RWKVConfig
from repro_torch.models.layers import rms_norm

_CLIP = 30.0
# leaves used in f32 whatever the compute dtype
F32_LEAVES = ("w0", "decay_a", "decay_b", "u", "ln_x")


def chunk_len(S: int, chunk_size: int) -> int:
    """The largest divisor of ``S`` no larger than ``chunk_size`` (a prime
    S gives 1): the chunk length of both recurrent scans."""
    L = min(chunk_size, S)
    while S % L:
        L -= 1
    return L


def init_rwkv_block(generator: torch.Generator, cfg: RWKVConfig, d: int, *,
                    device=None, dtype=torch.float32
                    ) -> Dict[str, torch.Tensor]:
    """One time mix, drawn from ``generator`` in a fixed order (the
    reference's leaves and scales); the projections cast to ``dtype``
    after their draws, the ``F32_LEAVES`` kept f32."""
    s = d ** -0.5
    r, dl = cfg.mix_lora, cfg.decay_lora
    kw = dict(device=device, dtype=dtype)
    p = {"mu": torch.rand((5, d), generator=generator,
                          device=device).to(dtype),
         "mix_a": draw(generator, (d, 5 * r), s, **kw),
         "mix_b": draw(generator, (5, r, d), r ** -0.5, **kw)}
    for n in ("wr", "wk", "wv", "wg", "wo"):
        p[n] = draw(generator, (d, d), s, **kw)
    p["w0"] = draw(generator, (d,), 0.1, device=device).add_(-6.0)
    p["decay_a"] = draw(generator, (d, dl), s, device=device)
    p["decay_b"] = draw(generator, (dl, d), dl ** -0.5, device=device)
    p["u"] = draw(generator, (d,), 0.1, device=device)
    p["ln_x"] = torch.ones((d,), device=device)
    return p


def _mix_inputs(p, x, x_prev):
    """Data-dependent token shift → the 5 mixed streams (r, k, v, w, g).
    x (B, S, d); x_prev is x shifted right one token."""
    dt = x.dtype
    delta = x_prev - x
    lora = torch.tanh(x @ p["mix_a"].to(dt))                   # (B,S,5*r)
    lora = lora.reshape(*x.shape[:-1], 5, -1)
    corr = torch.einsum("bsfr,frd->bsfd", lora, p["mix_b"].to(dt))
    mix = p["mu"].to(dt)[None, None] + corr                     # (B,S,5,d)
    return x[..., None, :] + delta[..., None, :] * mix


def _rkvwg(p, x, x_prev, H: int, hd: int):
    m = _mix_inputs(p, x, x_prev)
    dt = x.dtype
    B, S = x.shape[:2]
    r = (m[..., 0, :] @ p["wr"].to(dt)).reshape(B, S, H, hd)
    k = (m[..., 1, :] @ p["wk"].to(dt)).reshape(B, S, H, hd)
    v = (m[..., 2, :] @ p["wv"].to(dt)).reshape(B, S, H, hd)
    logw = -torch.exp(torch.clamp(
        (m[..., 3, :].float() @ p["decay_a"].float()) @ p["decay_b"].float()
        + p["w0"].float(), -8.0, 1.0)).reshape(B, S, H, hd)     # log w_t < 0
    g = F.silu(m[..., 4, :] @ p["wg"].to(dt))
    return r, k, v, logw, g


def _chunk_scan(r, k, v, logw, u, L: int):
    """The reference's ``_chunk_scan`` for every chunk of L tokens at
    once, then its loop over chunk states.  r, k, v, logw (B, S, H, hd)
    f32, u (H, hd).  Everything within a chunk depends only on the
    chunk's own inputs, so it runs batched over the chunks; only the
    carry S_{c+1} = diag(A_L) S_c + Σ_s diag(A_L/A_s) k_sᵀ v_s is
    sequential, two elementwise ops a chunk.  Returns (o (B, S, H, hd),
    the final state (B, H, hd, hd))."""
    B, S, H, hd = r.shape
    n = S // L
    r, k, v, logw = (a.reshape(B, n, L, H, hd) for a in (r, k, v, logw))
    cum = torch.cumsum(logw, dim=2)                      # within each chunk
    cum_in = cum - logw                                  # Σ_{i<t}
    r_dec = r * torch.exp(cum_in)                        # r̃_t
    k_dec = k * torch.exp(torch.clamp(-cum, max=_CLIP))  # k̃_s, clipped
    # the carry's terms, chunk-major (each chunk's contiguous in the loop):
    # the decay over the chunk and Σ_s diag(A_L/A_s) k_sᵀ v_s
    decay_all = torch.exp(cum[:, :, -1]).transpose(0, 1).contiguous()[
        ..., None]                                       # (n,B,H,hd,1)
    k_carry = k * torch.exp(torch.clamp(cum[:, :, -1:] - cum, max=_CLIP))
    kv = torch.einsum("bnlhc,bnlhv->nbhcv", k_carry, v).contiguous()
    state = torch.zeros((B, H, hd, hd), dtype=r.dtype, device=r.device)
    entering = []
    for c in range(n):
        entering.append(state)
        state = torch.addcmul(kv[c], decay_all[c], state)
    s0 = torch.stack(entering)                           # (n,B,H,hd,hd)
    # inter-chunk: o_t = r̃_t · S0; intra-chunk: strictly-lower pairs; the
    # diagonal bonus: (r_t · (u ⊙ k_t)) v_t
    o = torch.einsum("bnlhc,nbhcv->bnlhv", r_dec, s0)
    scores = torch.einsum("bnlhc,bnmhc->bnhlm", r_dec, k_dec)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device),
                      -1)
    scores = torch.where(mask, scores, 0.0)
    o = o + torch.einsum("bnhlm,bnmhv->bnlhv", scores, v)
    o = o + torch.sum(r * (u * k), dim=-1, keepdim=True) * v
    return o.reshape(B, S, H, hd), state


def _group_norm(o, ln_x, H: int, hd: int):
    """The per-head group norm over hd with the ``1 + scale`` RMSNorm of
    ``ln_x − 1``, as the reference applies it."""
    return rms_norm(o, ln_x.float().reshape(H, hd) - 1.0)


def rwkv_time_mix(p: Dict[str, torch.Tensor], x: torch.Tensor,
                  cfg: RWKVConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence (train / prefill) pass from the zero state (the
    reference's ``x_last=None``, the only form its model calls).  x (B, S,
    d) → (y, final state (B, H, hd, hd) f32)."""
    B, S, d = x.shape
    H, hd = d // cfg.head_dim, cfg.head_dim
    x_prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    r, k, v, logw, g = _rkvwg(p, x, x_prev, H, hd)
    u = p["u"].float().reshape(H, hd)
    args = (*(a.float() for a in (r, k, v, logw)), u,
            chunk_len(S, cfg.chunk_size))
    o, state = (checkpoint(_chunk_scan, *args, use_reentrant=False)
                if torch.is_grad_enabled() else _chunk_scan(*args))
    o = _group_norm(o, p["ln_x"], H, hd)
    y = (o.reshape(B, S, d).to(x.dtype) * g) @ p["wo"].to(x.dtype)
    return y, state


def init_rwkv_state(cfg: RWKVConfig, batch: int, d: int,
                    device=None) -> Dict[str, torch.Tensor]:
    H, hd = d // cfg.head_dim, cfg.head_dim
    return {"s": torch.zeros((batch, H, hd, hd), device=device),
            "x_last": torch.zeros((batch, d), device=device)}


def rwkv_decode_step(p: Dict[str, torch.Tensor], x: torch.Tensor, state,
                     cfg: RWKVConfig
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token.  x (B, 1, d); state {s (B, H, hd, hd), x_last (B, d)}
    → (y (B, 1, d), the new state)."""
    B, one, d = x.shape
    H, hd = d // cfg.head_dim, cfg.head_dim
    x_prev = state["x_last"].to(x.dtype)[:, None]
    r, k, v, logw, g = _rkvwg(p, x, x_prev, H, hd)
    r, k, v = (a.float()[:, 0] for a in (r, k, v))              # (B,H,hd)
    w = torch.exp(logw[:, 0])
    u = p["u"].float().reshape(H, hd)
    S0 = state["s"]
    kv = torch.einsum("bhc,bhv->bhcv", k, v)
    o = torch.einsum("bhc,bhcv->bhv", r, S0 + u[None, :, :, None] * kv)
    s_new = w[..., None] * S0 + kv
    o = _group_norm(o, p["ln_x"], H, hd)
    y = (o.reshape(B, 1, d).to(x.dtype) * g) @ p["wo"].to(x.dtype)
    return y, {"s": s_new, "x_last": x[:, 0].float()}

