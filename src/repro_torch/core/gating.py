"""Gating — the port of ``repro/core/gating.py``: all eight strategies.

Every strategy maps router logits ``(S, E)`` to a :class:`GateOutput` with
shapes ``(S, K)``, ``K = gate_k(cfg)``.  The gate runs in ``router_dtype``
(default f32).  As in the reference, only ``topk`` and ``switch`` go
through the fused top-k gate kernel; ``gshard``, ``ktop1``, ``sam``,
``base`` (Sinkhorn, 8 sweeps in log space), ``hash`` and
``dense_to_sparse`` are plain torch on every device, as the reference
runs them as plain XLA.  Ties break to the lowest index everywhere
(``argmax``, or a stable sort past k = 2), as the reference's iterative
max and ``lax.top_k`` do.

**Noise is an input.**  ``gshard`` takes the Gumbel draw that
``jax.random.categorical`` adds to its log-probabilities before the
argmax, and ``dense_to_sparse`` the uniform draw ``u ∈ [1e-6, 1)`` that
``jax.random.uniform`` gives; both of shape (S, E) (:func:`needs_noise`,
:func:`draw_noise`).  Without one, ``gshard`` takes the deterministic
second argmax and ``dense_to_sparse`` no noise, as the reference does
without an rng.  The port's own draws come from a ``torch.Generator``:
the same distributions as JAX's, not the same bits — the parity tests
hand the port JAX's draws.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.config import MoEConfig
from repro_torch.kernels import ops

# the strategies whose routing draws random numbers (gate noise)
NOISY_GATES = ("gshard", "dense_to_sparse")
# dense_to_sparse's uniform lower bound (the reference's minval)
_D2S_UMIN = 1e-6


class GateOutput(NamedTuple):
    """``expert_index`` (S, K) int32, ``combine_weights`` (S, K) f32,
    ``router_probs`` (S, E) f32, ``logits`` (S, E) f32."""
    expert_index: torch.Tensor
    combine_weights: torch.Tensor
    router_probs: torch.Tensor
    logits: torch.Tensor

    @property
    def k(self) -> int:
        return self.expert_index.shape[-1]


def gate_k(cfg: MoEConfig) -> int:
    """Static number of assignment slots per token for a strategy (the
    reference's contract, for every strategy)."""
    if cfg.gate in ("switch", "base", "hash"):
        return 1
    if cfg.gate == "gshard":
        return 2
    if cfg.gate == "ktop1":
        return cfg.num_prototypes
    if cfg.gate == "sam":
        return min(cfg.top_k, cfg.num_experts // cfg.num_groups)
    return cfg.top_k


def needs_noise(cfg: MoEConfig) -> bool:
    return cfg.gate in NOISY_GATES


def draw_noise(cfg: MoEConfig, shape, generator: torch.Generator,
               device=None) -> Optional[torch.Tensor]:
    """The gate's random input of ``shape`` (S, E) from ``generator``:
    Gumbel(0, 1) for ``gshard`` (uniform in [tiny, 1), then -log(-log u),
    as ``jax.random.gumbel``), uniform in [1e-6, 1) for
    ``dense_to_sparse``; None for the other strategies."""
    if not needs_noise(cfg):
        return None
    lo = (_D2S_UMIN if cfg.gate == "dense_to_sparse"
          else torch.finfo(torch.float32).tiny)
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    u = torch.clamp(u * (1.0 - lo) + lo, min=lo)
    return u if cfg.gate == "dense_to_sparse" else -torch.log(-torch.log(u))


def _one_hot(idx: torch.Tensor, E: int) -> torch.Tensor:
    """(S,) → (S, E) bool, by comparison (``F.one_hot`` checks its input's
    range on the host)."""
    return idx[:, None] == torch.arange(E, device=idx.device)


def _topk(x: torch.Tensor, k: int):
    """Top-k values and int32 indices, ties to the lowest index: iterative
    argmax for k ≤ 2 (the reference's fast path), a stable descending sort
    past it (``lax.top_k``'s order)."""
    if k == 1:
        idx = torch.argmax(x, dim=-1, keepdim=True)
        return x.gather(-1, idx), idx.to(torch.int32)
    if k == 2:
        i1 = torch.argmax(x, dim=-1, keepdim=True)
        v1 = x.gather(-1, i1)
        masked = torch.where(_one_hot(i1[..., 0], x.shape[-1]),
                             float("-inf"), x)
        i2 = torch.argmax(masked, dim=-1, keepdim=True)
        v2 = masked.gather(-1, i2)
        return (torch.cat([v1, v2], -1),
                torch.cat([i1, i2], -1).to(torch.int32))
    val, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k].to(torch.int32)


# ---------------------------------------------------------------------------
# the strategies that run as plain torch
# ---------------------------------------------------------------------------

def _gate_gshard(cfg, logits, noise, token_ids):
    """Top-2; the second expert sampled ∝ prob by the Gumbel draw
    ``noise`` (the deterministic second argmax without it)."""
    probs = torch.softmax(logits, dim=-1)
    E = logits.shape[-1]
    i1 = torch.argmax(probs, dim=-1)
    g1 = probs.gather(-1, i1[:, None])[:, 0]
    first = _one_hot(i1, E)
    masked = torch.where(first, 0.0, probs)
    if noise is not None:
        # the first expert's slot is -inf in log space (never resampled)
        i2 = torch.argmax(torch.where(first, float("-inf"),
                                      torch.log(probs + 1e-9)) + noise,
                          dim=-1)
    else:
        i2 = torch.argmax(masked, dim=-1)
    g2 = masked.gather(-1, i2[:, None])[:, 0]
    denom = g1 + g2 + 1e-9
    idx = torch.stack([i1, i2], dim=-1).to(torch.int32)
    weights = torch.stack([g1 / denom, g2 / denom], dim=-1)
    return GateOutput(idx, weights, probs, logits)


def _gate_ktop1(cfg, logits, noise, token_ids):
    """M6-T: E = P·(E/P) prototypes; Top-1 inside each prototype."""
    S, E = logits.shape
    P = cfg.num_prototypes
    assert E % P == 0, f"ktop1: {E} experts not divisible by {P} prototypes"
    per = E // P
    lp = logits.reshape(S, P, per)
    probs_p = torch.softmax(lp, dim=-1)
    local = torch.argmax(lp, dim=-1)                       # (S, P)
    w = probs_p.gather(-1, local[..., None])[..., 0]
    idx = local + torch.arange(P, device=logits.device)[None, :] * per
    probs = probs_p.reshape(S, E) / P
    return GateOutput(idx.to(torch.int32), w, probs, logits)


def _gate_sam(cfg, logits, noise, token_ids):
    """SAM: a Switch router picks one group of experts, Mixture Top-k
    inside it."""
    S, E = logits.shape
    G = cfg.num_groups
    assert E % G == 0, f"sam: {E} experts not divisible by {G} groups"
    per = E // G
    k = min(cfg.top_k, per)
    lg = logits.reshape(S, G, per)
    group_score = torch.logsumexp(lg, dim=-1)              # (S, G)
    gsel = torch.argmax(group_score, dim=-1)               # (S,)
    chosen = lg.gather(1, gsel[:, None, None].expand(S, 1, per))[:, 0]
    val, local = _topk(chosen, k)
    weights = torch.softmax(val, dim=-1)
    idx = local + (gsel[:, None] * per).to(torch.int32)
    group_probs = torch.softmax(group_score, dim=-1)
    probs = (torch.softmax(lg, dim=-1) * group_probs[..., None]).reshape(S, E)
    return GateOutput(idx.to(torch.int32), weights, probs, logits)


def _gate_base(cfg, logits, noise, token_ids, n_iters: int = 8,
               eps: float = 1.0):
    """BASE layer via Sinkhorn: ``n_iters`` row/column normalisations in
    log space, then the per-token argmax of the transport plan; weights
    σ(score) of the assigned expert."""
    S, E = logits.shape
    log_pi = logits / eps
    log_ratio = torch.full((), S / E, dtype=log_pi.dtype,
                           device=log_pi.device).log()
    for _ in range(n_iters):
        log_pi = log_pi - torch.logsumexp(log_pi, dim=1, keepdim=True)
        log_pi = (log_pi - torch.logsumexp(log_pi, dim=0, keepdim=True)
                  + log_ratio)
    idx = torch.argmax(log_pi, dim=-1, keepdim=True).to(torch.int32)
    score = logits.gather(-1, idx.long())
    weights = torch.sigmoid(score)
    probs = torch.softmax(logits, dim=-1)
    return GateOutput(idx, weights, probs, logits)


def _knuth_hash(ids: torch.Tensor) -> torch.Tensor:
    """``(h * 2654435761) ^ (h >> 16)`` in uint32 arithmetic, emulated in
    int64: h is the id's low 32 bits, and the product is formed from h's
    two 16-bit halves so no int64 product overflows."""
    mask = 0xFFFFFFFF
    h = ids.to(torch.int64) & mask
    m = 2654435761
    lo, hi = h & 0xFFFF, h >> 16
    prod = (lo * m + (((hi * m) & 0xFFFF) << 16)) & mask
    return prod ^ (h >> 16)


def _gate_hash(cfg, logits, noise, token_ids):
    """Hash layer: parameter-free token-id bucketing (Roller et al.)."""
    S, E = logits.shape
    if token_ids is None:
        raise ValueError("hash gate requires token_ids")
    idx = (_knuth_hash(token_ids.reshape(-1)) % E).to(torch.int32)[:, None]
    weights = torch.ones((S, 1), dtype=logits.dtype, device=logits.device)
    probs = _one_hot(idx[:, 0], E).to(logits.dtype)
    return GateOutput(idx, weights, probs, logits)


def _gate_dense_to_sparse(cfg, logits, noise, token_ids):
    """Gumbel-softmax at the annealed temperature (``noise`` is the
    uniform draw u); the top-k slots weighed by the unrenormalised
    probabilities."""
    T = torch.full((), cfg.gumbel_temperature, dtype=logits.dtype,
                   device=logits.device)
    if noise is not None:
        g = -torch.log(-torch.log(noise))
        noisy = (logits + g) / T
    else:
        noisy = logits / T
    y = torch.softmax(noisy, dim=-1)
    val, idx = _topk(y, cfg.top_k)
    return GateOutput(idx, val, y, logits)


_PLAIN_GATES = {
    "gshard": _gate_gshard,
    "ktop1": _gate_ktop1,
    "sam": _gate_sam,
    "base": _gate_base,
    "hash": _gate_hash,
    "dense_to_sparse": _gate_dense_to_sparse,
}


def _route_kernel(cfg: MoEConfig, logits: torch.Tensor) -> GateOutput:
    """``topk`` and ``switch``: the fused top-k gate kernel selects
    (lowest-index ties); probabilities and weights come from its
    single-pass statistics (``ops.topk_softmax_weights``): ``switch``
    weighs by the chosen expert's probability, ``topk`` by the softmax
    over the K selected logits (paper Eq. 1)."""
    idx, sel_probs, probs = ops.topk_softmax_weights(logits, gate_k(cfg))
    if cfg.gate == "topk":
        weights = torch.softmax(logits.gather(-1, idx.long()), dim=-1)
    else:
        weights = sel_probs
    return GateOutput(idx, weights, probs, logits)


def route(cfg: MoEConfig, logits: torch.Tensor, *,
          noise: Optional[torch.Tensor] = None,
          token_ids: Optional[torch.Tensor] = None) -> GateOutput:
    """Route (S, E) logits through the configured strategy.  ``noise``
    (S, E) is the draw of a noisy gate (:func:`draw_noise`, or JAX's);
    ``token_ids`` (S,) feed ``hash``."""
    logits = logits.float()
    if cfg.gate in ("topk", "switch"):
        return _route_kernel(cfg, logits)
    out = _PLAIN_GATES[cfg.gate](cfg, logits, noise, token_ids)
    assert out.expert_index.shape[-1] == gate_k(cfg), (
        cfg.gate, out.expert_index.shape, gate_k(cfg))
    return out


def router_logits(cfg: MoEConfig, x: torch.Tensor,
                  gate_w: torch.Tensor) -> torch.Tensor:
    """x·W in router_dtype (the paper computes the gate in f32)."""
    dt = getattr(torch, cfg.router_dtype)
    return x.to(dt) @ gate_w.to(dt)
