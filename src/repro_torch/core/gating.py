"""Gating — the port of ``repro/core/gating.py`` for the ``topk`` and
``switch`` strategies.

Every strategy maps router logits ``(S, E)`` to a :class:`GateOutput` with
shapes ``(S, K)``.  The gate runs in ``router_dtype`` (default f32).  The
other six strategies (gshard, ktop1, sam, base, hash, dense_to_sparse)
wait for a later slice (ROADMAP.md); routing with one raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.config import MoEConfig
from repro_torch.kernels import ops

PORTED_GATES = ("switch", "topk")


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


def route(cfg: MoEConfig, logits: torch.Tensor) -> GateOutput:
    """Route (S, E) logits through the configured strategy.  The fused
    top-k gate kernel selects (lowest-index ties); probabilities and
    weights come from its single-pass statistics
    (``ops.topk_softmax_weights``): ``switch`` weighs by the chosen
    expert's probability, ``topk`` by the softmax over the K selected
    logits (paper Eq. 1)."""
    if cfg.gate not in PORTED_GATES:
        raise NotImplementedError(
            f"gate={cfg.gate!r} is not ported to repro_torch yet (ported: "
            f"{list(PORTED_GATES)}); see ROADMAP.md")
    logits = logits.float()
    idx, sel_probs, probs = ops.topk_softmax_weights(logits, gate_k(cfg))
    if cfg.gate == "topk":
        weights = torch.softmax(logits.gather(-1, idx.long()), dim=-1)
    else:
        weights = sel_probs
    return GateOutput(idx, weights, probs, logits)


def router_logits(cfg: MoEConfig, x: torch.Tensor,
                  gate_w: torch.Tensor) -> torch.Tensor:
    """x·W in router_dtype (the paper computes the gate in f32)."""
    dt = getattr(torch, cfg.router_dtype)
    return x.to(dt) @ gate_w.to(dt)
