"""Router auxiliary losses + load metrics (Switch/GShard style) — the port
of ``repro/core/balance.py``.

Every serving step computes them, so nothing here waits on the device:
expert counts are ``index_add_`` into a fixed-size vector (``one_hot``
checks its input's range on the host).  ``group`` (a process group, the
reference's mesh ``axes``; None for one device, ``dist.group.WORLD`` for
every rank) makes the means global over its ranks: each
(sum, count) pair is all-reduced BEFORE the divide, so every valid token
weighs the same wherever it lives (``core/alltoall.all_reduce_sum``, whose
backward leaves each rank its own contribution)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.alltoall import all_reduce_sum
from repro_torch.core.config import MoEConfig
from repro_torch.core.gating import GateOutput

# The canonical router-metric key list: aux_losses returns exactly these.
METRIC_KEYS = ("load_balance_loss", "router_z_loss",
               "expert_load_max", "expert_load_min")


def _masked_mean(x: torch.Tensor, valid: Optional[torch.Tensor],
                 group=None) -> torch.Tensor:
    """Mean over the leading (token) axis, restricted to ``valid`` rows
    (padded tokens must not bias the router statistics); over the ranks of
    ``group`` too when one is given."""
    if valid is None:
        s = x.sum(dim=0)
        n = torch.full((), float(x.shape[0]), dtype=s.dtype,
                       device=s.device)
    else:
        w = valid.to(x.dtype)
        s = (x * (w[:, None] if x.dim() > 1 else w)).sum(dim=0)
        n = w.sum()
    if group is not None:
        s, n = all_reduce_sum(s, group), all_reduce_sum(n, group)
    return s / n.clamp(min=1.0)


def _expert_counts(expert_index: torch.Tensor, num_experts: int,
                   weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(E,) f32: assignments per expert (each weighted by ``weight``);
    the virtual expert E (padded rows) is counted apart and cut off."""
    idx = expert_index.reshape(-1).long().clamp(max=num_experts)
    w = (torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
         if weight is None else weight.reshape(-1).to(torch.float32))
    return torch.zeros((num_experts + 1,), dtype=torch.float32,
                       device=idx.device).index_add_(0, idx, w)[:num_experts]


def load_balance_loss(gate: GateOutput,
                      valid: Optional[torch.Tensor] = None,
                      group=None) -> torch.Tensor:
    """E · Σ_e f_e · P_e (f_e: share of first choices, P_e: mean prob)."""
    E = gate.router_probs.shape[-1]
    first = gate.expert_index[:, 0]
    w = (torch.ones(first.shape, dtype=torch.float32, device=first.device)
         if valid is None else valid.to(torch.float32))
    s, n = _expert_counts(first, E, w), w.sum()
    if group is not None:
        s, n = all_reduce_sum(s, group), all_reduce_sum(n, group)
    f = s / n.clamp(min=1.0)
    p = _masked_mean(gate.router_probs, valid, group)
    return E * (f * p).sum()


def router_z_loss(gate: GateOutput,
                  valid: Optional[torch.Tensor] = None,
                  group=None) -> torch.Tensor:
    """ST-MoE z-loss: mean (logsumexp logits)²."""
    return _masked_mean(torch.logsumexp(gate.logits, dim=-1) ** 2, valid,
                        group)


def aux_losses(cfg: MoEConfig, gate: GateOutput,
               expert_counts: Optional[torch.Tensor] = None,
               valid: Optional[torch.Tensor] = None, group=None,
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted aux-loss scalar + the router metrics of ``METRIC_KEYS``.
    ``expert_counts`` (E,) come from the dispatch plan's single sort;
    with ``group`` the two losses are global masked means over its ranks
    (the load metrics stay this rank's: the layer averages them)."""
    E = gate.router_probs.shape[-1]
    lb = load_balance_loss(gate, valid, group)
    zl = router_z_loss(gate, valid, group)
    loss = cfg.aux_loss_weight * lb + cfg.router_z_loss_weight * zl
    counts = (expert_counts.float() if expert_counts is not None
              else _expert_counts(gate.expert_index, E))
    total = counts.sum().clamp(min=1.0)
    metrics = dict(zip(METRIC_KEYS,
                       (lb, zl, counts.max() / total, counts.min() / total),
                       strict=True))
    return loss, metrics
