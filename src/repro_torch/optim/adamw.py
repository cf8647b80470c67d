"""AdamW + LR schedules + global-norm clipping — the port of
``repro/optim/adamw.py`` over the port's parameter trees (``tree.py``).

Every value stays on the parameters' device: the step count, the learning
rate and the clipping scale are 0-d tensors, so an update never makes the
host wait for the device.  Moments can be stored bf16
(``TrainConfig.optimizer_state_dtype``), as in the reference.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.core.config import TrainConfig


def init_opt_state(params, cfg: TrainConfig) -> Dict:
    dt = getattr(torch, cfg.optimizer_state_dtype)
    dev = tree.leaves(params)[0].device

    def zeros(p):
        return torch.zeros_like(p, dtype=dt, requires_grad=False)
    return {"m": tree.map_(zeros, params), "v": tree.map_(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def clip_by_global_norm(grads, max_norm: float, *, norm_axes=None,
                        group=None):
    """(grads scaled so their global L2 norm is at most ``max_norm``, the
    norm before scaling).  Across ranks ``norm_axes`` (in the order of
    ``tree.leaves(grads)``) names for each leaf the mesh axes whose ranks
    hold disjoint blocks of it (``launch/shard.Layout.norm_axes``): its
    squares are summed with the other leaves of those axes and the sum
    all-reduced over ``group(axes)``, while a leaf on no axis (the same
    on every rank) counts once."""
    sq = [torch.sum(torch.square(g.float())) for g in tree.leaves(grads)]
    if norm_axes is None:
        gn = torch.sqrt(sum(sq))
    else:
        sums: Dict = {}
        for s, axes in zip(sq, norm_axes, strict=True):
            sums[axes] = sums[axes] + s if axes in sums else s
        total = torch.zeros((), device=sq[0].device)
        for axes in sorted(sums):          # the same order on every rank
            if axes:
                dist.all_reduce(sums[axes], group=group(axes))
            total = total + sums[axes]
        gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree.map_(lambda g: (g * scale).to(g.dtype), grads), gn


def adamw_update(grads, state: Dict, params, cfg: TrainConfig,
                 lr: torch.Tensor) -> Tuple[Dict, Dict]:
    """Returns (new_params, new_state).  Decoupled weight decay."""
    c = state["count"] + 1
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** c.float()
    bc2 = 1.0 - b2 ** c.float()

    def upd(p, g, m, v):
        g32 = g.float()
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32 * g32
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        p32 = p.detach().float()
        p32 = p32 - lr * (step + cfg.weight_decay * p32)
        return p32.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    out = [upd(*leaf) for leaf in zip(
        tree.leaves(params), tree.leaves(grads), tree.leaves(state["m"]),
        tree.leaves(state["v"]), strict=True)]
    unf = lambda i: tree.unflatten(params, [o[i] for o in out])  # noqa: E731
    return unf(0), {"m": unf(1), "v": unf(2), "count": c}


def make_schedule(cfg: TrainConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (0-d int tensor) → learning rate (0-d f32 tensor): linear
    warm-up, then cosine or linear decay to 0 at ``total_steps``."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = cfg.learning_rate * s / max(cfg.warmup_steps, 1)
        t = torch.clamp((s - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
        if cfg.schedule == "cosine":
            rest = cfg.learning_rate * 0.5 * (1 + torch.cos(math.pi * t))
        else:
            rest = cfg.learning_rate * (1 - t)
        return torch.where(s < cfg.warmup_steps, warm, rest)
    return sched
