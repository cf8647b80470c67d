"""Dense-to-Sparse gate annealing (paper §3.1, Nie et al. 2021) — the
port of ``repro/training/anneal.py`` (the same pure-Python schedule).

The dense_to_sparse gate routes via Gumbel-softmax at temperature T;
training starts dense (high T — every slot weighted nearly equally,
approximating routing to all experts) and anneals toward sparse
(T → T_min — mass collapses onto the top-1 slot).  The schedule is a
host-side exponential decay applied by swapping the (frozen-dataclass)
MoEConfig per step, quantized to ``levels`` buckets as in the reference
(there each distinct temperature costs a retrace; the port has none, and
keeps the buckets so both packages anneal through the same values).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.config import ModelConfig


def d2s_temperature(step: int, *, t_start: float = 2.0, t_min: float = 0.05,
                    decay_steps: int = 1000, levels: int = 8) -> float:
    """Exponentially annealed, quantized to ``levels`` buckets."""
    frac = min(step / max(decay_steps, 1), 1.0)
    t = t_start * (t_min / t_start) ** frac
    # quantize in log space to bound retraces
    lo, hi = math.log(t_min), math.log(t_start)
    q = round((math.log(t) - lo) / (hi - lo) * (levels - 1)) / (levels - 1)
    return float(math.exp(lo + q * (hi - lo)))


def with_temperature(cfg: ModelConfig, t: float) -> ModelConfig:
    assert cfg.moe is not None and cfg.moe.gate == "dense_to_sparse", cfg.name
    return cfg.replace(moe=dataclasses.replace(cfg.moe, gumbel_temperature=t))
