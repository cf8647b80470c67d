"""Expert-capacity computation (GShard/Switch semantics) — the port of the
single-device part of ``repro/core/capacity.py``."""
from __future__ import annotations

import math

from repro_torch.core import gating
from repro_torch.core.config import MoEConfig


def _round_up(n: int, align: int) -> int:
    return math.ceil(n / align) * align


def expert_capacity(cfg: MoEConfig, num_tokens: int, num_experts: int,
                    *, align: int = 8) -> int:
    """capacity = ceil(k · S / E · capacity_factor) rounded up to
    ``align``; the total-assignment clamp (no expert sees more than S·k
    tokens) is itself rounded up to ``align``, so the result always honors
    the alignment."""
    k = gating.gate_k(cfg)
    cap = math.ceil(num_tokens * k / num_experts * cfg.capacity_factor)
    cap = max(align, _round_up(cap, align))
    return min(cap, _round_up(num_tokens * k, align))


def grouped_tp_gather_bound(cfg: MoEConfig, num_tokens: int) -> int:
    """Rows of the single-rank expert-sorted buffer: B = T·K."""
    return num_tokens * gating.gate_k(cfg)
