"""Expert-capacity computation (GShard/Switch semantics) and the grouped
path's static row bounds — the port of ``repro/core/capacity.py``."""
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


def grouped_segment_bound(cfg: MoEConfig, num_tokens: int, model_size: int,
                          *, align: int = 8) -> int:
    """Static per-(source, destination)-rank row bound B of the grouped
    expert-parallel AllToAll: B = T·K (never drops) when
    ``grouped_ep_bound_factor`` is None, else ceil(T·K/M · f) rounded up to
    ``align`` (rows past B for one destination rank drop, sort-path
    semantics).  Every rank derives the same B from static inputs."""
    k = gating.gate_k(cfg)
    total = num_tokens * k
    dropless = _round_up(total, align)
    f = cfg.grouped_ep_bound_factor
    if isinstance(f, str):
        raise ValueError(
            f"grouped_segment_bound: grouped_ep_bound_factor={f!r} is "
            f"unresolved — resolve 'auto' knobs first "
            f"(core/tuning.resolve_moe_config)")
    if model_size <= 1 or f is None:
        return dropless
    b = max(align, _round_up(math.ceil(total / model_size * f), align))
    return min(b, dropless)


def grouped_overlap_chunk_bound(cfg: MoEConfig, bound: int) -> int:
    """Per-window row bound Bc = bound / overlap_chunks of the overlapped
    grouped pipeline; the division must be exact (every window's exchange
    needs one shape)."""
    chunks = cfg.overlap_chunks
    if isinstance(chunks, str):
        raise ValueError(
            f"grouped_overlap_chunk_bound: overlap_chunks={chunks!r} is "
            f"unresolved — resolve 'auto' knobs first "
            f"(core/tuning.resolve_moe_config)")
    if chunks <= 1:
        return bound
    if bound % chunks:
        raise ValueError(
            f"MoEConfig.overlap_chunks={chunks} does not divide the grouped "
            f"segment bound B={bound} (grouped_segment_bound / "
            f"grouped_tp_gather_bound at this shard's token count) — pick "
            f"overlap_chunks from the divisors of {bound}, or adjust "
            f"MoEConfig.grouped_ep_bound_factor so the bound is a multiple")
    return bound // chunks


def grouped_tp_gather_bound(cfg: MoEConfig, num_tokens: int) -> int:
    """Rows of the single-rank expert-sorted buffer: B = T·K."""
    return num_tokens * gating.gate_k(cfg)
