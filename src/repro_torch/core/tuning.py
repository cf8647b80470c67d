"""Resolution of the ``"auto"`` MoE knobs — the single-device part of
``repro/core/tuning.py``.

On one device there is no exchange to tune, so the α–β cost model is not
consulted (it comes with the expert-parallel slice): ``a2a`` becomes flat
with ``a2a_inner`` 1, ``overlap_chunks`` 1, ``grouped_ep_bound_factor``
None (never lossy), ``payload_dtype`` None, and the grouped
``grouped_block_m`` is ``max(8, min(128, round_up(T·K / P, 8)))``.
Explicit values are honored verbatim; a config with no ``"auto"`` comes
back as the same object.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import capacity
from repro_torch.core.config import AUTO, MoEConfig

TUNED_KNOBS = ("a2a", "overlap_chunks", "grouped_block_m",
               "grouped_ep_bound_factor", "payload_dtype")

# the reference kernel's default row block (repro/kernels/grouped_ffn.py)
DEFAULT_BLOCK_M = 128


def has_auto_knobs(cfg: MoEConfig) -> bool:
    """True iff any tuner-owned knob carries the ``"auto"`` sentinel."""
    return any(getattr(cfg, k) == AUTO for k in TUNED_KNOBS)


def _round_up(n: int, align: int = 8) -> int:
    return -(-n // align) * align


def resolve_moe_config(cfg: MoEConfig, *, model_size: int,
                       tokens_per_shard: int) -> MoEConfig:
    """``cfg`` with every ``"auto"`` knob resolved for one device."""
    if model_size != 1:
        raise NotImplementedError(
            f"model_size={model_size}: expert parallelism and its α–β "
            f"tuning come with the EP slice (ROADMAP.md)")
    if not has_auto_knobs(cfg):
        return cfg
    kw = {}
    if cfg.a2a == AUTO:
        kw.update(a2a="flat", a2a_inner=1)
    if cfg.overlap_chunks == AUTO:
        kw["overlap_chunks"] = 1
    if cfg.grouped_ep_bound_factor == AUTO:
        kw["grouped_ep_bound_factor"] = None
    if cfg.payload_dtype == AUTO:
        kw["payload_dtype"] = None
    if cfg.grouped_block_m == AUTO:
        block_m = None
        if cfg.dispatch == "grouped":
            rows = capacity.grouped_tp_gather_bound(cfg, tokens_per_shard)
            overlap = kw.get("overlap_chunks", cfg.overlap_chunks)
            block_m = max(8, min(DEFAULT_BLOCK_M,
                                 _round_up(rows // max(overlap, 1))))
        kw["grouped_block_m"] = block_m
    return dataclasses.replace(cfg, **kw)
