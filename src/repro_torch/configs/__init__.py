"""Architecture registry: ``--arch <id>`` → ModelConfig.

All eleven of the reference's presets; asking for another raises
``KeyError`` naming them.  ``ASSIGNED`` lists the ten the dry run counts
(``launch/dryrun.py``), in the reference's order.  ``smoke_config``
applies the reference's reductions (``repro/configs/__init__.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs.gemma2_9b import CONFIG as _gemma2
from repro_torch.configs.h2o_danube_3_4b import CONFIG as _danube
from repro_torch.configs.hetumoe_paper_16e import CONFIG as _paper
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert
from repro_torch.configs.internvl2_2b import CONFIG as _internvl
from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG as _llama4
from repro_torch.configs.rwkv6_1_6b import CONFIG as _rwkv6
from repro_torch.configs.starcoder2_3b import CONFIG as _starcoder
from repro_torch.configs.yi_6b import CONFIG as _yi
from repro_torch.configs.zamba2_7b import CONFIG as _zamba
from repro_torch.core.config import ModelConfig

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in (
    _rwkv6, _danube, _yi, _llama4, _dbrx, _internvl, _zamba, _gemma2,
    _hubert, _starcoder, _paper)}

# the ten presets the dry run covers, in the reference's order (the paper
# model is the repo's own)
ASSIGNED = [c.name for c in (_rwkv6, _danube, _yi, _llama4, _dbrx,
                             _internvl, _zamba, _gemma2, _hubert, _starcoder)]


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests."""
    cfg = get_config(arch)
    period = len(cfg.block_pattern)
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=period if period > 1 else 2,
        d_model=128,
        d_ff=256,
        vocab_size=512,
        local_window=32,
    )
    if cfg.attention is not None:
        kw["attention"] = dataclasses.replace(
            cfg.attention, num_heads=4,
            num_kv_heads=max(1, min(cfg.attention.num_kv_heads, 2)),
            head_dim=32, window=32 if cfg.attention.window else None)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, d_ff_expert=256,
            num_prototypes=min(cfg.moe.num_prototypes, 2),
            num_groups=min(cfg.moe.num_groups, 2))
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16,
                                        chunk_size=8)
    if cfg.rwkv is not None:
        kw["rwkv"] = dataclasses.replace(cfg.rwkv, head_dim=16, chunk_size=8,
                                         decay_lora=8, mix_lora=4)
    return cfg.replace(**kw)
