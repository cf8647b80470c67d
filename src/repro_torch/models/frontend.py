"""Modality frontends — stubs, as in the reference (the port of
``repro/models/frontend.py``).

The audio (``hubert-xlarge``) and vision (``internvl2-2b``) presets
specify the transformer backbone only: the conv feature extractor and the
ViT with its projector are replaced by a stream of precomputed
embeddings of the right shape, which the backbone takes in place of token
ids (``models/transformer.forward``, ``Transformer.decode_step``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.config import ModelConfig


def frontend_embedding_shape(cfg: ModelConfig, batch: int,
                             seq: int) -> Tuple[int, int, int]:
    """Shape of the embedding stream the backbone consumes.

    audio  — the conv extractor's output: one frame embedding per 20 ms,
             projected to d_model (stub: (B, S, d) directly).
    vision — the ViT's patch embeddings after the MLP projector,
             interleaved with the text tokens' embeddings (stub: the
             merged (B, S, d) stream).
    """
    assert cfg.frontend in ("audio", "vision"), cfg.frontend
    return (batch, seq, cfg.d_model)


def synthetic_embeddings(generator: torch.Generator, cfg: ModelConfig,
                         batch: int, seq: int, *, device=None,
                         dtype=torch.bfloat16) -> torch.Tensor:
    """A normal draw of :func:`frontend_embedding_shape` times 0.02 from
    ``generator`` on ``device``, in ``dtype`` (the reference's draw; its
    bits differ, as ``jax.random`` and ``torch.Generator`` do)."""
    shape = frontend_embedding_shape(cfg, batch, seq)
    return (torch.randn(shape, generator=generator, device=device,
                        dtype=dtype) * 0.02)
