"""Synthetic deterministic data pipeline — the port of
``repro/data/pipeline.py``.

Token streams are generated with numpy from ``(seed, step)`` exactly as
the reference generates them (the same draws in the same order, so the
batches are bitwise equal): a Zipf mixture with an injected copied span
so that the LM loss is learnable.  A frontend config (audio, vision)
gets the stubbed frontend's embeddings instead: each input token's row
of a fixed random (V, d) projection, as in the reference, so that the
inputs stay correlated with the targets.  ``next_batch`` hands the
batches over as torch tensors on the requested device.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.config import ModelConfig
from repro_torch.launch.mesh import TokenBlock


class SyntheticLM:
    """Deterministic synthetic LM batches.

    next_batch(step) → {"inputs": (B, S) int32 | (B, S, d) float32 for a
    frontend config, "targets": (B, S) int32, "loss_mask": (B, S)
    float32}, on ``device`` (``cuda`` unless given).  A frontend's
    projection is drawn once, here, from ``default_rng(seed)`` (the
    reference redraws the same table at every batch: at internvl2-2b's
    vocabulary it is 0.76 GB of f32, seconds of host time a batch).
    """

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0, *, device=None):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.device = resolve_device(device)
        v = cfg.vocab_size
        # fixed zipf distribution over the vocabulary
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._p = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._proj = None
        if cfg.frontend is not None:
            self._proj = np.random.default_rng(seed).standard_normal(
                (v, cfg.d_model)).astype(np.float32) * 0.02

    def _tokens(self, rng: np.random.Generator, n: int) -> np.ndarray:
        toks = rng.choice(self.cfg.vocab_size, size=n, p=self._p)
        # inject copy structure: repeat a random span (learnable signal)
        if n >= 32:
            L = n // 4
            src = rng.integers(0, n - 2 * L)
            dst = src + L + rng.integers(0, max(n - src - 2 * L, 1))
            toks[dst:dst + L] = toks[src:src + L]
        return toks.astype(np.int32)

    def next_batch(self, step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng((self.seed, step))
        B, S = self.batch, self.seq
        tok = np.stack([self._tokens(rng, S + 1) for _ in range(B)])
        inputs = (tok[:, :-1] if self._proj is None
                  else self._proj[tok[:, :-1]])
        host = {"inputs": torch.from_numpy(np.ascontiguousarray(inputs)),
                "targets": torch.from_numpy(np.ascontiguousarray(tok[:, 1:])),
                "loss_mask": torch.ones((B, S), dtype=torch.float32)}
        return {k: v.to(self.device) for k, v in host.items()}


def cut_batch(batch: Dict[str, torch.Tensor],
              block: Optional[TokenBlock]) -> Dict[str, torch.Tensor]:
    """This rank's block of every (B, S) or (B, S, d) leaf of a global
    batch (``launch/mesh.token_block``: whole rows, or the rank's chunk of
    one row's positions), as the reference shards the flattened tokens
    over ``("data", "model")``; None ``block`` returns ``batch``."""
    if block is None:
        return batch
    return {k: v[block.rows, block.seq] for k, v in batch.items()}
