"""Synthetic deterministic data pipeline — the port of
``repro/data/pipeline.py`` for token inputs.

Token streams are generated with numpy from ``(seed, step)`` exactly as
the reference generates them (the same draws in the same order, so the
batches are bitwise equal): a Zipf mixture with an injected copied span
so that the LM loss is learnable.  ``next_batch`` hands them over as
torch tensors on the requested device.  Frontend (embedding-input)
architectures are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.config import ModelConfig


class SyntheticLM:
    """Deterministic synthetic LM batches.

    next_batch(step) → {"inputs": (B, S) int32, "targets": (B, S) int32,
    "loss_mask": (B, S) float32}, on ``device`` (``cuda`` unless given).
    """

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0, *, device=None):
        if cfg.frontend is not None:
            raise NotImplementedError(
                f"{cfg.name}: frontend (embedding-input) batches are not "
                f"ported to repro_torch yet (ROADMAP.md)")
        self.cfg = cfg
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.device = resolve_device(device)
        v = cfg.vocab_size
        # fixed zipf distribution over the vocabulary
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._p = (1.0 / ranks) / np.sum(1.0 / ranks)

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
        host = {"inputs": torch.from_numpy(np.ascontiguousarray(tok[:, :-1])),
                "targets": torch.from_numpy(np.ascontiguousarray(tok[:, 1:])),
                "loss_mask": torch.ones((B, S), dtype=torch.float32)}
        return {k: v.to(self.device) for k, v in host.items()}
