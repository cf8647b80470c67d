"""Serving: prefill + batched single-token decode steps — the port of
``repro/serving/engine.py`` (``serve_config``, ``validate_dispatch``,
``validate_decode_config``, ``resolve_decode_config``, ``generate``).

PyTorch runs eagerly, so there is no step-builder cache or retrace probe
here (a CUDA-graph step cache comes in a later slice, with ``SlotServer``
and the fault seam).  ``generate`` runs under ``torch.inference_mode()``.
It takes token prompts: a frontend preset is served through the API
(:func:`refuse_frontend`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.core import moe as moe_lib
from repro_torch.core import tuning
from repro_torch.core.config import DISPATCH_MODES, ModelConfig


def validate_dispatch(dispatch: str) -> str:
    """Validate a serving dispatch-mode name against ``DISPATCH_MODES``."""
    if dispatch not in DISPATCH_MODES:
        raise ValueError(
            f"serving dispatch={dispatch!r} is not a known dispatch "
            f"mode; valid options: {DISPATCH_MODES}")
    return dispatch


def serve_config(cfg: ModelConfig, *,
                 dispatch: Optional[str] = None) -> ModelConfig:
    """The config actually served: ``dispatch`` (when given) overrides the
    MoE dispatch mode — validated, never silently dropped."""
    if dispatch is None:
        return cfg
    validate_dispatch(dispatch)
    if cfg.moe is None:
        raise ValueError(
            f"dispatch={dispatch!r} requested but {cfg.name} has no MoE "
            f"layer (cfg.moe is None) — MoE serving overrides only apply "
            f"to MoE architectures")
    if cfg.moe.dispatch == dispatch:
        return cfg
    return cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=dispatch))


def validate_decode_config(cfg: ModelConfig, batch: int, *,
                           cache_len: Optional[int] = None) -> None:
    """Raise ``ValueError`` for a decode configuration that cannot run,
    before any step does."""
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name} is encoder-only — no decode step")
    if batch < 1:
        raise ValueError(f"decode batch must be >= 1, got {batch}")
    if cache_len is not None and cache_len < 2:
        raise ValueError(
            f"cache_len must be >= 2 (one prompt token + one generated), "
            f"got {cache_len}")
    if cfg.moe is not None:
        moe_lib.validate_dispatch_config(cfg.moe, tokens_per_shard=batch)


def refuse_frontend(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a frontend config (audio, vision), which
    takes embeddings, not the token prompts ``generate`` samples from;
    the reference's serving entry point refuses it the same way."""
    if cfg.frontend is not None:
        raise ValueError(
            f"{cfg.name}: a {cfg.frontend} frontend takes (B, S, d) "
            f"embeddings, not token prompts; serve it through the API: "
            f"Transformer.forward(embeddings, caches=model.init_caches(B, "
            f"L)), then Transformer.decode_step fed (B, 1, d) embeddings "
            f"(models/frontend.synthetic_embeddings)")


def resolve_decode_config(cfg: ModelConfig, batch: int) -> ModelConfig:
    """The decode-step config: ``"auto"`` MoE knobs resolved at the decode
    batch's token count (one token per row)."""
    if cfg.moe is None or not tuning.has_auto_knobs(cfg.moe):
        return cfg
    return cfg.replace(moe=tuning.resolve_moe_config(
        cfg.moe, model_size=1, tokens_per_shard=batch))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(model, prompt: torch.Tensor, *, steps: int,
             cache_len: Optional[int] = None, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             dispatch: Optional[str] = None, long_context: bool = False,
             stats: Optional[dict] = None) -> torch.Tensor:
    """Greedy/temperature generation.  prompt (B, S) → (B, S+steps).

    ``model`` is a ``models.transformer.Transformer``; ``dispatch``
    overrides the MoE dispatch mode; ``long_context`` serves the
    long-context variant (``global`` layers capped to ``local_window``).  As in the reference, the last token
    is sampled without a further decode step (1 prefill + steps-1 decode
    steps).  With ``stats`` given, the device is synchronised after the
    prefill and at the end, and ``prefill_s``, ``decode_s`` and
    ``decode_steps`` are written into it, with ``logits_finite``: whether
    every logits row sampled from was finite.
    """
    cfg = serve_config(model.cfg, dispatch=dispatch)
    B, S = prompt.shape[:2]
    cache_len = cache_len or (S + steps)
    validate_decode_config(cfg, B, cache_len=cache_len)
    refuse_frontend(cfg)
    step_cfg = resolve_decode_config(cfg, B)
    prompt = prompt.to(model.device)
    t0 = time.perf_counter()
    caches = model.init_caches(B, cache_len, long_context=long_context)
    h, _, caches = model.forward(prompt, caches=caches, cfg=cfg,
                                 long_context=long_context)
    logits = model.logits_from_hidden(h[:, -1:])
    if stats is not None:
        _sync(model.device)
        t1 = time.perf_counter()
    out = [prompt]
    finite = torch.ones((), dtype=torch.bool, device=model.device)
    for i in range(steps):
        last = logits[:, -1].float()
        if stats is not None:
            finite &= torch.isfinite(last).all()
        if temperature > 0:
            probs = torch.softmax(last / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok = last.argmax(dim=-1, keepdim=True)
        out.append(tok.to(prompt.dtype))
        if i + 1 < steps:
            logits, caches = model.decode_step(tok, caches, cfg=step_cfg,
                                               long_context=long_context)
    result = torch.cat(out, dim=1)
    if stats is not None:
        _sync(model.device)
        stats.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1,
                     decode_steps=max(steps - 1, 0),
                     logits_finite=bool(finite))
    return result
