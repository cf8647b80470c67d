"""Model assembly for the ``moe`` block kind — the port of
``repro/models/transformer.py`` (init, ``forward``, ``init_caches``,
``decode_step``, ``logits_from_hidden``).

Parameters are a tree of f32 tensors in the reference's layout, with the
``(nsb, ...)`` stacked block leaves split per layer
(:func:`init_params`, or ``convert.params_from_numpy`` from the JAX
package's tree).  :func:`forward` and :func:`logits_from_hidden` run over
that tree as the reference's do: each weight is cast to ``cfg.dtype`` at
its use, so a trainer's gradients land in f32 on the masters.  For
serving, :class:`Transformer` keeps one copy in the compute dtype instead,
made when the weights are loaded — the same values, without re-reading
2 GB of f32 weights at every decode step.  The router and the norm scales
stay f32, as they are used.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.core import moe as moe_lib
from repro_torch.core.config import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers

# leaves used in f32 whatever the compute dtype
_F32_LEAVES = ("ln1", "ln2", "final_norm", "gate_w")


def _check_supported(cfg: ModelConfig) -> None:
    if set(cfg.block_pattern) != {"moe"}:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {cfg.block_pattern} — only 'moe' "
            f"blocks are ported to repro_torch (ROADMAP.md)")
    if cfg.frontend is not None or cfg.moe.num_shared_experts:
        raise NotImplementedError(
            f"{cfg.name}: frontends and shared experts are not ported yet "
            f"(ROADMAP.md)")


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device=None) -> Dict[str, Any]:
    """Random f32 parameters in the port's tree layout, drawn in a fixed
    order from ``generator``."""
    _check_supported(cfg)
    d = cfg.d_model

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device)

    blocks = []
    for _ in range(cfg.num_layers):
        blocks.append({
            "ln1": torch.zeros((d,), device=device),
            "attn": attn_lib.init_attention(generator, cfg.attention, d,
                                            device=device),
            "ln2": torch.zeros((d,), device=device),
            "moe": moe_lib.init_moe_params(
                generator, cfg.moe, d, cfg.moe.d_ff_expert or cfg.d_ff,
                cfg.moe.num_experts, act=cfg.act, device=device)})
    params = {"blocks": blocks,
              "final_norm": torch.zeros((d,), device=device),
              "embed": randn(cfg.vocab_size, d) * d ** -0.5}
    if not cfg.tie_embeddings:
        params["lm_head"] = randn(d, cfg.vocab_size) * d ** -0.5
    return params


def _leaf(name: str, t: torch.Tensor, dtype, device) -> nn.Parameter:
    dt = torch.float32 if name in _F32_LEAVES else dtype
    return nn.Parameter(t.to(device=device, dtype=dt), requires_grad=False)


def block_forward(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, *,
                  positions=None, cache=None, decode: bool = False):
    """One ``moe`` block over its parameter dict ``p``: attention + the
    MoE FFN, pre-norm residuals.  Returns (x, cache, aux)."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if decode:
        a, cache = attn_lib.decode_attention(p["attn"], h, cache,
                                             cfg.attention)
    else:
        a, kv = attn_lib.full_attention(p["attn"], h, cfg.attention,
                                        positions=positions,
                                        causal=not cfg.encoder_only)
        if cache is not None:
            cache = attn_lib.fill_cache(cache, kv)
    x = x + a
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    y, aux, _ = moe_lib.moe_apply(cfg.moe, p["moe"], h,
                                  num_experts=cfg.moe.num_experts,
                                  act=cfg.act)
    return x + y, cache, aux


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig,
            *, caches=None) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """Full-sequence pass (training, prefill) over a parameter tree — the
    f32 masters, or a :class:`Transformer`'s compute-dtype copy — with
    every weight cast to ``cfg.dtype`` at its use, as the reference's
    ``forward``.  tokens (B, S) → (hidden (B, S, d), aux, caches);
    ``caches`` (one per layer) are filled in place."""
    _check_supported(cfg)
    dtype = getattr(torch, cfg.dtype)
    x = layers.embed(params["embed"], tokens, dtype, cfg.scale_embeddings)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(params["blocks"]):
        x, _, a = block_forward(p, x, cfg, positions=positions,
                                cache=None if caches is None else caches[i])
        aux = aux + a
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux, caches


def logits_from_hidden(params: Dict[str, Any], cfg: ModelConfig,
                       h: torch.Tensor) -> torch.Tensor:
    """The unembedding in ``h``'s dtype (the head cast at its use)."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = h @ w.to(h.dtype)
    if cfg.final_softcap:
        logits = layers.softcap(logits.float(), cfg.final_softcap)
    return logits


class Block(nn.Module):
    """One ``moe`` block's serving weights (run by :func:`block_forward`)."""

    def __init__(self, p: Dict[str, Any], dtype, device):
        super().__init__()
        self.ln1 = _leaf("ln1", p["ln1"], dtype, device)
        self.ln2 = _leaf("ln2", p["ln2"], dtype, device)
        self.attn = nn.ParameterDict(
            {k: _leaf(k, v, dtype, device) for k, v in p["attn"].items()})
        self.moe = nn.ParameterDict(
            {k: _leaf(k, v, dtype, device) for k, v in p["moe"].items()})

    def tree(self) -> Dict[str, Any]:
        return {"ln1": self.ln1, "ln2": self.ln2, "attn": dict(self.attn),
                "moe": dict(self.moe)}


class Transformer(nn.Module):
    """The MoE transformer on one device, for inference.

    ``Transformer(cfg)`` runs on ``cuda`` (raising without a GPU) unless
    ``device="cpu"`` is passed.  ``params`` is an f32 tree from
    :func:`init_params` or ``convert.params_from_numpy``; without it the
    weights are drawn from a ``torch.Generator`` seeded with ``seed`` on the
    target device.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0,
                 params: Optional[Dict[str, Any]] = None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen, device=self.device)
        self.blocks = nn.ModuleList(
            Block(p, self.dtype, self.device) for p in params["blocks"])
        self.final_norm = _leaf("final_norm", params["final_norm"],
                                self.dtype, self.device)
        self.embed = _leaf("embed", params["embed"], self.dtype, self.device)
        self.lm_head = (None if cfg.tie_embeddings else
                        _leaf("lm_head", params["lm_head"], self.dtype,
                              self.device))

    def init_caches(self, batch: int, cache_len: int) -> List[Dict[str, Any]]:
        return [attn_lib.init_cache(self.cfg.attention, batch, cache_len,
                                    self.cfg.d_model, self.dtype, self.device)
                for _ in self.blocks]

    def forward(self, tokens: torch.Tensor, *, caches=None,
                cfg: Optional[ModelConfig] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        """Full-sequence pass (prefill).  tokens (B, S) → (hidden (B,S,d),
        aux_loss, caches); ``caches`` from :meth:`init_caches` are filled in
        place.  ``cfg`` overrides the served config (e.g. its dispatch)."""
        tree = {"blocks": [blk.tree() for blk in self.blocks],
                "final_norm": self.final_norm, "embed": self.embed}
        return forward(tree, tokens, cfg or self.cfg, caches=caches)

    def logits_from_hidden(self, h: torch.Tensor) -> torch.Tensor:
        return logits_from_hidden({"embed": self.embed,
                                   "lm_head": self.lm_head}, self.cfg, h)

    def decode_step(self, token: torch.Tensor, caches,
                    cfg: Optional[ModelConfig] = None):
        """One-token serve step: token (B, 1) → (logits (B, 1, V), caches),
        the caches updated in place."""
        cfg = cfg or self.cfg
        x = layers.embed(self.embed, token, self.dtype, cfg.scale_embeddings)
        for blk, cache in zip(self.blocks, caches, strict=True):
            x, _, _ = block_forward(blk.tree(), x, cfg, cache=cache,
                                    decode=True)
        x = layers.rms_norm(x, self.final_norm, cfg.norm_eps)
        return self.logits_from_hidden(x), caches
