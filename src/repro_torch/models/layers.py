"""Shared building blocks: norms, MLPs, embeddings, softcaps — the port of
``repro/models/layers.py``.  Functions over plain tensors; the reference
casts f32 weights to the compute dtype at every use, the port's
``Transformer`` keeps one compute-dtype copy instead (same values)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import draw


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the stored ``scale - 1`` (the ``1 + scale`` form)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap·tanh(x/cap)."""
    return cap * torch.tanh(x / cap)


def init_mlp(generator: torch.Generator, d: int, f: int, act: str, *,
             device=None, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    cols = 2 * f if act in ("swiglu", "geglu") else f
    return {
        "w_in": draw(generator, (d, cols), d ** -0.5, device=device,
                     dtype=dtype),
        "w_out": draw(generator, (f, d), f ** -0.5, device=device,
                      dtype=dtype),
    }


def apply_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor,
              act: str) -> torch.Tensor:
    dt = x.dtype
    h = x @ params["w_in"].to(dt)
    if act in ("swiglu", "geglu"):
        u, g = h.chunk(2, dim=-1)
        h = u * (torch.nn.functional.silu(g) if act == "swiglu"
                 else torch.nn.functional.gelu(g, approximate="tanh"))
    elif act == "gelu":
        h = torch.nn.functional.gelu(h, approximate="tanh")
    else:
        h = torch.relu(h)
    return h @ params["w_out"].to(dt)


def embed(table: torch.Tensor, ids: torch.Tensor, dtype,
          scale: bool) -> torch.Tensor:
    x = torch.nn.functional.embedding(ids.long(), table.to(dtype))
    if scale:
        x = x * torch.tensor(table.shape[-1] ** 0.5, dtype=dtype)
    return x
