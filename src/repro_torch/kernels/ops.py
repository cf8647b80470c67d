"""Public wrappers around the kernels — the port of ``repro/kernels/ops.py``.

Each wrapper launches the CUDA kernel for a CUDA tensor and the kernel's
plain PyTorch version for a CPU tensor (``kernels/build.dispatch_device``).
``layout_dispatch`` and ``layout_combine`` differentiate through
``gather_rows``, whose backward is the scatter-add kernel.
:func:`launch_counts` reads every wrapper's launch counter, and
:func:`add_launch_counts` adds to them what a replayed CUDA graph
launched without calling a wrapper (``serving/engine.py``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import (flash_attention, grouped_ffn,
                                 layout_transform, topk_gate)

# (module, attribute) of every wrapper's launch counter
COUNTERS = ((topk_gate, "launches"), (layout_transform, "launches"),
            (layout_transform, "scatter_launches"),
            (layout_transform, "rowstep_launches"), (grouped_ffn, "launches"),
            (grouped_ffn, "dlhs_launches"), (grouped_ffn, "drhs_launches"),
            (flash_attention, "fwd_launches"),
            (flash_attention, "dq_launches"),
            (flash_attention, "dkv_launches"))

gather_rows = layout_transform.gather_rows


def topk_softmax_weights(logits: torch.Tensor, k: int):
    """Top-k indices + their softmax(logits) probabilities + full probs,
    all derived from the fused kernel's single pass.  The kernel sees the
    logits detached (the reference's ``stop_gradient``): its ``rowmax`` is
    a constant exp shift, softmax is shift-invariant, and Σexp is
    recomputed beside it, so the router trains through ``u/Σu`` alone."""
    logits = logits.float()
    _, idx, rowmax, _ = topk_gate.fused_topk_gate(logits.detach(), k)
    u = torch.exp(logits - rowmax)
    probs = u / u.sum(dim=-1, keepdim=True)
    weights = probs.gather(-1, idx.long())
    return idx, weights, probs


def layout_dispatch(tokens: torch.Tensor, slot: torch.Tensor,
                    num_experts: int, capacity: int,
                    inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(S, d), slot (S, K) → (E·C, d) contiguous-per-expert buffer: the
    scatter re-expressed as a row gather over ``inv (E·C,)`` (a sort plan
    carries it; otherwise it is inverted here), run in its fan-out form
    through ``slot``, the inverse of ``inv``."""
    if inv is None:
        S, K = slot.shape
        EC = num_experts * capacity
        flat = slot.reshape(-1).long()
        tok = torch.arange(S, dtype=torch.int32,
                           device=slot.device).repeat_interleave(K)
        inv = torch.full((EC + 1,), -1, dtype=torch.int32, device=slot.device)
        inv[torch.where(flat >= 0, flat, EC)] = tok
        inv = inv[:EC]
    return gather_rows(tokens, inv.contiguous(), slot.contiguous())


def layout_combine(buffer: torch.Tensor, slot: torch.Tensor,
                   weight: torch.Tensor) -> torch.Tensor:
    """Inverse transform: gather rows back per (token, k), then the
    weighted sum, rounded once to the buffer's dtype."""
    S, K = slot.shape
    rows = gather_rows(buffer, slot.reshape(-1).contiguous()).reshape(S, K, -1)
    w = (weight * (slot >= 0)).to(buffer.dtype)
    return (rows.float() * w.float()[..., None]).sum(dim=1).to(buffer.dtype)


def _key(module, attr: str) -> str:
    return f"{module.__name__.rsplit('.', 1)[1]}.{attr}"


def launch_counts() -> Dict[str, int]:
    """Every launch counter, keyed ``module.attribute``."""
    return {_key(m, a): getattr(m, a) for m, a in COUNTERS}


def add_launch_counts(rise: Dict[str, int]) -> None:
    """Add ``rise`` (keyed as :func:`launch_counts`) to the counters."""
    for m, a in COUNTERS:
        setattr(m, a, getattr(m, a) + rise.get(_key(m, a), 0))
