"""PyTorch + CUDA port of the HetuMoE repro (``src/repro`` is the JAX
reference).

The layout mirrors ``repro``: ``core/`` (config, gating, layout, the MoE
layer), ``kernels/`` (hand-written Hopper kernels under ``csrc/`` with a
plain PyTorch version beside each), ``models/``, ``serving/`` and
``launch/``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU and without that request they raise
(:func:`resolve_device`).
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda``.  Never falls back to the CPU on its own: with no GPU and no
    explicit ``device="cpu"`` it raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch entry points run on CUDA by default and no "
                "CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but CUDA is not "
                           f"available")
    return dev


def draw(generator: torch.Generator, shape, scale: float, *, device=None,
         dtype=torch.float32) -> torch.Tensor:
    """An f32 normal draw of ``shape`` times ``scale`` (in place), cast to
    ``dtype`` right away: a compute-dtype model never holds more than one
    f32 leaf."""
    return torch.randn(shape, generator=generator, device=device).mul_(
        scale).to(dtype)
