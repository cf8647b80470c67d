"""Public wrappers around the kernels — the port of ``repro/kernels/ops.py``.

Each wrapper launches the CUDA kernel for a CUDA tensor and the kernel's
plain PyTorch version for a CPU tensor (``kernels/build.dispatch_device``).
``layout_dispatch`` and ``layout_combine`` differentiate through
``gather_rows``, whose backward is the scatter-add kernel.
:func:`launch_counts` reads every wrapper's launch counter, and
:func:`add_launch_counts` adds to them what a replayed CUDA graph
launched without calling a wrapper (``serving/engine.py``).

:data:`calls` logs every wrapper call on either route, kernel or plain
version, as a :class:`KernelCall` — the wrapper's name and its tensor
operands' dtypes and shapes.  It is off (None) until a caller sets it to
a list (``analysis/graph.py`` does, to record what a program ran); the
launch counters count on their own either way.  While a wrapper runs its
name is on :data:`active`, so a recorder can place the plain version's
aten ops under it.

Each wrapper names its cost with its name (``logged(name, cost=...)``,
beside the wrapper): a function of the :class:`KernelCall` that gives the
call's :class:`Cost` — its operations, the bytes it must move (each input
read once, each output written once) and the card's peak rate for its
operations, from the H100 SXM datasheet's figures below (not
measurements).  :data:`COSTS` maps each wrapper's name to it;
``launch/op_analysis.py`` sums them over a recorded run, and the bound of
a call is :attr:`Cost.bound_s`.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

# the H100 SXM datasheet's rates (dense, no sparsity; a 700 W card)
BF16_FLOPS = 989e12        # bf16 tensor-core FLOP/s
F32_FLOPS = 67e12          # f32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12           # HBM3 bytes/s


class KernelCall(NamedTuple):
    """One wrapper call: its ``name`` (``topk_gate``, ``gather_rows``,
    ``scatter_add``, ``grouped_matmul``, ``grouped_matmul_t``,
    ``grouped_drhs``, ``flash_fwd``, ``flash_dq``, ``flash_dkv``,
    ``gather_rows_rowstep``), its tensor operands' ``dtypes`` (torch
    names) and ``shapes``, in argument order, and its other arguments'
    values (``statics``: the positional ones in order, then the keyword
    ones)."""
    name: str
    dtypes: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    statics: Tuple[Any, ...] = ()


class Cost(NamedTuple):
    """One kernel call's work: ``flops`` operations (a product of two
    numbers and its add count 2), ``bytes`` moved (each input read once,
    each output written once), ``peak`` the card's rate for the
    operations' type, and whether they are products (``matmul``: the
    executed FLOPs a roofline sums, as the reference sums its dots)."""
    flops: float
    bytes: float
    peak: float
    matmul: bool = False

    @property
    def bound_s(self) -> float:
        """The least time the card could take: the larger of the bytes
        over :data:`HBM_BW` and the operations over ``peak``."""
        return max(self.bytes / HBM_BW, self.flops / self.peak)


def peak_of(dtype: str) -> float:
    """The peak rate of products in ``dtype`` (a torch name): the tensor
    cores' for bf16, FMAs' for f32 (the kernels keep f32 off TF32)."""
    return BF16_FLOPS if dtype == "bfloat16" else F32_FLOPS


def itemsize(dtype: str) -> int:
    """Bytes of one element of ``dtype`` (a torch name)."""
    return getattr(torch, dtype).itemsize


# each wrapper's cost function, by name (filled by :func:`logged`)
COSTS: Dict[str, Callable[[KernelCall], Cost]] = {}


# the kernel-call log: None (off) until a caller sets it to a list
calls: Optional[List[KernelCall]] = None
# the wrappers running now, outermost first
active: List[str] = []


def logged(name: str, cost: Callable[[KernelCall], Cost]) -> Callable:
    """Decorator of a kernel wrapper: one :class:`KernelCall` in
    :data:`calls` (when it is a list) per call, and ``name`` on
    :data:`active` while the wrapper runs; ``cost`` (the call's
    :class:`Cost`) goes into :data:`COSTS`.  Defined before the kernel
    modules are imported below, which decorate their wrappers with it."""
    COSTS[name] = cost

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if calls is not None:
                every = (*args, *kwargs.values())
                ts = [a for a in every if isinstance(a, torch.Tensor)]
                calls.append(KernelCall(
                    name, tuple(str(t.dtype).removeprefix("torch.")
                                for t in ts),
                    tuple(tuple(t.shape) for t in ts),
                    tuple(a for a in every
                          if not isinstance(a, torch.Tensor))))
            active.append(name)
            try:
                return fn(*args, **kwargs)
            finally:
                active.pop()
        return call
    return wrap


from repro_torch.kernels import (flash_attention, grouped_ffn,  # noqa: E402
                                 layout_transform, topk_gate)

# (module, attribute) of every wrapper's launch counter
COUNTERS = ((topk_gate, "launches"), (layout_transform, "launches"),
            (layout_transform, "scatter_launches"),
            (layout_transform, "rowstep_launches"), (grouped_ffn, "launches"),
            (grouped_ffn, "dlhs_launches"), (grouped_ffn, "drhs_launches"),
            (flash_attention, "fwd_launches"),
            (flash_attention, "dq_launches"),
            (flash_attention, "dkv_launches"))


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
    return layout_transform.gather_rows(tokens, inv.contiguous(),
                                        slot.contiguous())


def layout_combine(buffer: torch.Tensor, slot: torch.Tensor,
                   weight: torch.Tensor) -> torch.Tensor:
    """Inverse transform: gather rows back per (token, k), then the
    weighted sum, rounded once to the buffer's dtype."""
    S, K = slot.shape
    rows = layout_transform.gather_rows(
        buffer, slot.reshape(-1).contiguous()).reshape(S, K, -1)
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
