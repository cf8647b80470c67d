"""Data layout transform (paper §3.2, Fig. 4) and its inverse — the port of
the single-device part of ``repro/core/layout.py``.

``sort``    ONE stable sort over expert ids gives each assignment's
            position within its expert; tokens past capacity drop.  The
            plan carries the permutation, counts, offsets and the
            buffer-side inverse row map for the (E·C, d) buffer.
``grouped`` the same sort packs the S·K assignments into an expert-sorted
            (S·K, d) buffer with no padding and no drops; the expert FFN
            runs as grouped matmuls over the segments.

Index tensors are int32, as in the reference and as the kernels take
them.  Padded tokens may route to a virtual expert E (``drop_bucket``):
they sort last and never reach a buffer, the counts or the combine.  The
row moves go through the gather and scatter-add kernels' wrappers (their
plain versions on a CPU tensor), and nothing here waits on the device:
the counts come from an ``index_add_`` into a fixed-size vector, not from
``bincount``, whose output size is read back to the host.  Each plan also
carries the inverse of its row map, (S, K) — the sort plan's ``slot``, the
grouped plan's ``dest`` — so the dispatches run the gather's fan-out form
(each token read once, written to its K rows).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.gating import GateOutput
from repro_torch.kernels import layout_transform, ops

# out[i] = src[idx[i]], zeros where idx < 0 — the gather kernel's wrapper
take_rows = ops.gather_rows


class DispatchPlan(NamedTuple):
    """``slot`` (S, K) row in the (E·C, d) buffer, -1 dropped; ``weight``
    (S, K) combine weight, 0 for dropped slots; ``sort_order`` (S·K,),
    ``counts`` (E,), ``offsets`` (E+1,), ``inv`` (E·C,) buffer row →
    source token, -1 empty."""
    slot: torch.Tensor
    weight: torch.Tensor
    sort_order: Optional[torch.Tensor] = None
    counts: Optional[torch.Tensor] = None
    offsets: Optional[torch.Tensor] = None
    inv: Optional[torch.Tensor] = None


class GroupedPlan(NamedTuple):
    """``sort_order`` (S·K,) k-major flat slot per sorted row, ``token``
    (S·K,) source token per sorted row, ``weight`` (S·K,) combine weight,
    ``counts`` (E,) rows per expert, ``offsets`` (E+1,) their prefix sum
    (rows past ``offsets[E]`` are the virtual bucket's tail), ``dest``
    (S, K) the sorted row of each (token, k) — the inverse of ``token``,
    which the dispatch's fan-out gather writes through.  The first five
    fields are the reference's."""
    sort_order: torch.Tensor
    token: torch.Tensor
    weight: torch.Tensor
    counts: torch.Tensor
    offsets: torch.Tensor
    dest: torch.Tensor


def _offsets(counts: torch.Tensor) -> torch.Tensor:
    z = torch.zeros((1,), dtype=counts.dtype, device=counts.device)
    return torch.cat([z, torch.cumsum(counts, 0)]).to(torch.int32)


def _sort_by_expert(gate: GateOutput, n_buckets: int):
    """THE one stable sort both plans share: ``(flat_e, order, sorted_e,
    counts)`` over the k-major flattened expert ids (every token's first
    choice outranks any second choice)."""
    S, K = gate.expert_index.shape
    flat_e = gate.expert_index.T.reshape(K * S).long()
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros((n_buckets,), dtype=torch.int64,
                         device=flat_e.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    return flat_e, order, flat_e[order], counts


def plan_sort(gate: GateOutput, num_experts: int, capacity: int,
              drop_bucket: bool = False) -> DispatchPlan:
    """HetuMoE path: one stable argsort over expert ids; each expert's
    first C assignments (slot-major priority) stay, the rest drop."""
    S, K = gate.expert_index.shape
    E, C = num_experts, capacity
    n_buckets = E + 1 if drop_bucket else E
    flat_e, order, sorted_e, counts = _sort_by_expert(gate, n_buckets)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(K * S, device=flat_e.device) - starts[sorted_e]
    keep_sorted = (pos_sorted < C) & (sorted_e < E)
    # buffer-side inverse; dropped rows land in a spare slot cut off below
    dest = torch.where(keep_sorted, sorted_e * C + pos_sorted, E * C)
    inv = torch.full((E * C + 1,), -1, dtype=torch.int32,
                     device=flat_e.device)
    inv[dest] = (order % S).to(torch.int32)
    pos = torch.empty_like(flat_e)
    pos[order] = pos_sorted
    keep = torch.empty_like(keep_sorted)
    keep[order] = keep_sorted
    slot = torch.where(keep, flat_e * C + pos, -1).reshape(K, S).T
    weight = torch.where(keep.reshape(K, S).T, gate.combine_weights, 0.0)
    return DispatchPlan(slot.to(torch.int32).contiguous(), weight,
                        sort_order=order.to(torch.int32),
                        counts=counts[:E].to(torch.int32),
                        offsets=_offsets(counts[:E]),
                        inv=inv[:E * C])


def plan_grouped(gate: GateOutput, num_experts: int,
                 drop_bucket: bool = False) -> GroupedPlan:
    """Dropless plan: the same single stable sort, no capacity."""
    S, K = gate.expert_index.shape
    E = num_experts
    n_buckets = E + 1 if drop_bucket else E
    _, order, sorted_e, counts = _sort_by_expert(gate, n_buckets)
    counts = counts[:E]
    flat_w = gate.combine_weights.T.reshape(K * S)
    weight = torch.where(sorted_e < E, flat_w[order], 0.0)
    # the inverse of the stable order: sorted row of each k-major slot
    row = torch.empty_like(order)
    row[order] = torch.arange(K * S, device=order.device)
    return GroupedPlan(sort_order=order.to(torch.int32),
                       token=(order % S).to(torch.int32),
                       weight=weight,
                       counts=counts.to(torch.int32),
                       offsets=_offsets(counts),
                       dest=row.reshape(K, S).T.to(torch.int32).contiguous())


def dispatch_scatter(tokens: torch.Tensor, plan: DispatchPlan) -> torch.Tensor:
    """(S, d) → (E·C, d) off the plan's inverse row map; the fan-out gather
    reads each token once and writes it to its ``slot`` rows (the inverse
    of ``inv``), zeros in the empty capacity slots."""
    return take_rows(tokens, plan.inv, plan.slot)


def combine_gather(expert_out: torch.Tensor,
                   plan: DispatchPlan) -> torch.Tensor:
    """(E·C, d) → (S, d): inverse layout transform + weighted combine,
    rounded once to the buffer's dtype."""
    return ops.layout_combine(expert_out, plan.slot, plan.weight)


def dispatch_grouped(tokens: torch.Tensor, plan: GroupedPlan) -> torch.Tensor:
    """(S, d) → (S·K, d) expert-sorted buffer — no padding, no drops: the
    fan-out gather reads each token once and writes its K ``dest`` rows."""
    return take_rows(tokens, plan.token, plan.dest)


def combine_grouped(expert_out: torch.Tensor, plan: GroupedPlan,
                    num_tokens: int) -> torch.Tensor:
    """(S·K, d) expert-sorted FFN output → (S, d) weighted combine: the
    scatter-add kernel's ordered sum, in f32 over each token's K rows in
    ascending buffer order (the order of the reference's scatter-add), one
    rounding at the end — the same bits on every run (not ``index_add_``,
    whose CUDA atomics add a token's rows in whatever order they land)."""
    contrib = expert_out.float() * plan.weight.float()[:, None]
    return layout_transform.scatter_add_rows(contrib, plan.token,
                                             num_tokens).to(expert_out.dtype)
