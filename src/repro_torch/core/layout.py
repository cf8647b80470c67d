"""Data layout transform (paper §3.2, Fig. 4) and its inverse — the port of
``repro/core/layout.py``.

``sort``    ONE stable sort over expert ids gives each assignment's
            position within its expert; tokens past capacity drop.  The
            plan carries the permutation, counts, offsets and the
            buffer-side inverse row map for the (E·C, d) buffer.
``dense``   the GShard/DeepSpeed baseline: positions from running one-hot
            cumsums (``plan_cumsum``, the same slots as ``plan_sort``) and
            a (S·K, E·C) one-hot product for dispatch and combine — a plain
            matrix product, outside any kernel in the reference too.
``grouped`` the same sort packs the S·K assignments into an expert-sorted
            (S·K, d) buffer with no padding and no drops; the expert FFN
            runs as grouped matmuls over the segments.  Under expert
            parallelism (M ranks) ``plan_grouped_ep`` freezes it into the
            static (M, B, d) exchange layout, and the receive side rebuilds
            expert-major offsets from the exchanged counts
            (``grouped_ep_receive_maps``) — offset arithmetic, no sort.

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


class GroupedEPPlan(NamedTuple):
    """Send-side state of the grouped expert-parallel AllToAll: ``bound``
    B (rows per destination-rank chunk, a Python int), ``send_counts``
    (M, E_local) rows packed per (destination rank, local expert),
    ``pack_map`` (M·B,) exchange slot → source token (-1 padding),
    ``back_map`` (S·K,) sorted row → exchange slot (-1 bound-dropped or
    virtual-bucket row)."""
    bound: int
    send_counts: torch.Tensor
    pack_map: torch.Tensor
    back_map: torch.Tensor


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


def plan_cumsum(gate: GateOutput, num_experts: int, capacity: int,
                drop_bucket: bool = False) -> DispatchPlan:
    """GShard baseline: position via running one-hot cumsums, slot k
    counting every token of slots < k — the same slots as
    :func:`plan_sort`; counts and offsets from the running totals, no sort
    permutation.  The one-hot is a comparison with an arange (``one_hot``
    reads its input's range on the host)."""
    S, K = gate.expert_index.shape
    E = num_experts
    n_buckets = E + 1 if drop_bucket else E
    ei = gate.expert_index.long()
    oh = (ei[..., None] == torch.arange(n_buckets, device=ei.device)
          ).to(torch.int32)                                       # (S,K,B)
    pos = torch.zeros((S, K), dtype=torch.int32, device=ei.device)
    running = torch.zeros((n_buckets,), dtype=torch.int32, device=ei.device)
    for k in range(K):
        csum = torch.cumsum(oh[:, k], dim=0, dtype=torch.int32) - oh[:, k]
        pos[:, k] = (oh[:, k] * (csum + running[None])).sum(dim=-1)
        running = running + oh[:, k].sum(dim=0, dtype=torch.int32)
    keep = (pos < capacity) & (ei < E)
    slot = torch.where(keep, ei * capacity + pos, -1)
    weight = torch.where(keep, gate.combine_weights, 0.0)
    counts = running[:E]
    return DispatchPlan(slot.to(torch.int32).contiguous(), weight,
                        counts=counts, offsets=_offsets(counts))


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


def plan_grouped_ep(gplan: GroupedPlan, num_experts: int, model_size: int,
                    bound: int) -> GroupedEPPlan:
    """Freeze a :class:`GroupedPlan` into the static grouped-EP exchange
    layout: the expert-sorted buffer is destination-rank-sorted too
    (experts shard contiguously over ranks), so rank m's rows are the
    segment ``offsets[m·E_local] : offsets[(m+1)·E_local]``, cut at
    ``bound`` (its later experts first)."""
    E, M, B = num_experts, model_size, bound
    if E % M:
        raise ValueError(f"num_experts={E} does not divide over "
                         f"model_size={M}")
    E_local = E // M
    TK = gplan.token.shape[0]
    dev = gplan.offsets.device
    offs = gplan.offsets.long()
    bounds = offs[torch.arange(M + 1, device=dev) * E_local]       # (M+1,)
    rank_start = bounds[:-1]
    g_off = offs[torch.arange(M, device=dev)[:, None] * E_local
                 + torch.arange(E_local + 1, device=dev)[None, :]]
    rel = torch.clamp(g_off - rank_start[:, None], max=B)
    send_counts = (rel[:, 1:] - rel[:, :-1]).to(torch.int32)
    sent = rel[:, -1]
    j = torch.arange(B, device=dev)
    rows = rank_start[:, None] + j[None, :]
    tok = gplan.token[torch.clamp(rows, 0, max(TK - 1, 0))]
    pack_map = torch.where(j[None, :] < sent[:, None], tok, -1)
    r = torch.arange(TK, device=dev)
    m_of = (r[:, None] >= bounds[None, 1:]).sum(dim=-1)           # 0..M
    m_safe = torch.clamp(m_of, 0, M - 1)
    jj = r - bounds[m_safe]
    ok = (m_of < M) & (jj < B)
    back_map = torch.where(ok, m_safe * B + jj, -1)
    return GroupedEPPlan(bound=B, send_counts=send_counts,
                         pack_map=pack_map.reshape(M * B).to(torch.int32),
                         back_map=back_map.to(torch.int32))


def grouped_ep_receive_maps(recv_counts: torch.Tensor, bound: int):
    """Receive side: rebuild the expert-major FFN order from the exchanged
    ``recv_counts`` (M, E_local), source-major.  Returns ``ffn_src`` (M·B,)
    FFN row → received row (-1 past the live rows), ``dst_map`` (M·B,)
    received row → FFN row (-1 padding) and ``group_sizes`` (E_local,)
    FFN rows per local expert: destination row = expert base + rows from
    earlier source ranks + the row's place in its segment."""
    M, E_local = recv_counts.shape
    B = bound
    dev = recv_counts.device
    rc = recv_counts.long()
    src_off = torch.cat([torch.zeros((M, 1), dtype=torch.long, device=dev),
                         torch.cumsum(rc, dim=1)], dim=1)
    chunk_tot = src_off[:, -1]
    j = torch.arange(B, device=dev)
    e_id = (j[None, :, None] >= src_off[:, None, 1:]).sum(dim=-1)   # (M, B)
    e_safe = torch.clamp(e_id, 0, E_local - 1)
    group_sizes = rc.sum(dim=0)
    e_base = torch.cat([torch.zeros((1,), dtype=torch.long, device=dev),
                        torch.cumsum(group_sizes, 0)[:-1]])
    from_prev = torch.cumsum(rc, dim=0) - rc
    dst = (e_base[e_safe] + torch.gather(from_prev, 1, e_safe)
           + (j[None, :] - torch.gather(src_off, 1, e_safe)))
    dst = torch.where(j[None, :] < chunk_tot[:, None], dst, -1)
    dst_map = dst.reshape(M * B)
    ffn_src = torch.full((M * B + 1,), -1, dtype=torch.int32, device=dev)
    ffn_src[torch.where(dst_map >= 0, dst_map, M * B)] = torch.arange(
        M * B, dtype=torch.int32, device=dev)
    return (ffn_src[:M * B], dst_map.to(torch.int32),
            group_sizes.to(torch.int32))


def grouped_tp_gather_maps(counts: torch.Tensor, bound: int):
    """:func:`grouped_ep_receive_maps` over ``counts`` flattened to
    (chunks, E_seg) — the form the EP compute path calls (the reference
    merges expert-TP ranks' chunks through it too; expert TP is a later
    slice)."""
    return grouped_ep_receive_maps(counts.reshape(-1, counts.shape[-1]),
                                   bound)


def grouped_chunk_counts(counts: torch.Tensor, bound: int,
                         n_chunks: int) -> torch.Tensor:
    """Split ``counts`` (N, E_seg) of bounded expert-sorted segments into
    the (n_chunks, N, E_seg) counts of the overlap pipeline's windows of
    ``bound / n_chunks`` rows; each window again satisfies the receive-map
    contract, and the windows sum back to ``counts``."""
    N = counts.shape[0]
    bc = bound // n_chunks
    dev = counts.device
    off = torch.cat([torch.zeros((N, 1), dtype=torch.int32, device=dev),
                     torch.cumsum(counts, dim=1, dtype=torch.int32)], dim=1)
    win = (torch.arange(n_chunks, dtype=torch.int32, device=dev) * bc
           )[:, None, None]
    rel = torch.clamp(off[None] - win, 0, bc)
    return (rel[..., 1:] - rel[..., :-1]).to(torch.int32)


def dispatch_dense(tokens: torch.Tensor, plan: DispatchPlan,
                   num_experts: int, capacity: int) -> torch.Tensor:
    """Dense one-hot dispatch (the baseline of the paper's Fig. 4):
    (S, K, E·C) one-hot × (S, d) → (E·C, d), O(S·E·C·d)."""
    mask = _slot_one_hot(plan.slot, num_experts * capacity, tokens.dtype)
    return torch.einsum("skc,sd->cd", mask, tokens)


def combine_dense(expert_out: torch.Tensor, plan: DispatchPlan,
                  num_experts: int, capacity: int) -> torch.Tensor:
    """Dense combine: (S, K, E·C) weighted one-hot × (E·C, d)."""
    keep = plan.slot >= 0
    mask = _slot_one_hot(plan.slot, num_experts * capacity,
                         expert_out.dtype)
    w = (plan.weight * keep).to(expert_out.dtype)
    return torch.einsum("skc,sk,cd->sd", mask, w, expert_out)


def _slot_one_hot(slot: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(S, K, n) one-hot of ``slot``, all zeros where ``slot`` < 0."""
    return (slot.long()[..., None]
            == torch.arange(n, device=slot.device)).to(dtype)
