"""The HetuMoE layer — paper Algorithm 1, expert-parallel over the ranks of
a ``launch/mesh.Mesh`` — the port of ``repro/core/moe.py`` (``moe_apply``
is ``sharded_moe_apply`` on one device).

Per-rank flow (one process per rank; the reference's ``shard_map`` body):

    1. gate            route(cfg, x·W)                     [core/gating]
    2. layout xform    plan + dispatch → (E·C, d)           [core/layout]
    3. AllToAll        flat | hierarchical over ``model``   [core/alltoall]
    4. experts         the batched FFN over local experts
    5. AllToAll        return path (same mode)
    6. reverse xform   gather + weighted combine            [core/layout]

``dispatch="sort"`` builds the capacity-padded buffer off one stable sort
(the gather kernel), ``"dense"`` off one-hot cumsums and a one-hot matrix
product (the paper's baseline), ``"grouped"`` is the dropless path: an
expert-sorted buffer and grouped matmuls (kernels 3–5).  Under expert
parallelism the grouped AllToAll runs instead: per-expert counts cross the
model group first (an (M, E_local) int32 exchange), then each destination
rank's rows packed to a static bound B (``capacity.grouped_segment_bound``;
B = T·K by default, which never drops); the receive side rebuilds its
expert-major offsets from the counts (``layout.grouped_tp_gather_maps``),
and the combine reverses the path.  ``overlap_chunks = P > 1`` splits the
bounded buffer into P windows: window i+1's dispatch exchange is issued
(``async_op=True``) before window i's grouped matmuls, and each window's
combine is waited on at the drain.  ``payload_dtype`` sends the payloads
as int8/fp8 with per-chunk scales (``alltoall.quantized_exchange``;
those exchanges run synchronously).

Tokens are split over every rank, data-major: rank r holds the r-th
contiguous block of the flattened tokens (``rank_tokens`` cuts it from the
global tokens, padding them to a multiple of the world as the reference
does; padded tokens route to a virtual expert E, which the plans drop).
Experts shard over ``model`` and replicate over ``data``: ``params`` hold
the rank's E/M experts.  The aux loss is a global masked mean over the
world (``balance``); the load metrics are averaged over it.

Expert tensor parallelism (``expert_tp_axis="data"``, the reference's
decode-time layout): the rank of data index ``di`` of D holds and computes
with the f-slice ``[di·f/D, (di+1)·f/D)`` of its experts (``w_up`` /
``w_gate``'s last dim and ``w_out``'s middle one, what the reference's
``P(model, None, "data")`` stores on that device: ``launch/shard.Layout``
with ``expert_tp``), on the received rows of every rank of its data group
(``alltoall.tp_all_gather``), and a reduce-scatter
(``alltoall.tp_reduce_scatter``) hands each rank its rows back with the
f-contraction summed.

Serving holds each data rank's rows and, in the prefill, each model
rank's chunk of their positions (``launch/mesh.serve_block``), while the
reference's layer takes the r-th contiguous block of the flattened
tokens on device r whatever the activations' layout.  So a served
``moe`` block first brings its tokens to the reference's block
(:func:`served_tokens`): they are that block already (``own``); or every
rank of a group holds the group's blocks alike and
:func:`replicated_moe_apply` cuts the rank's block and all-gathers the
outputs over the group (``replicate``: a decode step's rows over
``model``, or a batch whole on every rank); or a :class:`TokenRoute`
exchanges them over the model group or the world, each token sent once
to the rank whose block holds it and its output sent back to every rank
that holds the token (``route``: a context-parallel prefill of more than
one row a data rank, or rows whole over ``data``).  Each rank routes
exactly the reference's tokens at any count.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import draw
from repro_torch.core import (alltoall, balance, capacity, gating, layout,
                              tuning)
from repro_torch.core.config import MoEConfig
from repro_torch.kernels import grouped_ffn as gffn


def init_moe_params(generator: torch.Generator, cfg: MoEConfig, d_model: int,
                    d_ff: int, num_experts: int, *, act: str = "swiglu",
                    dtype=torch.float32, device=None,
                    cut: Optional[Callable[[str, torch.Tensor],
                                           torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Router (f32) + expert weights in ``dtype``, drawn from
    ``generator`` (each cast right after its draw).  ``cut(name, leaf)``
    keeps a rank's block of each expert leaf (``launch/shard.Layout``):
    the leaf is drawn whole, so the values are one process's, and freed
    once its block is copied out."""
    d_ff = cfg.d_ff_expert or d_ff

    def randn(scale, *shape, dtype=dtype):
        return draw(generator, shape, scale, device=device, dtype=dtype)

    def expert(name, scale, *shape):
        t = randn(scale, num_experts, *shape)
        return t if cut is None else cut(name, t)

    scale_in, scale_out = d_model ** -0.5, d_ff ** -0.5
    p = {"gate_w": randn(scale_in, d_model, num_experts, dtype=torch.float32),
         "w_up": expert("w_up", scale_in, d_model, d_ff),
         "w_out": expert("w_out", scale_out, d_ff, d_model)}
    if act in ("swiglu", "geglu"):
        p["w_gate"] = expert("w_gate", scale_in, d_model, d_ff)
    return p


def _act(h: torch.Tensor, g: Optional[torch.Tensor], act: str):
    if act == "swiglu":
        return h * torch.nn.functional.silu(g)
    if act == "geglu":
        return h * torch.nn.functional.gelu(g, approximate="tanh")
    if act == "gelu":
        return torch.nn.functional.gelu(h, approximate="tanh")
    return torch.relu(h)


def expert_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor,
               act: str) -> torch.Tensor:
    """(E, C, d) × expert weights → (E, C, d): the sort and dense paths'
    batched expert product (an XLA einsum in the reference, not a kernel)."""
    h = torch.bmm(x, params["w_up"])
    g = torch.bmm(x, params["w_gate"]) if act in ("swiglu", "geglu") else None
    return torch.bmm(_act(h, g, act), params["w_out"])


def _pmean(metrics: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The metrics averaged over every rank (one all-reduce)."""
    with torch.no_grad():
        v = torch.stack([metrics[k].detach().float()
                         for k in balance.METRIC_KEYS])
        dist.all_reduce(v)
        v = v / mesh.world
    return dict(zip(balance.METRIC_KEYS, v.unbind(0), strict=True))


def moe_block_local(cfg: MoEConfig, params: Dict[str, torch.Tensor],
                    x: torch.Tensor, *, num_experts: int, act: str,
                    mesh=None, valid: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None,
                    token_ids: Optional[torch.Tensor] = None,
                    expert_tp: bool = False,
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Dict[str, torch.Tensor]]:
    """x: (T, d) this rank's tokens → (y, aux_loss, metrics).  ``cfg`` must
    be resolved (no ``"auto"``); ``params`` hold the rank's E/M experts
    (with ``expert_tp``, its stored f-slice of them); ``mesh`` None is one
    device.  ``noise`` (T, E) and ``token_ids`` (T,) go to the gate
    (``gating.route``).

    ``expert_tp`` (the reference's ``expert_tp_axis="data"``, mesh data
    size D > 1): sort/dense gather the received ``(E_local, M·C, d)``
    buffer over the data group along its rows, run the f-slice, and
    reduce-scatter the rows back; grouped gathers each window's received
    chunks and their count matrices, merges them into one expert-major
    order (``layout.grouped_tp_gather_maps``), runs the grouped matmuls on
    the f-slice and reduce-scatters the rows in chunk layout, so the EP
    combine runs on the reduced rows."""
    T, d = x.shape
    E = num_experts
    M = 1 if mesh is None else mesh.shape["model"]
    E_local = E // M
    group = None if mesh is None else dist.group.WORLD
    if params["w_up"].shape[0] != E_local:
        raise ValueError(f"params hold {params['w_up'].shape[0]} experts, "
                         f"the rank's share of {E} over model={M} is "
                         f"{E_local}")
    if not cfg.use_pallas_gate and x.device.type != "cpu":
        raise ValueError(
            f"MoEConfig.use_pallas_gate=False: the port has no layer without "
            f"its kernels on {x.device} (only a CPU tensor takes their plain "
            f"versions); set it to True")

    logits = gating.router_logits(cfg, x, params["gate_w"])
    gate = gating.route(cfg, logits, noise=noise, token_ids=token_ids)
    if valid is not None:
        # padded tokens → virtual expert E: dropped by the plan, weight 0
        gate = gate._replace(
            expert_index=torch.where(valid[:, None], gate.expert_index, E
                                     ).to(torch.int32),
            combine_weights=torch.where(valid[:, None], gate.combine_weights,
                                        0.0))

    if cfg.dispatch == "grouped":
        gplan = layout.plan_grouped(gate, E, drop_bucket=True)
        aux, metrics = balance.aux_losses(cfg, gate,
                                          expert_counts=gplan.counts,
                                          valid=valid, group=group)
        if M == 1 and cfg.overlap_chunks == 1 and not expert_tp:
            xs = layout.dispatch_grouped(x, gplan)
            ys = gffn.grouped_ffn(params, xs.to(params["w_up"].dtype),
                                  gplan.offsets, act)
        else:
            ys = _grouped_exchange(cfg, params, x, gplan, mesh, act,
                                   expert_tp)
        y = layout.combine_grouped(ys, gplan, T)
    else:
        C = capacity.expert_capacity(cfg, T, E)
        if cfg.dispatch == "sort":
            plan = layout.plan_sort(gate, E, C, drop_bucket=True)
            buf = layout.dispatch_scatter(x, plan)
        else:
            plan = layout.plan_cumsum(gate, E, C, drop_bucket=True)
            buf = layout.dispatch_dense(x, plan, E, C)
        aux, metrics = balance.aux_losses(cfg, gate, expert_counts=plan.counts,
                                          valid=valid, group=group)
        if M > 1:
            buf = alltoall.all_to_all(buf.reshape(M, E_local * C, d), mesh,
                                      mode=cfg.a2a, inner=cfg.a2a_inner)
            # (M, E_local·C, d) source-major → (E_local, M·C, d)
            buf = buf.reshape(M, E_local, C, d).transpose(0, 1).reshape(
                E_local, M * C, d)
        else:
            buf = buf.reshape(E, C, d)
        if expert_tp:
            # every data rank's received rows, each rank its f-slice, the
            # f-contraction reduced while each rank takes its rows back
            buf = alltoall.tp_all_gather(buf, mesh, dim=1)
        h = expert_ffn(params, buf.to(params["w_up"].dtype), act)
        if expert_tp:
            h = alltoall.tp_reduce_scatter(h, mesh, dim=1)
        if M > 1:
            h = h.reshape(E_local, M, C, d).transpose(0, 1).reshape(
                M, E_local * C, d)
            h = alltoall.all_to_all(h, mesh, mode=cfg.a2a,
                                    inner=cfg.a2a_inner)
        h = h.reshape(E * C, d)
        y = (layout.combine_gather(h, plan) if cfg.dispatch == "sort"
             else layout.combine_dense(h, plan, E, C))
    if mesh is not None:
        metrics = _pmean(metrics, mesh)
    return y.to(x.dtype), aux, metrics


def _grouped_exchange(cfg: MoEConfig, params, x: torch.Tensor,
                      gplan: layout.GroupedPlan, mesh, act: str,
                      expert_tp: bool = False) -> torch.Tensor:
    """The grouped path's bounded exchange (the reference's
    ``moe_block_local`` grouped branch at ``model_size > 1``,
    ``overlap_chunks > 1`` or under expert TP): (T·K, d) sorted FFN rows
    of this rank's assignments, computed by the ranks that own their
    experts."""
    T, d = x.shape
    E = gplan.counts.shape[0]
    M = 1 if mesh is None else mesh.shape["model"]
    gather = layout.take_rows
    if M > 1:
        B = capacity.grouped_segment_bound(cfg, T, M)
        eplan = layout.plan_grouped_ep(gplan, E, M, B)
        packed = gather(x, eplan.pack_map).reshape(M, B, d)
        send_counts = eplan.send_counts                  # (M, E_local)
    else:
        B = capacity.grouped_tp_gather_bound(cfg, T)
        packed = gather(x, gplan.token).reshape(1, B, d)
        send_counts = gplan.counts[None]                 # (1, E)
    n_src = packed.shape[0]
    qdt = cfg.payload_dtype if M > 1 else None

    def exchange(chunk, counts, pending):
        if M == 1:
            return chunk, counts
        if qdt is not None:
            return alltoall.quantized_exchange(
                chunk, counts, mesh, mode=cfg.a2a, inner=cfg.a2a_inner,
                payload_dtype=qdt)
        return alltoall.grouped_all_to_all(
            chunk, counts, mesh, mode=cfg.a2a, inner=cfg.a2a_inner,
            pending=pending)

    def compute(recv, counts, bc, pending):
        """Grouped matmuls over one received window (n_src, bc, d); the
        FFN rows go back to the window's source ranks (with ``pending``
        the combine's last stage is issued asynchronously)."""
        if expert_tp:
            # every data rank's chunks and counts: the chunk layout is the
            # same on all of them (its bound comes from static shapes)
            recv = alltoall.tp_all_gather(recv, mesh)
            counts = alltoall.tp_all_gather(counts, mesh)
        n_chunks = recv.shape[0]
        if M > 1 or expert_tp:
            ffn_src, dst_map, group_sizes = layout.grouped_tp_gather_maps(
                counts, bc)
            xs = gather(recv.reshape(n_chunks * bc, d), ffn_src)
        else:
            xs, group_sizes = recv.reshape(bc, d), counts[0]
        ys = gffn.grouped_ffn(params, xs.to(params["w_up"].dtype),
                              layout._offsets(group_sizes), act)
        if expert_tp:
            # back to chunk layout, the f-contraction reduced while each
            # data rank takes its own chunks (n_src·bc rows)
            ys = alltoall.tp_reduce_scatter(gather(ys, dst_map), mesh)
        if M == 1:
            return ys.reshape(1, bc, d)
        h = (ys if expert_tp else gather(ys, dst_map)).reshape(M, bc, d)
        if qdt is not None:
            # dequantized into f32: the combine's reduction stays f32
            out, _ = alltoall.quantized_exchange(
                h, None, mesh, mode=cfg.a2a, inner=cfg.a2a_inner,
                payload_dtype=qdt, out_dtype=torch.float32)
            return out
        return alltoall.all_to_all(h, mesh, mode=cfg.a2a,
                                   inner=cfg.a2a_inner, pending=pending)

    P = cfg.overlap_chunks
    if P > 1:
        Bc = capacity.grouped_overlap_chunk_bound(cfg, B)
        chunk_counts = layout.grouped_chunk_counts(send_counts, B, P)
        windows = packed.reshape(n_src, P, Bc, d)
        asyn = qdt is None
        dispatched = [[] if asyn else None for _ in range(P)]
        combined = [] if asyn else None
        recv = exchange(windows[:, 0], chunk_counts[0], dispatched[0])
        outs = []
        for i in range(P):
            if i + 1 < P:    # issue the next window's exchange first
                nxt = exchange(windows[:, i + 1], chunk_counts[i + 1],
                               dispatched[i + 1])
            if asyn:
                alltoall.wait(dispatched[i])
            outs.append(compute(*recv, Bc, combined))
            if i + 1 < P:
                recv = nxt
        if asyn:
            alltoall.wait(combined)                   # the drain
        out = torch.stack(outs, dim=1).reshape(n_src, B, d)
    else:
        out = compute(*exchange(packed, send_counts, None), B, None)
    if M > 1:
        # combined exchange layout → this rank's sorted rows
        return gather(out.reshape(M * B, d), eplan.back_map)
    return out.reshape(B, d)


# ---------------------------------------------------------------------------
# the layer over the ranks
# ---------------------------------------------------------------------------

def _pad_to(x: torch.Tensor, mult: int):
    n = x.shape[0]
    pad = (-n) % mult
    if pad == 0:
        return x, n
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]), n


GROUPS = ("model", "data", "world")


def _group(mesh, group: str):
    """``(process group, size, this rank's index)`` of ``group`` (a name
    of :data:`GROUPS`) on ``mesh`` (None: one device)."""
    if group not in GROUPS:
        raise ValueError(f"group={group!r} not in {GROUPS}")
    if mesh is None:
        return None, 1, 0
    if group == "model":
        return mesh.model_group, mesh.shape["model"], mesh.model_index
    if group == "data":
        return mesh.data_group, mesh.shape["data"], mesh.data_index
    return None, mesh.world, mesh.rank


def _rank_rows(mesh, rows: torch.Tensor,
               group: str = "world") -> torch.Tensor:
    """This rank's block of ``rows`` (N, ...) padded with zeros to a
    multiple of the ``group``'s size, in group-rank order."""
    _, n_ranks, idx = _group(mesh, group)
    rows = _pad_to(rows, n_ranks)[0]
    n = rows.shape[0] // n_ranks
    return rows[idx * n:(idx + 1) * n]


def rank_tokens(mesh, x: torch.Tensor,
                token_ids: Optional[torch.Tensor] = None,
                group: str = "world"):
    """This rank's block of the tokens ``x`` (..., d) that every rank of
    ``group`` holds alike (the world's: the global tokens): the flattened
    tokens padded to a multiple of the group's size (the reference's
    ``_pad_to``) and cut into contiguous blocks in group-rank order.
    Returns ``(tokens (T_local, d), valid (T_local,), token_ids or None,
    n_real)``."""
    toks = x.reshape(-1, x.shape[-1])
    n_real = toks.shape[0]
    valid = _rank_rows(mesh, torch.ones((n_real,), dtype=torch.bool,
                                        device=x.device), group)
    tid = (None if token_ids is None
           else _rank_rows(mesh, token_ids.reshape(-1), group))
    return _rank_rows(mesh, toks, group), valid, tid, n_real


def grouped_a2a_stages(cfg: MoEConfig, model_size: int) -> int:
    """Exchanges one payload AllToAll issues: 1 flat, 2 for an effective
    two-stage one (``1 < a2a_inner < model_size``, dividing it)."""
    if (cfg.a2a == "hierarchical" and 1 < cfg.a2a_inner
            and model_size % cfg.a2a_inner == 0
            and model_size // cfg.a2a_inner > 1):
        return 2
    return 1


def expected_grouped_a2a_eqns(cfg: MoEConfig, model_size: int) -> int:
    """AllToAll collectives the grouped path issues per layer forward —
    what ``alltoall.exchanges`` rises by: per overlap window one flat
    counts exchange plus a dispatch and a combine payload exchange of
    :func:`grouped_a2a_stages` each, plus one scales exchange in the
    combine direction with ``payload_dtype``."""
    if tuning.has_auto_knobs(cfg):
        raise ValueError(
            "expected_grouped_a2a_eqns needs a concrete config — resolve "
            "'auto' knobs first (core/tuning.resolve_moe_config)")
    if cfg.dispatch != "grouped" or model_size <= 1:
        return 0
    stages = grouped_a2a_stages(cfg, model_size)
    per_window = 1 + 2 * stages
    if cfg.payload_dtype is not None:
        per_window += 1
    return cfg.overlap_chunks * per_window


def validate_dispatch_config(cfg: MoEConfig, *, model_size: int = 1,
                             model_axis: str = "model",
                             tokens_per_shard: Optional[int] = None,
                             d_model: Optional[int] = None,
                             dtype=None) -> None:
    """Raise ``ValueError`` for a cfg × mesh combination the layer cannot
    run (the reference's checks and messages).  ``"auto"`` knobs are
    resolved first when ``tokens_per_shard`` is known, and an error then
    names the resolved values."""
    auto_cfg = None
    if tuning.has_auto_knobs(cfg):
        if tokens_per_shard is None:
            return
        auto_cfg = cfg
        cfg = tuning.resolve_moe_config(
            cfg, model_size=model_size, tokens_per_shard=tokens_per_shard,
            d_model=d_model if d_model is not None else 1024, dtype=dtype)
    try:
        _validate_concrete(cfg, model_size=model_size, model_axis=model_axis,
                           tokens_per_shard=tokens_per_shard)
    except ValueError as e:
        if auto_cfg is not None:
            raise ValueError(
                f"{e} [{tuning.describe_resolution(auto_cfg, cfg)}]"
            ) from None
        raise


def _validate_concrete(cfg: MoEConfig, *, model_size: int, model_axis: str,
                       tokens_per_shard: Optional[int]) -> None:
    if cfg.overlap_chunks > 1 and cfg.dispatch != "grouped":
        raise ValueError(
            f"MoEConfig.overlap_chunks={cfg.overlap_chunks} requires "
            f"dispatch='grouped' (the overlapped pipeline chunks the "
            f"grouped dispatch buffer), got dispatch="
            f"{cfg.dispatch!r}")
    if (cfg.a2a == "hierarchical" and cfg.a2a_inner > 1
            and model_size > 1 and model_size % cfg.a2a_inner != 0):
        raise ValueError(
            f"MoEConfig.a2a='hierarchical' with a2a_inner={cfg.a2a_inner} "
            f"does not divide the mesh {model_axis!r} axis size "
            f"{model_size} — pick a2a_inner from its divisors or use "
            f"a2a='flat'")
    if (tokens_per_shard is not None and cfg.dispatch == "grouped"
            and cfg.overlap_chunks > 1):
        B = (capacity.grouped_segment_bound(cfg, tokens_per_shard, model_size)
             if model_size > 1
             else capacity.grouped_tp_gather_bound(cfg, tokens_per_shard))
        capacity.grouped_overlap_chunk_bound(cfg, B)   # raises when P ∤ B


def sharded_moe_apply(mesh, cfg: MoEConfig, params: Dict[str, torch.Tensor],
                      x: torch.Tensor, *, num_experts: int,
                      act: str = "swiglu",
                      noise: Optional[torch.Tensor] = None,
                      token_ids: Optional[torch.Tensor] = None,
                      valid: Optional[torch.Tensor] = None,
                      expert_tp_axis: Optional[str] = None,
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Dict[str, torch.Tensor]]:
    """The MoE layer on this rank's tokens ``x: (..., d)`` under ``mesh``
    (None: one device).  Leading dims flatten into one token axis; every
    rank must hold as many tokens (:func:`rank_tokens` cuts and pads them
    from the global ones and gives their ``valid`` mask).  ``params`` hold
    the router and the rank's E/M experts, cast here to the compute dtype
    (a no-op when the model already keeps them in it); ``noise`` (T, E)
    is this rank's rows of a noisy gate's global draw
    (``gating.draw_noise``); ``token_ids`` (``x``'s leading dims) route
    the ``hash`` gate, which raises ``ValueError`` without them.

    ``expert_tp_axis="data"`` runs expert TP over the data group (see the
    module docstring): ``params`` hold the rank's stored f-slice of its
    experts (``launch/shard.Layout(expert_tp=True)``, whose layout
    refuses an f that does not divide over D).  At data size 1 (and
    without a mesh) it is the identity.  Any other axis raises the
    reference's ``ValueError`` naming the mesh's axes."""
    if expert_tp_axis is not None and expert_tp_axis != "data":
        # a typo'd axis must not silently disable expert TP
        raise ValueError(
            f"expert_tp_axis={expert_tp_axis!r} is not an axis of the mesh; "
            f"valid axis names: {MESH_AXES}")
    lead, d = x.shape[:-1], x.shape[-1]
    toks = x.reshape(-1, d)
    T = toks.shape[0]
    M = 1 if mesh is None else mesh.shape["model"]
    D = 1 if mesh is None else mesh.shape["data"]
    tp = expert_tp_axis is not None and D > 1
    if token_ids is not None:
        token_ids = token_ids.reshape(-1)
    elif cfg.gate == "hash":
        raise ValueError(
            "cfg.gate='hash' routes by token id: pass token_ids to the MoE "
            "layer (without them every token would hash to one expert)")
    if valid is None:
        valid = torch.ones((T,), dtype=torch.bool, device=x.device)
    params = {k: (v if k == "gate_w" else v.to(x.dtype))
              for k, v in params.items()}
    cfg = tuning.resolve_moe_config(cfg, model_size=M, tokens_per_shard=T,
                                    d_model=d, dtype=x.dtype)
    validate_dispatch_config(cfg, model_size=M, tokens_per_shard=T)
    y, aux, metrics = moe_block_local(cfg, params, toks,
                                      num_experts=num_experts, act=act,
                                      mesh=mesh, valid=valid, noise=noise,
                                      token_ids=token_ids, expert_tp=tp)
    return y.reshape(*lead, d), aux, metrics


MESH_AXES = ("data", "model")


def replicated_moe_apply(mesh, cfg: MoEConfig,
                         params: Dict[str, torch.Tensor], x: torch.Tensor, *,
                         num_experts: int, act: str = "swiglu",
                         noise: Optional[torch.Tensor] = None,
                         token_ids: Optional[torch.Tensor] = None,
                         expert_tp_axis: Optional[str] = None,
                         group: str = "world",
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    Dict[str, torch.Tensor]]:
    """The MoE layer over activations that every rank of ``group`` holds
    alike (serving; ``group`` one of :data:`GROUPS`: ``model`` for a
    decode step's rows, ``data`` for rows whole over ``data``, the world
    for a block whole on every rank): ``x`` (..., d) those tokens; each
    rank runs :func:`sharded_moe_apply` on its block of them
    (:func:`rank_tokens`: padded to the group's size, in group-rank
    order), so every token is routed once across the group at any token
    count, and the outputs are all-gathered over the group and the
    padding cut.  ``noise`` (the tokens' (T, E) draw) and ``token_ids``
    are cut the same way.  Returns the same ``(y, aux, metrics)`` on
    every rank of the group.  For inference: the gather passes no
    gradient.  ``mesh`` None is :func:`sharded_moe_apply` on one
    device."""
    if mesh is None:
        return sharded_moe_apply(None, cfg, params, x,
                                 num_experts=num_experts, act=act,
                                 noise=noise, token_ids=token_ids,
                                 expert_tp_axis=expert_tp_axis)
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError(
            "replicated_moe_apply serves (its output gather passes no "
            "gradient); a trainer runs sharded_moe_apply on each rank's "
            "own rows")
    lead, d = x.shape[:-1], x.shape[-1]
    pg, n, _ = _group(mesh, group)
    xl, valid, tid, n_real = rank_tokens(mesh, x, token_ids, group)
    nl = None if noise is None else _rank_rows(mesh, noise, group)
    yl, aux, metrics = sharded_moe_apply(
        mesh, cfg, params, xl, num_experts=num_experts, act=act, noise=nl,
        token_ids=tid, valid=valid, expert_tp_axis=expert_tp_axis)
    y = alltoall.gather_rows(yl, pg, n, axis=group)
    return y[:n_real].reshape(*lead, d), aux, metrics


# ---------------------------------------------------------------------------
# a served block's tokens → the reference's MoE block
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TokenRoute:
    """The exchange of a served block's tokens into this rank's block of
    the reference's MoE layer (the ``T`` flattened tokens ``[rank·T,
    (rank+1)·T)``, the last blocks padded) and of the outputs back, over
    ``axis`` (``model``: every token stays in its data rank's model
    group; ``world``), as group index ``me`` of ``n``.  A token is sent
    by the rank whose block holds it when that rank holds it too, else
    by its lowest holder; its output goes back to every holder.
    ``send_idx`` are the own tokens sent, in send order, ``recv_perm``
    the received rows in block order, ``back_idx`` the block's rows sent
    back in send order; the counts are per group rank.  ``dispatch`` /
    ``back`` say whether any rank's tokens cross (all ranks agree: when
    none cross the rows are only reordered here)."""
    axis: str
    n: int
    me: int
    T: int
    n_real: int
    send_idx: Tuple[int, ...]
    send_counts: Tuple[int, ...]
    recv_counts: Tuple[int, ...]
    recv_perm: Tuple[int, ...]
    back_idx: Tuple[int, ...]
    back_send: Tuple[int, ...]
    back_recv: Tuple[int, ...]
    dispatch: bool
    back: bool
    group: Any = None

    def valid(self, device) -> torch.Tensor:
        """The block's mask of real tokens (T,)."""
        return torch.arange(self.T, device=device) < self.n_real

    def to_block(self, x: torch.Tensor) -> torch.Tensor:
        """The block's rows (T, ...) of the own tokens ``x`` (n_own, ...),
        zeros past the real ones."""
        idx = torch.tensor(self.send_idx, dtype=torch.long, device=x.device)
        buf = x[idx]
        if self.dispatch:
            buf = alltoall.exchange_uneven(buf, self.send_counts,
                                           self.recv_counts, self.group,
                                           self.axis)
        perm = torch.tensor(self.recv_perm, dtype=torch.long,
                            device=x.device)
        out = x.new_zeros((self.T, *x.shape[1:]))
        out[:self.n_real] = buf[perm]
        return out

    def from_block(self, y: torch.Tensor) -> torch.Tensor:
        """The own tokens' rows of the block's outputs ``y`` (T, ...)."""
        idx = torch.tensor(self.back_idx, dtype=torch.long, device=y.device)
        out = y[idx]
        if self.back:
            out = alltoall.exchange_uneven(out, self.back_send,
                                           self.back_recv, self.group,
                                           self.axis)
        return out


def _holds(q_d, q_m, hd, hm):
    """Whether rank (q_d, q_m) holds each token whose holders' data and
    model indices are ``hd`` / ``hm`` (None: every rank of that axis)."""
    ok = True
    if hd is not None:
        ok = ok & (hd == q_d)
    if hm is not None:
        ok = ok & (hm == q_m)
    return ok


def plan_route(shape, rank: int, B: int, S: int, rows_split: bool,
               pos_split: bool) -> TokenRoute:
    """The :class:`TokenRoute` of rank ``rank`` on a mesh of ``shape`` (D,
    M) for a served (B, S) block layout: data rank d holds rows ``[d·b,
    (d+1)·b)`` (b = B/D) when ``rows_split``, else all; model rank m
    holds positions ``[m·L, (m+1)·L)`` (L = S/M) when ``pos_split``, else
    all.  Index arithmetic on the host, the same on every rank (no
    group attached)."""
    D, M = (int(v) for v in shape)
    W, N = D * M, B * S
    T = -(-N // W)
    f = np.arange(N)
    hd = (f // S) // (B // D) if rows_split and D > 1 else None
    hm = (f % S) // (S // M) if pos_split and M > 1 else None
    dest = f // T
    dest_holds = _holds(dest // M, dest % M, hd, hm)
    dest_holds = np.broadcast_to(dest_holds, f.shape)
    low = ((0 if hd is None else hd) * M + (0 if hm is None else hm))
    sender = np.where(dest_holds, dest, low)
    many = (hd is None and D > 1) or (hm is None and M > 1)
    within = D == 1 or (hd is not None and bool(np.all(hd == dest // M)))
    d, m = rank // M, rank % M
    n = M if within else W

    def gi(q):
        return q % M if within else q
    own = f[np.broadcast_to(_holds(d, m, hd, hm), f.shape)]
    sends = sender[own] == rank
    send_f = own[sends]
    blk = f[rank * T:min((rank + 1) * T, N)]
    order = np.lexsort((blk, gi(sender[blk])))
    members = [d * M + i for i in range(M)] if within else list(range(W))
    back_idx, back_send = [], []
    for q in members:
        held = np.nonzero(np.broadcast_to(
            _holds(q // M, q % M, None if hd is None else hd[blk],
                   None if hm is None else hm[blk]), blk.shape))[0]
        back_idx.extend(held.tolist())
        back_send.append(len(held))

    def counts(q):
        return tuple(np.bincount(gi(q), minlength=n).tolist())
    return TokenRoute(
        "model" if within else "world", n, gi(rank), T, len(blk),
        tuple(np.nonzero(sends)[0].tolist()), counts(dest[send_f]),
        counts(sender[blk]), tuple(np.argsort(order).tolist()),
        tuple(back_idx), tuple(back_send), counts(dest[own]),
        bool(np.any(sender != dest)), bool(np.any(~dest_holds)) or many)


def served_tokens(shape, rank: int, B: int, S: int, rows_split: bool,
                  pos_split: bool) -> Tuple[str, Any]:
    """How a served block's tokens meet the reference's MoE blocks (module
    docstring), on a mesh of ``shape`` (D, M): ``("own", None)`` — each
    rank's tokens are its block, no padding; ``("replicate", group)`` —
    every rank of ``group`` (``model``, ``data`` or ``world``) holds the
    group's blocks alike, unpadded within it
    (:func:`replicated_moe_apply`); else ``("route", TokenRoute)``."""
    D, M = (int(v) for v in shape)
    W = D * M
    rows_split = rows_split and D > 1
    pos_split = pos_split and M > 1
    dup = [a for a, whole in (("data", D > 1 and not rows_split),
                              ("model", M > 1 and not pos_split)) if whole]
    T = -(-B * S // W)
    if W == 1 or (not dup and B * S == W * T
                  and (not pos_split or B // D == 1)):
        return "own", None
    if len(dup) == 2 or (dup and W == (D if dup == ["data"] else M)):
        return "replicate", dup[0] if len(dup) == 1 else "world"
    if dup == ["model"] and (B // D) * S == M * T:
        return "replicate", "model"
    return "route", plan_route(shape, rank, B, S, rows_split, pos_split)


def routed_moe_apply(mesh, cfg: MoEConfig, params: Dict[str, torch.Tensor],
                     x: torch.Tensor, route: TokenRoute, *,
                     num_experts: int, act: str = "swiglu",
                     noise: Optional[torch.Tensor] = None,
                     token_ids: Optional[torch.Tensor] = None,
                     expert_tp_axis: Optional[str] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                Dict[str, torch.Tensor]]:
    """The MoE layer on a served block's own tokens ``x`` (..., d) through
    ``route`` (its process group attached): the tokens (and ``noise``,
    ``token_ids``, row for row) exchanged into the rank's reference
    block, :func:`sharded_moe_apply` on it, the outputs exchanged back to
    every rank that holds them.  For inference only."""
    lead, d = x.shape[:-1], x.shape[-1]
    xb = route.to_block(x.reshape(-1, d))
    nb = None if noise is None else route.to_block(noise)
    tb = (None if token_ids is None
          else route.to_block(token_ids.reshape(-1)))
    yb, aux, metrics = sharded_moe_apply(
        mesh, cfg, params, xb, num_experts=num_experts, act=act, noise=nb,
        token_ids=tb, valid=route.valid(x.device),
        expert_tp_axis=expert_tp_axis)
    return route.from_block(yb).reshape(*lead, d), aux, metrics


def moe_apply(cfg: MoEConfig, params: Dict[str, torch.Tensor],
              x: torch.Tensor, **kw
              ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """The MoE layer on one device: :func:`sharded_moe_apply` without a
    mesh (``x``'s flattened tokens all this device's)."""
    return sharded_moe_apply(None, cfg, params, x, **kw)
