"""Dry run: what every (arch × shape) pair stores, computes and moves a
rank at the production meshes — the port of ``repro/launch/dryrun.py``,
counted from the port's own plans instead of a compiled program.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Nothing is built or allocated and no device is used: every tree is
``meta`` tensors (``convert.param_shapes``, ``data/pipeline
.make_batch_specs``, ``models/transformer.init_cache``), and the mesh is
a shape (``launch/mesh.make_production_mesh``: 16x16, or 2x16x16 with
``--multi-pod``).  :func:`count_pair` gives one pair's record:

* **stored bytes a rank**, by the port's own layout
  (``launch/shard.make_layout``): for training the train state by
  ``needs_fsdp`` (f32 masters, AdamW's moments in
  ``optimizer_state_dtype``); for serving the served tree (the compute
  dtype, the f32 leaves f32) by ``fsdp=needs_fsdp(4e9)`` and
  ``expert_tp`` for the decode step, as the reference's dry run stores
  it; the batch by ``batch_shardings``; a decode step's caches by the
  served cache layout (``launch/shard.cache_layout_for``): the
  reference's ``cache_shardings``, every leaf;
* **model FLOPs** (:func:`model_flops`, the reference's) and model FLOPs
  over chips;
* **every bulk collective of one step**, from the port's plan (the
  exchanges of each ``moe`` layer at the capacity or grouped static
  bound in the payload dtype, the ZeRO-3 gathers and reduce-scatters,
  the gradient all-reduces, expert TP's gathers and reduce-scatters,
  context parallelism's row gathers; serving's context-parallel prefill
  — k and v gathered over the model group, the last position's hidden
  rows broadcast from its last rank — a decode step's collectives over
  ``model`` of each cache's cut: the gathers of the heads' outputs or
  of the partial softmax results, the channel cut's score sums and
  output gathers, each recurrent state's output sum or gather and
  Mamba's conv gather; the
  MoE outputs' all-gather over the group whose ranks hold the same
  tokens, and the sampled tokens' all-gather over ``data``): the
  same ``core/alltoall.Collective`` a rank logs when it runs the step
  (``tests/test_torch_serve_layout.py`` holds the two equal on gloo
  ranks), each with its count, its wire bytes a rank and whether its
  group crosses a node of :data:`NODE` GPUs (rank r = d·M + m, the pods
  outermost).  ``"auto"`` MoE knobs resolve through ``core/tuning`` at
  the step's tokens a rank, as the trainer and the server resolve them.

:func:`roofline` divides them by the H100 SXM datasheet's figures below
— datasheet constants, not measurements of a card.  The reference's XLA
``memory_analysis`` temporaries (the activation peak) and its
``hlo_analysis`` (executed FLOPs and bytes of the compiled program) have
no counterpart here: there is no compiled program to read.  The
roofline's memory term is the stored bytes a rank read once, a floor.

Records go to ``experiments/dryrun_torch/`` at the repository root
(ignored by git).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import configs
from repro_torch.convert import param_shapes
from repro_torch.core import capacity, gating, tuning
from repro_torch.core.alltoall import DTYPE_BYTES, Collective
from repro_torch.core.config import INPUT_SHAPES, ShapeConfig, TrainConfig
from repro_torch.core.moe import grouped_a2a_stages, served_tokens
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shard
from repro_torch.models import transformer as T

# ---------------------------------------------------------------------------
# hardware constants: the NVIDIA H100 SXM datasheet (dense, no sparsity)
# ---------------------------------------------------------------------------
PEAK_FLOPS = 989e12          # bf16 tensor-core FLOP/s a GPU
HBM_BW = 3.35e12             # HBM3 B/s a GPU
NVLINK_BW = 450e9            # NVLink 4 B/s a direction a GPU, inside a node
NIC_BW = 50e9                # one 400 Gb/s NIC a GPU, between nodes
NODE = 8                     # GPUs a node (an HGX H100 board)

# gemma2 runs long_500k as the documented capped-global-window variant
LONG_CONTEXT_VARIANT = {"gemma2-9b"}

# dry-run training defaults: block remat + f32 master/moments
DRYRUN_TCFG = TrainConfig(remat="block", microbatches=1)
# the giant MoE config needs bf16 moments to fit (the reference's choice)
DRYRUN_TCFG_GIANT = TrainConfig(remat="block", microbatches=1,
                                optimizer_state_dtype="bfloat16")
GIANT = {"llama4-maverick-400b-a17b"}

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def eligible(arch: str, shape_name: str) -> Optional[str]:
    """None if the pair runs; otherwise the skip reason (the
    reference's)."""
    cfg = configs.get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if shape.mode == "decode" and not cfg.has_decode:
        return "encoder-only: no decode step"
    if shape_name == "long_500k":
        if not cfg.has_decode:
            return "encoder-only: no decode step"
        if not (cfg.is_subquadratic or arch in LONG_CONTEXT_VARIANT):
            return "pure full-attention: 524k dense-KV decode not faked"
    return None


# ---------------------------------------------------------------------------
# model-FLOPs estimate (6·N·D with N = active params), the reference's
# ---------------------------------------------------------------------------

def active_params(cfg) -> float:
    """Parameter count, counting only top-k + shared experts of MoE layers."""
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    total = V * d * (1 if cfg.tie_embeddings else 2) if cfg.frontend is None \
        else V * d
    per = {"glu": 3 * d * f, "plain": 2 * d * f}
    mlp_p = per["glu"] if cfg.act in ("swiglu", "geglu") else per["plain"]
    attn_p = 0
    if cfg.attention is not None:
        hd = cfg.head_dim
        a = cfg.attention
        attn_p = d * hd * (a.num_heads * 2 + a.num_kv_heads * 2)
    for kind in cfg.block_pattern:
        n = cfg.num_layers // len(cfg.block_pattern)
        if kind in ("attn", "local", "global", "dense"):
            total += n * (attn_p + mlp_p)
        elif kind == "moe":
            fe = cfg.moe.d_ff_expert or f
            e_p = (3 if cfg.act in ("swiglu", "geglu") else 2) * d * fe
            k = gating.gate_k(cfg.moe)
            total += n * (attn_p + (k + cfg.moe.num_shared_experts) * e_p
                          + d * cfg.moe.num_experts)
        elif kind in ("mamba", "mamba_sa"):
            d_in = cfg.ssm.expand * d
            H = d_in // cfg.ssm.head_dim
            total += n * (d * (2 * d_in + 2 * cfg.ssm.n_groups
                               * cfg.ssm.d_state + H) + d_in * d)
            if kind == "mamba_sa":
                total += n * (d * 2 * 16)       # lora only; shared attn once
        elif kind == "rwkv":
            total += n * (5 * d * d + mlp_p)
    if "mamba_sa" in cfg.block_pattern:
        total += attn_p
    return float(total)


def attention_flops_fwd(cfg, shape: ShapeConfig) -> float:
    """Forward attention-matmul FLOPs (QKᵀ + PV): 4·tokens·S_ctx·H·hd.
    S_ctx: causal average S/2 for full attention, the window for SWA
    layers, the full cache length for decode."""
    if cfg.attention is None:
        return 0.0
    tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode"
                                   else 1)
    H, hd = cfg.attention.num_heads, cfg.head_dim
    total = 0.0
    per = cfg.num_layers // len(cfg.block_pattern)
    for kind in cfg.block_pattern:
        if kind in ("mamba", "rwkv"):
            continue
        win = cfg.local_window if kind == "local" else cfg.attention.window
        if shape.mode == "decode":
            ctx = min(shape.seq_len, win) if win else shape.seq_len
        else:
            ctx = min(shape.seq_len, win) if win else shape.seq_len / 2
        total += per * 4.0 * tokens * ctx * H * hd
    return total


def model_flops(cfg, shape: ShapeConfig) -> float:
    """Param term (6·N_active·D train / 2·N·D inference) + attention term
    (3×fwd for train — bwd counts double)."""
    tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode"
                                   else 1)
    mult = 6.0 if shape.mode == "train" else 2.0
    attn_mult = 3.0 if shape.mode == "train" else 1.0
    return (mult * active_params(cfg) * tokens
            + attn_mult * attention_flops_fwd(cfg, shape))


def _cfg_with_overrides(arch, *, a2a=None, dispatch=None, capacity=None):
    cfg = configs.get_config(arch)
    if cfg.moe is not None and (a2a or dispatch or capacity):
        kw = {}
        if a2a:
            kw["a2a"] = a2a
        if dispatch:
            kw["dispatch"] = dispatch
        if capacity:
            kw["capacity_factor"] = capacity
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))
    return cfg


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def cache_shapes(cfg, batch: int, cache_len: int, *,
                 long_context: bool = False) -> List[Dict[str, Any]]:
    """The port's per-layer decode caches as ``meta`` tensors."""
    dt = getattr(torch, cfg.dtype)
    return [T.init_cache(cfg, kind, batch, cache_len,
                         long_context=long_context, dtype=dt, device="meta")
            for kind in T.layer_kinds(cfg)]


def input_specs(arch: str, shape_name: str, mesh_shape: Dict[str, int], *,
                a2a: str = None, dispatch: str = None):
    """``(inputs, specs)`` of every model input of this pair: ``meta``
    tensors and their specs (``launch/mesh.fit_spec``'s form).  Train:
    the batch and ``batch_shardings``; prefill: the tokens (or a
    frontend's embeddings) with the batch dim over ``(pod, data)``;
    decode: ``(token, caches)`` and ``(its spec, cache_shardings)``."""
    cfg = _cfg_with_overrides(arch, a2a=a2a, dispatch=dispatch)
    shape = INPUT_SHAPES[shape_name]
    if shape.mode == "train":
        batch = make_batch_specs(cfg, shape, dtype=cfg.dtype)
        return batch, mesh_lib.batch_shardings(mesh_shape, batch)
    B = shape.global_batch
    dp = mesh_lib.dp_axes(mesh_shape)
    dt = getattr(torch, cfg.dtype)

    def tok(shp, d):
        return _meta(shp, d), mesh_lib.fit_spec(mesh_shape, (dp,), shp)

    if shape.mode == "prefill":
        if cfg.frontend is not None:
            return tok((B, shape.seq_len, cfg.d_model), dt)
        return tok((B, shape.seq_len), torch.int32)
    t, t_spec = (tok((B, 1, cfg.d_model), dt) if cfg.frontend is not None
                 else tok((B, 1), torch.int32))
    caches = cache_shapes(cfg, B, shape.seq_len,
                          long_context=shape_name == "long_500k")
    return (t, caches), (t_spec, mesh_lib.cache_shardings(mesh_shape,
                                                          caches))


# ---------------------------------------------------------------------------
# stored bytes
# ---------------------------------------------------------------------------

def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_bytes(mesh_shape: Dict[str, int], spec, shape, dtype) -> int:
    """Bytes a rank holds of a tensor of ``shape`` stored by ``spec``."""
    n = math.prod(shape)
    for entry in spec:
        n //= math.prod(mesh_shape[a] for a in _axes(entry))
    return n * DTYPE_BYTES[str(dtype).removeprefix("torch.")]


def _tree_bytes(mesh_shape, specs, leaves) -> int:
    return sum(spec_bytes(mesh_shape, spec, leaf.shape, leaf.dtype)
               for (_, spec), (_, leaf) in zip(
                   mesh_lib.spec_paths(specs), mesh_lib.tree_paths(leaves),
                   strict=True))


def served_dtype(cfg, path: str):
    """The dtype a served leaf is stored in (``transformer._leaf``)."""
    name = path.split("/")[-1]
    return (torch.float32 if name in T._F32_LEAVES
            else getattr(torch, cfg.dtype))


def layout_bytes(layout: shard.Layout, shapes, dtype_of) -> int:
    """Bytes a rank stores of the tree ``shapes`` by ``layout``, each leaf
    in ``dtype_of(path)``."""
    return sum(spec_bytes(layout.mesh_shape, layout.specs[p], leaf.shape,
                          dtype_of(p))
               for p, leaf in mesh_lib.tree_paths(shapes))


# ---------------------------------------------------------------------------
# the plan of a step's collectives
# ---------------------------------------------------------------------------

class Plan:
    """The collectives of one step, in order, each with the axes its group
    spans (for the node test)."""

    def __init__(self, mesh_shape: Dict[str, int]):
        self.mesh_shape = mesh_shape
        self.ops: List[Tuple[Collective, Tuple[str, ...]]] = []

    def add(self, kind: str, axes: Tuple[str, ...], dtype, shape,
            label: Optional[str] = None, n: Optional[int] = None) -> None:
        if n is None:
            n = math.prod(self.mesh_shape[a] for a in axes)
        if label is None:
            label = axes[0] if len(axes) == 1 else "world"
        self.ops.append((Collective(kind, label, int(n),
                                    str(dtype).removeprefix("torch."),
                                    tuple(int(s) for s in shape)), axes))

    def extend(self, other: "Plan", times: int = 1) -> None:
        self.ops.extend(other.ops * times)

    def log(self) -> collections.Counter:
        """The multiset of logged collectives (``alltoall.collectives``'
        form)."""
        return collections.Counter(c for c, _ in self.ops)


def _member_offsets(axes: Tuple[str, ...], label: str, n: int,
                    mesh_shape: Dict[str, int], inner: int) -> List[int]:
    """The ranks of rank 0's group (rank r = ((p·D) + d)·M + m)."""
    M = mesh_shape.get("model", 1)
    D = mesh_shape.get("data", 1)
    if label == "inner":
        return list(range(inner))
    if label == "outer":
        return [o * inner for o in range(M // inner)]
    if label == "row":
        return list(range(n))
    stride = {"model": 1, "data": M, "pod": M * D}
    ranks = [0]
    for a in axes:
        ranks = [r + i * stride[a] for r in ranks
                 for i in range(mesh_shape[a])]
    return ranks


def _route(cfg_moe, mesh_shape) -> List[Tuple[str, int]]:
    """The stages ``(label, group size)`` one payload exchange issues."""
    M = mesh_shape["model"]
    if grouped_a2a_stages(cfg_moe, M) == 2:
        i = cfg_moe.a2a_inner
        return [("inner", i), ("outer", M // i)]
    return [("model", M)]


def _exchange(plan: Plan, cfg_moe, dtype, shape) -> None:
    """One payload exchange (M, c, ...) over the model axis, flat or two
    stages (``alltoall._run``: stage A (inner, outer, ...), stage B
    (outer, inner, ...)); its inverse issues the same two."""
    M, c = shape[0], tuple(shape[1:])
    stages = _route(cfg_moe, plan.mesh_shape)
    if len(stages) == 1:
        plan.add("all_to_all", ("model",), dtype, shape)
        return
    (_, i), (_, o) = stages
    plan.add("all_to_all", ("model",), dtype, (i, o) + c, "inner", i)
    plan.add("all_to_all", ("model",), dtype, (o, i) + c, "outer", o)


def moe_plan(cfg_moe, T_: int, d: int, dtype, mesh_shape, *, tp: bool,
             backward: bool) -> Tuple[Plan, Plan]:
    """(forward, backward) collectives of one ``moe`` layer on a rank of
    ``T_`` tokens, ``cfg_moe`` resolved (``core/moe.moe_block_local``)."""
    fwd, bwd = Plan(mesh_shape), Plan(mesh_shape)
    M = mesh_shape["model"]
    D = mesh_shape["data"]
    E = cfg_moe.num_experts
    E_local = E // M
    i32 = torch.int32
    if cfg_moe.dispatch != "grouped":
        C = capacity.expert_capacity(cfg_moe, T_, E)
        buf = (M, E_local * C, d)
        if M > 1:
            _exchange(fwd, cfg_moe, dtype, buf)
        if tp:
            fwd.add("all_gather", ("data",), dtype, (E_local, M * C, d))
            fwd.add("reduce_scatter", ("data",), dtype,
                    (E_local, D * M * C, d))
        if M > 1:
            _exchange(fwd, cfg_moe, dtype, buf)
        if backward:
            if M > 1:
                _exchange(bwd, cfg_moe, dtype, buf)
            if tp:
                bwd.add("all_gather", ("data",), dtype, (E_local, M * C, d))
                bwd.add("reduce_scatter", ("data",), dtype,
                        (E_local, D * M * C, d))
            if M > 1:
                _exchange(bwd, cfg_moe, dtype, buf)
        return fwd, bwd
    if M == 1 and cfg_moe.overlap_chunks == 1 and not tp:
        return fwd, bwd
    if M > 1:
        B = capacity.grouped_segment_bound(cfg_moe, T_, M)
        n_src, n_cnt = M, E_local
    else:
        B = capacity.grouped_tp_gather_bound(cfg_moe, T_)
        n_src, n_cnt = 1, E
    P = cfg_moe.overlap_chunks
    Bc = capacity.grouped_overlap_chunk_bound(cfg_moe, B) if P > 1 else B
    qdt = cfg_moe.payload_dtype if M > 1 else None
    win = (n_src, Bc, d)
    for _ in range(P):
        if M > 1:                                      # dispatch
            if qdt is None:
                fwd.add("all_to_all", ("model",), i32, (M, E_local))
                _exchange(fwd, cfg_moe, dtype, win)
            else:
                fwd.add("all_to_all", ("model",), i32, (M, E_local + 1))
                _exchange(fwd, cfg_moe, qdt, win)
        if tp:
            fwd.add("all_gather", ("data",), dtype, win)
            fwd.add("all_gather", ("data",), i32, (n_src, n_cnt))
            fwd.add("reduce_scatter", ("data",), dtype,
                    (D * n_src * Bc, d))
        if M > 1:                                      # combine
            if qdt is None:
                _exchange(fwd, cfg_moe, dtype, win)
            else:
                fwd.add("all_to_all", ("model",), torch.float32, (M,))
                _exchange(fwd, cfg_moe, qdt, win)
        if not backward:
            continue
        if M > 1:                                      # combine's inverse
            if qdt is None:
                _exchange(bwd, cfg_moe, dtype, win)
            else:
                _exchange(bwd, cfg_moe, qdt, win)
                bwd.add("all_to_all", ("model",), torch.float32, (M,))
        if tp:
            bwd.add("all_gather", ("data",), dtype, (n_src * Bc, d))
            bwd.add("reduce_scatter", ("data",), dtype, (D * n_src, Bc, d))
        if M > 1:                                      # dispatch's inverse
            _exchange(bwd, cfg_moe, qdt or dtype, win)
            if qdt is not None:
                bwd.add("all_to_all", ("model",), torch.float32, (M,))
    return fwd, bwd


def gather_plan(layout: shard.Layout, shapes, prefix: str, dtype, stored,
                *, experts: bool = True) -> Tuple[Plan, Plan]:
    """(forward, backward) of ``Layout.whole`` over the leaves under
    ``prefix``: each leaf's all-gathers (model, then data; in the compute
    ``dtype`` unless an f32 leaf, ``stored(path)`` otherwise) and their
    reduce-scatters in reverse (the first in the gathered dtype, the
    next in the stored one)."""
    fwd, bwd = Plan(layout.mesh_shape), Plan(layout.mesh_shape)
    sub = shapes
    for part in prefix.split("/"):
        sub = sub[int(part)] if isinstance(sub, list) else sub[part]
    for path, leaf in mesh_lib.tree_paths(sub, prefix):
        axes = layout.gather_axes(path)
        if not axes or (not experts and shard.is_expert(path)):
            continue
        st = stored(path)
        gdt = (st if dtype is None or path.split("/")[-1] in T._F32_LEAVES
               else dtype)
        cur = list(layout.block_shape(path, leaf.shape))
        steps = []
        for a, dim in axes:
            fwd.add("all_gather", (a,), gdt, cur)
            steps.append((a, dim, tuple(cur)))
            cur[dim] *= layout.mesh_shape[a]
        g = gdt
        for a, dim, before in reversed(steps):
            whole = list(before)
            whole[dim] *= layout.mesh_shape[a]
            bwd.add("reduce_scatter", (a,), g, whole)
            g = st
    return fwd, bwd


def _row_plan(cfg, kind: str, blk: mesh_lib.TokenBlock, dtype,
              mesh_shape) -> Tuple[Plan, Plan]:
    """A block's row-group gather over a split row (context parallelism):
    attention's stacked k, v (2, B, S/n, KV, hd) or a recurrent block's
    input (B, S/n, d)."""
    fwd, bwd = Plan(mesh_shape), Plan(mesh_shape)
    if blk.n == 1:
        return fwd, bwd
    b, L = blk.rows.stop - blk.rows.start, blk.seq.stop - blk.seq.start
    if kind in ("rwkv", "mamba", "mamba_sa"):
        chunk, dim = [b, L, cfg.d_model], 1
    else:
        chunk = [2, b, L, cfg.attention.num_kv_heads, cfg.head_dim]
        dim = 2
    fwd.add("all_gather", ("row",), dtype, chunk, "row", blk.n)
    whole = list(chunk)
    whole[dim] *= blk.n
    bwd.add("reduce_scatter", ("row",), dtype, whole, "row", blk.n)
    return fwd, bwd


def _resolved_moe(cfg, M: int, tokens: int):
    return tuning.resolve_moe_config(cfg.moe, model_size=M,
                                     tokens_per_shard=tokens,
                                     d_model=cfg.d_model,
                                     dtype=getattr(torch, cfg.dtype))


def train_plan(cfg, tcfg: TrainConfig, layout: shard.Layout, shapes,
               B: int, S: int) -> Plan:
    """The collectives of one train step on a rank (``training/train_step``
    over ``layout``): per microbatch the embedding's and the head's
    gathers, every block's gathers, MoE exchanges and row gathers —
    twice forward when the block recomputes (remat or FSDP) — and their
    backward, then the gradient all-reduces."""
    ms = layout.mesh_shape
    world = layout.world
    mbs = tcfg.microbatches
    Bm = B // mbs
    blk = mesh_lib.cut_tokens((ms["data"], ms["model"]) if "pod" not in ms
                              else (ms["pod"] * ms["data"], ms["model"]),
                              0, Bm, S)
    tokens = Bm * S // world
    dt = getattr(torch, cfg.dtype)

    def f32(_):
        return torch.float32
    gathered = layout.gathered
    step = Plan(ms)
    micro = Plan(ms)
    if gathered:
        if cfg.frontend is None:
            f, b = gather_plan(layout, shapes, "embed", dt, f32)
            micro.extend(f)
            micro.extend(b)
    recompute = gathered or tcfg.remat != "none"
    moe_cfg = (None if cfg.moe is None
               else _resolved_moe(cfg, ms["model"], tokens))
    shared = "shared_attn" in shapes
    for i, kind in enumerate(T.layer_kinds(cfg)):
        fwd, bwd = Plan(ms), Plan(ms)
        if gathered:
            f, b = gather_plan(layout, shapes, f"blocks/{i}", dt, f32)
            fwd.extend(f)
            bwd.extend(b)
            if shared:
                f, b = gather_plan(layout, shapes, "shared_attn", dt, f32)
                fwd.extend(f)
                if kind == "mamba_sa":
                    bwd.extend(b)
        f, b = _row_plan(cfg, kind, blk, dt, ms)
        fwd.extend(f)
        bwd.extend(b)
        if kind == "moe":
            f, b = moe_plan(moe_cfg, tokens, cfg.d_model, dt, ms, tp=False,
                            backward=True)
            fwd.extend(f)
            bwd.extend(b)
        micro.extend(fwd, 2 if recompute else 1)
        micro.extend(bwd)
    if gathered:
        head = "lm_head" if T.untied_head(cfg) else "embed"
        f, b = gather_plan(layout, shapes, head, dt, f32)
        micro.extend(f)
        micro.extend(b)
    step.extend(micro, mbs)
    buckets: Dict[Tuple[str, ...], int] = collections.defaultdict(int)
    for path, leaf in mesh_lib.tree_paths(shapes):
        axes = layout.reduce_axes(path)
        if axes:
            buckets[axes] += math.prod(layout.block_shape(path, leaf.shape))
    for axes in sorted(buckets):
        step.add("all_reduce", axes, torch.float32, (buckets[axes],))
    return step


def _route_plan(plan: Plan, cfg, route, axes, dtype) -> None:
    """A ``moe.TokenRoute``'s exchanges in a served ``moe`` block: the
    tokens (and a noisy gate's draws) into the reference's block, the
    outputs back."""
    if route.dispatch:
        sent = (len(route.send_idx), cfg.d_model)
        plan.add("all_to_all", axes, dtype, sent, route.axis, route.n)
        if T.noisy(cfg):
            plan.add("all_to_all", axes, torch.float32,
                     (sent[0], cfg.moe.num_experts), route.axis, route.n)
    if route.back:
        plan.add("all_to_all", axes, dtype,
                 (len(route.back_idx), cfg.d_model), route.axis, route.n)


def _state_plan(plan: Plan, cfg, kind: str, dims, b: int, dt) -> None:
    """A decode step's collectives over ``model`` of a recurrent layer whose
    state leaves are cut in ``dims`` (``CacheLayout.dims``): RWKV's
    output summed (key dim) or gathered (heads, value dim); Mamba's conv
    output gathered on its channels, or its carry on its positions, and
    its y gathered (heads, head dim) or summed (state dim)."""
    M = plan.mesh_shape["model"]
    f32 = torch.float32
    dims = dict(dims)

    def out(shape, dim):
        """The rank's f32 output, summed over a cut contracted dim (None)
        or gathered on its block of ``dim``."""
        if dim is None:
            plan.add("all_reduce", ("model",), f32, shape)
        else:
            plan.add("all_gather", ("model",), f32, tuple(
                n // M if i == dim else n for i, n in enumerate(shape)))
    if kind == "rwkv":
        H, hd = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
        if "s" in dims:
            out((b, H, hd), {1: 1, 2: None, 3: 2}[dims["s"]])
        return
    d_in = cfg.ssm.expand * cfg.d_model
    C = d_in + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
    K = cfg.ssm.conv_width
    if dims.get("conv") == 2:
        plan.add("all_gather", ("model",), dt, (b, 1, C // M))
    elif dims.get("conv") == 1:
        plan.add("all_gather", ("model",), f32, (b, (K - 1) // M, C))
    if "s" in dims:
        out((b, d_in // cfg.ssm.head_dim, cfg.ssm.head_dim),
            {1: 1, 2: 2, 3: None}[dims["s"]])


def _cache_plan(plan: Plan, cfg, caches, i: int, b: int, dt) -> None:
    """Layer ``i``'s decode collectives over ``model`` by its caches' cut
    (``caches``, a ``launch/shard.CacheLayout``): its state leaves'
    (:func:`_state_plan`), then its attention cache's — the heads'
    outputs gathered (``heads``), the partial softmax results gathered
    (``positions``), or the partial scores summed and the outputs'
    channel blocks gathered (``channels``)."""
    M = plan.mesh_shape["model"]
    kind = T.layer_kinds(cfg)[i]
    if kind in ("rwkv", "mamba", "mamba_sa"):
        _state_plan(plan, cfg, kind, caches.dims[i], b, dt)
    form = caches.forms[i]
    if form in (None, "whole"):
        return
    H, hd = cfg.attention.num_heads, cfg.head_dim
    if form == "heads":
        plan.add("all_gather", ("model",), dt, (b, 1, H // M, hd))
    elif form == "positions":
        plan.add("all_gather", ("model",), torch.float32, (b, H, hd + 2))
    elif form == "channels":
        c = caches.shapes[i]
        k = (c["sa"] if "sa" in c else c)["k"]
        KV, L = k.shape[2], k.shape[1]
        plan.add("all_reduce", ("model",), torch.float32,
                 (b, KV, H // KV, 1, L))
        plan.add("all_gather", ("model",), dt, (b, 1, H, hd // M))


def serve_plan(cfg, layout: Optional[shard.Layout], shapes, B: int, S: int,
               *, decode: bool, long_context: bool = False,
               rank: int = 0) -> Plan:
    """The collectives of a served prefill of (B, S) tokens, or of one
    decode step of B rows over caches of S positions
    (``Transformer.forward`` / ``decode_step`` over ``layout``), each
    with its greedy token's all-gather over ``data``: the embedding's
    and the head's gathers and each block's (the decode step keeping the
    experts' stored f-slice under expert TP); in a prefill whose
    positions split over ``model`` (``launch/mesh.serve_block``) each
    block's row gather and the last hidden rows' broadcast; in a decode
    step each cache's collectives over ``model`` by its cut
    (``launch/shard.cache_layout_for``, :func:`_cache_plan`); each ``moe``
    layer's exchanges, and the all-gather of its outputs over the group
    whose ranks hold its tokens alike, or its token route's exchanges
    (``moe.served_tokens``; the route's sizes are ``rank``'s)."""
    ms = layout.mesh_shape
    dt = getattr(torch, cfg.dtype)
    dp = mesh_lib.dp_axes(ms)
    D = math.prod(ms[a] for a in dp)
    M = ms.get("model", 1)

    def stored(path):
        return served_dtype(cfg, path)
    plan = Plan(ms)
    gathered = layout.gathered
    tp = decode and layout.expert_tp
    split_rows = mesh_lib.fit_spec(ms, (dp,), (B,))[0] is not None
    b = B // D if split_rows else B
    split = not decode and M > 1 and S > 1 and S % M == 0
    s_loc = 1 if decode else (S // M if split else S)
    mode, how = served_tokens((D, M), rank, B, s_loc * (M if split else 1),
                              split_rows, split)
    all_axes = tuple(ms)
    group_axes = {"model": ("model",), "data": dp, "world": all_axes}
    if mode == "own":
        tokens = b * s_loc
    elif mode == "replicate":
        rep_axes = group_axes[how]
        tokens = -(-(b * s_loc) // math.prod(ms[a] for a in rep_axes))
    else:
        tokens = how.T
    blk = mesh_lib.TokenBlock(slice(0, b), slice(0, s_loc), M if split
                              else 1, S)
    caches = (shard.cache_layout_for(cfg, ms, B, S, long_context,
                                     rank=rank) if decode else None)
    if gathered and cfg.frontend is None:
        plan.extend(gather_plan(layout, shapes, "embed", dt, stored)[0])
    moe_cfg = (None if cfg.moe is None
               else _resolved_moe(cfg, M, tokens))
    for i, kind in enumerate(T.layer_kinds(cfg)):
        if gathered:
            plan.extend(gather_plan(layout, shapes, f"blocks/{i}", dt,
                                    stored, experts=not tp)[0])
            if "shared_attn" in shapes:
                plan.extend(gather_plan(layout, shapes, "shared_attn", dt,
                                        stored)[0])
        plan.extend(_row_plan(cfg, kind, blk, dt, ms)[0])
        if caches is not None and M > 1:
            _cache_plan(plan, cfg, caches, i, b, dt)
        if kind == "moe":
            plan.extend(moe_plan(moe_cfg, tokens, cfg.d_model, dt, ms,
                                 tp=tp and ms["data"] > 1,
                                 backward=False)[0])
            if mode == "replicate":
                plan.add("all_gather", rep_axes, dt, (tokens, cfg.d_model),
                         how)
            elif mode == "route":
                _route_plan(plan, cfg, how, group_axes[how.axis], dt)
    if split and cfg.has_decode:
        plan.add("broadcast", ("model",), dt, (b, 1, cfg.d_model))
    if gathered:
        head = "lm_head" if T.untied_head(cfg) else "embed"
        plan.extend(gather_plan(layout, shapes, head, dt, stored)[0])
    if D > 1 and split_rows and cfg.has_decode:
        plan.add("all_gather", dp, torch.int64, (b, 1), "data")
    return plan


def collectives_record(plan: Plan, inner: int = 1) -> Dict[str, Any]:
    """The plan's ops aggregated: kind, axis, group size, dtype, shape,
    count, wire bytes a rank (all counts), whether the group crosses a
    node; and the totals."""
    counts = collections.Counter()
    axes_of = {}
    for c, axes in plan.ops:
        counts[c] += 1
        axes_of[c] = axes
    ops = []
    for c, n in counts.items():
        ranks = _member_offsets(axes_of[c], c.axis, c.n, plan.mesh_shape,
                                inner)
        ops.append({"kind": c.kind, "axis": c.axis, "group": c.n,
                    "dtype": c.dtype, "shape": list(c.shape), "count": n,
                    "wire_bytes": n * c.wire_bytes,
                    "crosses_node": len({r // NODE for r in ranks}) > 1})
    total = sum(o["wire_bytes"] for o in ops)
    inter = sum(o["wire_bytes"] for o in ops if o["crosses_node"])
    by_kind: Dict[str, float] = collections.defaultdict(float)
    for o in ops:
        by_kind[o["kind"]] += o["wire_bytes"]
    return {"ops": ops, "count": sum(counts.values()),
            "bytes_by_kind": dict(by_kind), "total_wire_bytes": total,
            "internode_wire_bytes": inter}


# ---------------------------------------------------------------------------
# one pair
# ---------------------------------------------------------------------------

def count_pair(cfg, shape: ShapeConfig, mesh_shape: Dict[str, int], *,
               fsdp: Optional[bool] = None,
               expert_tp: Optional[bool] = None,
               tcfg: Optional[TrainConfig] = None,
               long_context: bool = False, rank: int = 0) -> Dict[str, Any]:
    """The record of ``cfg`` at ``shape`` on a mesh of ``mesh_shape``
    (module docstring), from meta tensors only.  ``fsdp`` None asks
    ``needs_fsdp`` (a train state's budget, or serving's 4e9);
    ``expert_tp`` None is the reference's rule (a decode step of a MoE
    config, ``REPRO_EXPERT_TP``); ``tcfg`` the train config (default
    :data:`DRYRUN_TCFG`); ``rank`` the rank counted (0: every rank's
    stored bytes are the same; a served step's token route moves a
    rank's own counts)."""
    shapes = param_shapes(cfg)
    B, S = shape.global_batch, shape.seq_len
    chips = math.prod(mesh_shape.values())
    rec: Dict[str, Any] = {"mesh_shape": dict(mesh_shape), "chips": chips}
    stored: Dict[str, int] = {}
    if shape.mode == "train":
        tcfg = tcfg or DRYRUN_TCFG
        if fsdp is None:
            fsdp = mesh_lib.needs_fsdp(mesh_shape, shapes)
        layout = shard.make_layout(shapes, mesh_shape, 0, fsdp=fsdp)
        stored["params"] = layout_bytes(layout, shapes,
                                        lambda p: torch.float32)
        stored["opt"] = 2 * layout_bytes(
            layout, shapes, lambda p: getattr(
                torch, tcfg.optimizer_state_dtype))
        batch = make_batch_specs(cfg, shape, dtype=cfg.dtype)
        stored["batch"] = _tree_bytes(
            mesh_shape, mesh_lib.batch_shardings(mesh_shape, batch), batch)
        plan = train_plan(cfg, tcfg, layout, shapes, B, S)
        rec.update(fsdp=fsdp, expert_tp=False, remat=tcfg.remat,
                   microbatches=tcfg.microbatches,
                   optimizer_state_dtype=tcfg.optimizer_state_dtype)
    else:
        decode = shape.mode == "decode"
        if fsdp is None:
            fsdp = mesh_lib.needs_fsdp(mesh_shape, shapes,
                                       budget_bytes=shard.SERVE_FSDP_BUDGET)
        if expert_tp is None:
            expert_tp = (decode and cfg.moe is not None
                         and T.use_expert_tp())
        layout = shard.make_layout(shapes, mesh_shape, 0, fsdp=fsdp,
                                   expert_tp=expert_tp)
        stored["params"] = layout_bytes(layout, shapes,
                                        lambda p: served_dtype(cfg, p))
        dt = getattr(torch, cfg.dtype)
        tok_shape = ((B, 1 if decode else S) if cfg.frontend is None
                     else (B, 1 if decode else S, cfg.d_model))
        tok = _meta(tok_shape, dt if cfg.frontend is not None
                    else torch.int32)
        stored["batch"] = spec_bytes(
            mesh_shape, mesh_lib.fit_spec(
                mesh_shape, (mesh_lib.dp_axes(mesh_shape),), tok.shape),
            tok.shape, tok.dtype)
        if cfg.has_decode:
            stored["caches"] = shard.cache_layout_for(
                cfg, mesh_shape, B, S, long_context, rank=rank).bytes
        plan = serve_plan(cfg, layout, shapes, B, S, decode=decode,
                          long_context=long_context, rank=rank)
        rec.update(fsdp=fsdp, expert_tp=expert_tp)
    stored["total"] = sum(stored.values())
    rec["stored_bytes"] = stored
    mf = model_flops(cfg, shape)
    rec["model_flops"] = mf
    rec["model_flops_per_chip"] = mf / chips
    inner = (cfg.moe.a2a_inner if cfg.moe is not None
             and isinstance(cfg.moe.a2a_inner, int) else 1)
    rec["collectives"] = collectives_record(plan, inner)
    rec["plan"] = plan
    return rec


def roofline(record: Dict[str, Any]) -> Dict[str, Any]:
    """The three terms in seconds from the datasheet constants: model
    FLOPs a chip over :data:`PEAK_FLOPS`, the stored bytes a rank read
    once over :data:`HBM_BW` (a floor: no activations), the wire bytes a
    rank over :data:`NVLINK_BW` inside a node and :data:`NIC_BW`
    across."""
    coll = record["collectives"]
    intra = coll["total_wire_bytes"] - coll["internode_wire_bytes"]
    terms = {"compute_s": record["model_flops_per_chip"] / PEAK_FLOPS,
             "memory_s": record["stored_bytes"]["total"] / HBM_BW,
             "collective_s": intra / NVLINK_BW
             + coll["internode_wire_bytes"] / NIC_BW}
    return {**terms, "dominant": max(terms, key=terms.get),
            "step_time_bound_s": max(terms.values()),
            "constants": "H100 SXM datasheet (not measured)"}


def run_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
             a2a=None, dispatch=None, tag: str = "", save: bool = True,
             tcfg: TrainConfig = None) -> Dict[str, Any]:
    """The record of one (arch, shape) at the production mesh, or its skip
    reason; saved under :data:`OUT_DIR` with ``save``."""
    reason = eligible(arch, shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "a2a": a2a,
                           "dispatch": dispatch}
    if reason is not None:
        rec["skipped"] = reason
        if save:
            _save(rec, tag)
        return rec
    cfg = _cfg_with_overrides(arch, a2a=a2a, dispatch=dispatch)
    shape = INPUT_SHAPES[shape_name]
    if shape.mode == "train" and tcfg is None:
        tcfg = DRYRUN_TCFG_GIANT if arch in GIANT else DRYRUN_TCFG
    t0 = time.perf_counter()
    out = count_pair(cfg, shape, mesh_lib.make_production_mesh(
        multi_pod=multi_pod), tcfg=tcfg,
        long_context=shape_name == "long_500k")
    out.pop("plan")
    rec.update(out)
    rec["roofline"] = roofline(rec)
    rec["count_s"] = time.perf_counter() - t0
    if save:
        _save(rec, tag)
    return rec


def _save(rec, tag=""):
    os.makedirs(OUT_DIR, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
    if rec.get("a2a"):
        name += f"__a2a-{rec['a2a']}"
    if rec.get("dispatch"):
        name += f"__disp-{rec['dispatch']}"
    if tag:
        name += f"__{tag}"
    with open(os.path.join(OUT_DIR, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1, default=float)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--a2a", default=None,
                    choices=[None, "flat", "hierarchical"])
    ap.add_argument("--dispatch", default=None,
                    choices=[None, "sort", "dense"])
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    if args.all:
        pairs = [(a, s) for a in configs.ASSIGNED for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        pairs = [(args.arch, args.shape)]
    for a, s in pairs:
        rec = run_pair(a, s, multi_pod=args.multi_pod, a2a=args.a2a,
                       dispatch=args.dispatch, tag=args.tag)
        if "skipped" in rec:
            print(f"{a:28s} {s:12s} SKIP: {rec['skipped']}")
            continue
        r, c = rec["roofline"], rec["collectives"]
        print(f"{a:28s} {s:12s} {rec['mesh']:8s} "
              f"compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
              f"coll={r['collective_s']:.3e}s dom={r['dominant']:12s} "
              f"stored/rank={rec['stored_bytes']['total'] / 2 ** 30:.2f}GiB "
              f"wire/rank={c['total_wire_bytes'] / 2 ** 30:.2f}GiB "
              f"fsdp={rec['fsdp']} ({rec['count_s']:.2f}s)")


if __name__ == "__main__":
    main()
