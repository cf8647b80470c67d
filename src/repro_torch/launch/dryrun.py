"""Dry run: what every (arch × shape) pair stores, computes and moves a
rank at the production meshes — the port of ``repro/launch/dryrun.py``,
counted from the port's own plans and from one rank's step run on fake
tensors.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Nothing is allocated and no device is used.  :func:`count_pair` counts
from ``meta`` trees (``convert.param_shapes``, ``data/pipeline
.make_batch_specs``, ``models/transformer.init_cache``) and the mesh's
shape (``launch/mesh.make_production_mesh``: 16x16, or 2x16x16 with
``--multi-pod``):

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
  same ``core/alltoall.Collective`` a rank logs when it runs the step,
  each with its count, its wire bytes a rank and whether its
  group crosses a node of :data:`NODE` GPUs (rank r = d·M + m, the pods
  outermost).  ``"auto"`` MoE knobs resolve through ``core/tuning`` at
  the step's tokens a rank, as the trainer and the server resolve them.

:func:`execute_pair` runs the step itself — the trainer's
``make_train_step`` on the rank's sharded state, or the server's eager
``build_prefill`` / ``build_decode(graph=False)`` on the served layout
and caches, each with ``generate``'s sampled tokens — for one rank of
the mesh, on fake tensors (``torch._subclasses.FakeTensorMode``: shapes
and dtypes, no data; the kernel wrappers take their fake route,
``kernels/build.is_fake``) over a fake process group of the mesh's
world (``torch.testing``'s ``FakeStore`` and ``"fake"`` backend, one
process), recorded by ``analysis/graph.trace_graph``.  From that run
``launch/op_analysis.py`` gives the reference's ``memory_analysis``
(the live bytes' high-water mark) and ``hlo_analysis`` (here
``op_analysis``: executed FLOPs, HBM bytes per launched op, the largest
units, the launches and the collectives, which must equal the plan's:
an independent check of both).  :func:`run_pair` records both, and
:func:`roofline` divides executed FLOPs and bytes a rank by the H100 SXM
datasheet's figures below (datasheet constants, not measurements of a
card), the wire bytes by NVLink's and the NIC's, and gives the useful
fraction (model FLOPs over executed FLOPs).  The port's run-time mesh
has no ``pod`` axis (``launch/mesh.Mesh`` is ``(data, model)``), so a
``--multi-pod`` record holds the plan's counts and says why it was not
executed (:data:`POD_REASON`); its roofline is the plan's (model FLOPs,
stored bytes).

Records go to ``experiments/dryrun_torch/`` at the repository root
(ignored by git).
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch import tree as tree_lib
from repro_torch.analysis.graph import trace_graph
from repro_torch.convert import param_shapes
from repro_torch.core import alltoall, capacity, gating, tuning
from repro_torch.core.alltoall import DTYPE_BYTES, Collective
from repro_torch.core.config import INPUT_SHAPES, ShapeConfig, TrainConfig
from repro_torch.core.moe import grouped_a2a_stages, served_tokens
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import op_analysis, shard
from repro_torch.models import transformer as T

# ---------------------------------------------------------------------------
# hardware constants: the NVIDIA H100 SXM datasheet (dense, no sparsity)
# ---------------------------------------------------------------------------
PEAK_FLOPS = ops.BF16_FLOPS  # bf16 tensor-core FLOP/s a GPU
HBM_BW = ops.HBM_BW          # HBM3 B/s a GPU
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

def _choices(cfg, shape: ShapeConfig, mesh_shape: Dict[str, int],
             fsdp: Optional[bool], expert_tp: Optional[bool]
             ) -> Tuple[bool, bool]:
    """``(fsdp, expert_tp)`` of a pair, each as given or by the
    reference's rule: ``needs_fsdp`` at a train state's budget or at
    serving's; expert TP for a MoE config's decode step
    (``REPRO_EXPERT_TP``), never in training."""
    if shape.mode == "train":
        if fsdp is None:
            fsdp = mesh_lib.needs_fsdp(mesh_shape, param_shapes(cfg))
        return fsdp, False
    if fsdp is None:
        fsdp = mesh_lib.needs_fsdp(mesh_shape, param_shapes(cfg),
                                   budget_bytes=shard.SERVE_FSDP_BUDGET)
    if expert_tp is None:
        expert_tp = (shape.mode == "decode" and cfg.moe is not None
                     and T.use_expert_tp())
    return fsdp, expert_tp


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
    fsdp, expert_tp = _choices(cfg, shape, mesh_shape, fsdp, expert_tp)
    if shape.mode == "train":
        tcfg = tcfg or DRYRUN_TCFG
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


# ---------------------------------------------------------------------------
# one rank's step, executed on fake tensors
# ---------------------------------------------------------------------------

POD_REASON = ("the port's run-time mesh has no pod axis (launch/mesh.Mesh "
              "is (data, model)): the plan is counted, the step not run")


@contextlib.contextmanager
def fake_world(world: int, rank: int):
    """A fake default process group of ``world`` ranks as ``rank`` (no
    group for one rank): ``torch.testing``'s ``FakeStore`` and ``"fake"``
    backend, whose collectives return at once.  Refuses a process that
    has a group already, and destroys the fake one on the way out and
    puts back the ``sys.excepthook`` its init wrapped, so the process is
    left as it was found (a later ``spawn`` of gloo ranks sees no
    group)."""
    if world == 1:
        yield
        return
    if dist.is_initialized():
        raise RuntimeError(
            f"execute_pair needs a process with no process group (it "
            f"fakes a world of {world}); this one runs "
            f"{dist.get_backend()} over {dist.get_world_size()} ranks")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    hook = sys.excepthook          # init_process_group wraps it
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()
        sys.excepthook = hook


@contextlib.contextmanager
def _expert_tp_env(on: bool):
    """``REPRO_EXPERT_TP`` set to ``on`` while a served model is built,
    put back after."""
    old = os.environ.get("REPRO_EXPERT_TP")
    os.environ["REPRO_EXPERT_TP"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["REPRO_EXPERT_TP"]
        else:
            os.environ["REPRO_EXPERT_TP"] = old


def _blocks(layout: Optional[shard.Layout], shapes, dtype_of, device):
    """Empty tensors of each leaf's block (the whole leaf without a
    layout) in ``dtype_of(path)``."""
    return mesh_lib.map_paths(lambda p, t: torch.empty(
        t.shape if layout is None else layout.block_shape(p, t.shape),
        dtype=dtype_of(p), device=device), shapes)


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages of ``tree``'s tensors (a tree of
    dicts, lists and tuples): what a step's arguments hold."""
    seen = {}
    for t in tree_lib.leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _train_run(cfg, tcfg, shape, mesh, device, fsdp):
    """The trainer's step on the rank's state: ``(fn, args, parts,
    None)``."""
    from repro_torch.training import train_step as ts
    shapes = param_shapes(cfg)
    layout = shard.layout_for(cfg, mesh, fsdp)
    params = _blocks(layout, shapes, lambda p: torch.float32, device)
    state = ts.init_train_state(cfg, tcfg, params=params, device=device,
                                mesh=mesh, layout=layout)
    del params
    specs = make_batch_specs(cfg, shape, dtype=cfg.dtype)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
             for k, v in specs.items()}
    step = ts.make_train_step(cfg, tcfg, mesh=mesh, layout=layout)
    parts = {"params": storage_bytes(state.params),
             "opt": storage_bytes((state.opt["m"], state.opt["v"])),
             "batch": storage_bytes(batch)}
    return (lambda: step(state, batch, step=0)), (state, batch), parts, None


def _serve_run(cfg, shape, mesh, device, fsdp, long_context):
    """The server's eager prefill or decode step with ``generate``'s
    sampled tokens, on the served layout and caches: ``(fn, args,
    parts, model)``."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import engine
    B, S = shape.global_batch, shape.seq_len
    layout = shard.serve_layout_for(cfg, mesh, fsdp)
    params = _blocks(layout, param_shapes(cfg), lambda p: torch.float32,
                     device)
    model = Transformer(cfg, device=device, mesh=mesh, fsdp=fsdp,
                        params=params)
    del params
    dt = getattr(torch, cfg.dtype)
    decode = shape.mode == "decode"
    L = 1 if decode else S
    tokens = (torch.zeros((B, L, cfg.d_model), dtype=dt, device=device)
              if cfg.frontend is not None
              else torch.zeros((B, L), dtype=torch.int32, device=device))

    def sample(logits):
        return engine.whole_rows(model, logits[:, -1].argmax(
            -1, keepdim=True), B)
    parts = {"params": storage_bytes(model.tree())}
    if not cfg.has_decode:
        @torch.inference_mode()
        def encode():
            h, _, _ = model.forward(tokens)
            return model.logits_from_hidden(h)
        return encode, (model.tree(), tokens), parts, model
    if decode and cfg.frontend is not None:
        # a frontend decodes through the API (the step builder takes ids)
        caches = model.init_caches(B, S, long_context=long_context)
        lay = model.cache_layout(B, S, long_context)
        rows = slice(0, B) if lay is None else lay.rows

        @torch.inference_mode()
        def run():
            logits, out = model.decode_step(tokens[rows], caches,
                                            long_context=long_context)
            return logits, out, sample(logits)
    elif decode:
        step = engine.build_decode(model, batch=B, cache_len=S,
                                   long_context=long_context, graph=False)
        caches = step.caches

        def run():
            logits = step(tokens)
            return logits, caches, sample(logits)
    else:
        caches = model.init_caches(B, S, long_context=long_context)
        prefill = engine.build_prefill(model, cache_len=S, batch=B,
                                       long_context=long_context)

        def run():
            logits, out = prefill(tokens, caches)
            return logits, out, sample(logits)
    parts["caches"] = storage_bytes(list(caches))
    return run, (model.tree(), tokens, caches), parts, model


def execute_pair(cfg, shape: ShapeConfig, mesh_shape: Dict[str, int], *,
                 rank: int = 0, fsdp: Optional[bool] = None,
                 expert_tp: Optional[bool] = None,
                 tcfg: Optional[TrainConfig] = None,
                 long_context: bool = False,
                 device="cpu") -> Dict[str, Any]:
    """Rank ``rank``'s step of ``cfg`` at ``shape`` on a mesh of
    ``mesh_shape`` (``{"data": D, "model": M}``), run once on fake
    tensors on ``device`` (the module docstring), with the layout
    choices :func:`count_pair` makes for the same arguments.  Returns
    ``memory_analysis`` (``op_analysis.MemoryTracker``), ``op_analysis``
    (``op_analysis.analyze``), ``collectives`` (the executed log's
    record, :func:`collectives_record`), ``log`` (the logged collectives
    in order), ``arguments`` (the step's argument bytes by part:
    ``params``, ``opt``, ``batch`` — the global batch, which every rank
    is given and cuts — or ``caches``) and ``seconds``.  A mesh with a
    ``pod`` axis raises (:data:`POD_REASON`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    if set(mesh_shape) != {"data", "model"}:
        raise NotImplementedError(f"mesh {mesh_shape}: {POD_REASON}")
    t0 = time.perf_counter()
    D, M = mesh_shape["data"], mesh_shape["model"]
    train = shape.mode == "train"
    tcfg = tcfg or DRYRUN_TCFG
    fsdp, expert_tp = _choices(cfg, shape, mesh_shape, fsdp, expert_tp)
    held = {}
    saved = alltoall.collectives
    with fake_world(D * M, rank), _expert_tp_env(expert_tp):
        mesh = None
        if D * M > 1:
            rows = ((mesh_lib.cut_tokens(
                (D, M), rank, shape.global_batch // tcfg.microbatches,
                shape.seq_len).n,) if train else ())
            mesh = mesh_lib.make_mesh((D, M), device=device, rows=rows)
        with FakeTensorMode():
            if train:
                fn, args, parts, model = _train_run(cfg, tcfg, shape, mesh,
                                                    device, fsdp)
            else:
                fn, args, parts, model = _serve_run(cfg, shape, mesh, device,
                                                    fsdp, long_context)

            def run():
                held["out"] = fn()
                return held["out"]
            alltoall.collectives = log = []
            try:
                with op_analysis.MemoryTracker(args) as tracker:
                    graph = trace_graph(run)
            finally:
                alltoall.collectives = saved
            memory = tracker.report(held.pop("out"))
            if model is not None:
                from repro_torch.serving import engine
                engine.clear_step_cache(model)
    ops_ = op_analysis.analyze(graph)
    ops_["collectives"].pop("log")
    inner = (cfg.moe.a2a_inner if cfg.moe is not None
             and isinstance(cfg.moe.a2a_inner, int) else 1)
    return {"memory_analysis": memory, "op_analysis": ops_,
            "collectives": collectives_record(_plan_of(log, mesh_shape),
                                              inner),
            "log": log, "arguments": parts,
            "seconds": time.perf_counter() - t0}


def _plan_of(log: List[Collective], mesh_shape) -> Plan:
    """A :class:`Plan` of logged collectives, each group's axes from its
    label (the node test's input)."""
    plan = Plan(mesh_shape)
    axes = {"model": ("model",), "data": ("data",),
            "world": tuple(mesh_shape)}
    plan.ops = [(c, axes.get(c.axis, ("model",))) for c in log]
    return plan


def roofline(record: Dict[str, Any]) -> Dict[str, Any]:
    """The three terms in seconds from the datasheet constants, the
    reference's: executed FLOPs a rank (``op_analysis``) over
    :data:`PEAK_FLOPS`, executed HBM bytes a rank over :data:`HBM_BW`,
    the wire bytes a rank over :data:`NVLINK_BW` inside a node and
    :data:`NIC_BW` across; the executed FLOPs over all chips and the
    useful fraction (model FLOPs over them).  A record without
    ``op_analysis`` (not executed, :data:`POD_REASON`) takes model FLOPs
    a chip and the stored bytes read once (a floor) instead, and says
    so in ``basis``."""
    coll = record["collectives"]
    intra = coll["total_wire_bytes"] - coll["internode_wire_bytes"]
    ran = record.get("op_analysis")
    out: Dict[str, Any] = {}
    if ran is None:
        terms = {"compute_s": record["model_flops_per_chip"] / PEAK_FLOPS,
                 "memory_s": record["stored_bytes"]["total"] / HBM_BW}
        out["basis"] = "plan: model FLOPs, stored bytes (not executed)"
    else:
        terms = {"compute_s": ran["flops"] / PEAK_FLOPS,
                 "memory_s": ran["hbm_bytes"] / HBM_BW}
        total = ran["flops"] * record["chips"]
        out.update(basis="executed", executed_flops_total=total,
                   useful_fraction=(record["model_flops"] / total
                                    if total else 0.0))
    terms["collective_s"] = (intra / NVLINK_BW
                             + coll["internode_wire_bytes"] / NIC_BW)
    return {**terms, "dominant": max(terms, key=terms.get),
            "step_time_bound_s": max(terms.values()), **out,
            "model_flops": record["model_flops"],
            "constants": "H100 SXM datasheet (not measured)"}


def run_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
             a2a=None, dispatch=None, tag: str = "", save: bool = True,
             tcfg: TrainConfig = None) -> Dict[str, Any]:
    """The record of one (arch, shape) at the production mesh, or its skip
    reason; saved under :data:`OUT_DIR` with ``save``.  The pair is
    counted (:func:`count_pair`) and, at 16x16, executed
    (:func:`execute_pair`): ``memory_analysis`` and ``op_analysis`` join
    the record, and a step whose logged collectives differ from the
    plan's raises.  A 2x16x16 record holds ``not_executed``
    (:data:`POD_REASON`) in their place."""
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
    mesh_shape = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    long_context = shape_name == "long_500k"
    t0 = time.perf_counter()
    out = count_pair(cfg, shape, mesh_shape, tcfg=tcfg,
                     long_context=long_context)
    plan = out.pop("plan")
    rec.update(out)
    rec["count_s"] = time.perf_counter() - t0
    if multi_pod:
        rec["not_executed"] = POD_REASON
    else:
        ran = execute_pair(cfg, shape, mesh_shape, fsdp=rec["fsdp"],
                           expert_tp=rec["expert_tp"], tcfg=tcfg,
                           long_context=long_context)
        want, got = plan.log(), collections.Counter(ran["log"])
        if got != want:
            raise RuntimeError(
                f"{arch} {shape_name}: the executed step's collectives differ "
                f"from the plan's: only planned {dict(want - got)}, only "
                f"executed {dict(got - want)}")
        rec.update(memory_analysis=ran["memory_analysis"],
                   op_analysis=ran["op_analysis"],
                   execute_s=ran["seconds"])
    rec["roofline"] = roofline(rec)
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


def _pair_job(out_dir: str, arch: str, shape_name: str, kw: dict):
    """:func:`run_pair` in a worker process, its record saved under
    ``out_dir``."""
    global OUT_DIR
    OUT_DIR = out_dir
    return run_pair(arch, shape_name, **kw)


def _run_pairs(pairs, jobs: int, **kw) -> List[Dict[str, Any]]:
    """Each pair's record, in order: in ``jobs`` worker processes (the
    ``spawn`` start method) when there is more than one pair to execute,
    else here.  A pair that fails raises here."""
    if jobs <= 1 or len(pairs) == 1 or kw.get("multi_pod"):
        return [run_pair(a, s, **kw) for a, s in pairs]
    import concurrent.futures
    import multiprocessing

    # the job by this module's import name, which a worker can import
    # also when this module runs as __main__
    from repro_torch.launch import dryrun
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=jobs,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        # the train steps, the longest to run, go first, the deepest first
        first = sorted(pairs, key=lambda p: (
            INPUT_SHAPES[p[1]].mode != "train",
            -configs.get_config(p[0]).num_layers))
        futs = {p: pool.submit(dryrun._pair_job, OUT_DIR, *p, kw)
                for p in first}
        return [futs[p].result() for p in pairs]


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
    ap.add_argument("--jobs", type=int,
                    default=min(len(os.sched_getaffinity(0)), 8),
                    help="worker processes that execute the pairs (default: "
                         "the CPUs this process may run on, at most 8; each "
                         "holds ~0.6 GB)")
    args = ap.parse_args(argv)
    if args.all:
        pairs = [(a, s) for a in configs.ASSIGNED for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        pairs = [(args.arch, args.shape)]
    recs = _run_pairs(pairs, args.jobs, multi_pod=args.multi_pod,
                      a2a=args.a2a, dispatch=args.dispatch, tag=args.tag)
    for (a, s), rec in zip(pairs, recs):
        if "skipped" in rec:
            print(f"{a:28s} {s:12s} SKIP: {rec['skipped']}")
            continue
        r, c = rec["roofline"], rec["collectives"]
        ma = rec.get("memory_analysis")
        peak = ("not executed" if ma is None else
                f"{ma['peak_per_device_bytes'] / 2 ** 30:.2f}GiB")
        print(f"{a:28s} {s:12s} {rec['mesh']:8s} "
              f"compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
              f"coll={r['collective_s']:.3e}s dom={r['dominant']:12s} "
              f"stored/rank={rec['stored_bytes']['total'] / 2 ** 30:.2f}GiB "
              f"peak/rank={peak} "
              f"wire/rank={c['total_wire_bytes'] / 2 ** 30:.2f}GiB "
              f"fsdp={rec['fsdp']} ({rec['count_s']:.2f}s count, "
              f"{rec.get('execute_s', 0.0):.2f}s run)")


if __name__ == "__main__":
    main()
