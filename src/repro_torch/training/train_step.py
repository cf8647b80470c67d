"""Train step: chunked CE loss, gradient accumulation, clipping, AdamW and
the non-finite skip-step guard — the port of
``repro/training/train_step.py`` on one device.

The parameters are the f32 master tree of ``models/transformer`` with
``requires_grad`` leaves; the forward casts each weight to ``cfg.dtype``
at its use, so the gradients land in f32.  The MoE layers differentiate
through the kernels' ``autograd.Function``s: the row gather's backward is
the scatter-add kernel, the grouped matmul's the dlhs and drhs kernels.

Skip-step guard: one NaN/Inf gradient must not corrupt the optimizer
state — the update is selected away with ``torch.where`` (params,
moments and the Adam count keep their bits) and ``TrainState`` counts
``skipped`` / ``nonfinite_streak`` steps.  ``tcfg.loss_scale`` adds
static or dynamic loss scaling: the loss is scaled before the backward,
the gradients unscaled after the finite check, and in ``"dynamic"`` mode
the scale halves on a bad step and doubles after
``loss_scale_growth_interval`` good ones.  Every counter, the scale, the
learning rate and the finite check stay on the device: a step never
makes the host wait for it.

``tcfg.remat`` ("block" | "full") recomputes each layer in the backward
(``models/transformer.forward``).  Injection seams for the fault harness
(``core/faults.py``), where the reference has them: ``train.activations``
(the hidden states before the CE), ``train.loss`` and ``train.grads``
(every leaf after accumulation); without a plan they add no op.

Gate noise (``gshard``, ``dense_to_sparse``) is an input of the forward,
drawn before it, one draw per layer per microbatch, from a
``torch.Generator`` on the device keyed by ``(tcfg.seed, step)`` — the
host's step index, which the caller passes (the reference's loop folds
the same index into its rng), so drawing never waits for the device.

Across ranks (``mesh``, a ``launch/mesh.Mesh``): the batch is the global
one, and each rank takes its token block of each microbatch
(``launch/mesh.token_block``, ``data/pipeline.cut_batch``: the r-th
contiguous block of the flattened tokens — whole rows when the rows divide
over the ranks, else a chunk of one row's positions, its attention
context-parallel over the ranks sharing the row; any other batch raises
``ValueError``); gate noise is drawn for the global tokens and each rank
takes the same flattened block, so the routing, the capacity drops and the
balance statistics are the reference's.  The CE is the global masked mean
(its numerator and denominator all-reduced), the aux loss global already
(``core/balance``); each rank back-propagates that global loss into its
own contributions (``alltoall.all_reduce_sum``).  The state is stored by a
``launch/shard.Layout`` (``layout``; by default today's: the experts over
``model``, every other leaf whole): a leaf that FSDP shards is gathered
for use and its gradient arrives reduce-scattered from the gather's
backward; every gradient is then summed over the axes its leaf is neither
gathered nor computed sharded on (``Layout.reduce_axes``: a replicated
leaf over the world, an expert leaf without FSDP over ``data``), so every
rank holds its block of the reference's gradients.
``clip_by_global_norm`` sums each leaf's squares over the axes whose ranks
hold disjoint blocks of it (``Layout.norm_axes``), counting every element
once; AdamW runs on the blocks; the skip guard's ``ok`` is all-reduced
with MIN, so every rank skips the same steps (a skipped step leaves every
block's bits).  Nothing here reads a value back to the host."""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device, tree
from repro_torch.core import faults as faults_mod
from repro_torch.core.alltoall import all_reduce_sum
from repro_torch.core.config import ModelConfig, TrainConfig
from repro_torch.data.pipeline import cut_batch
from repro_torch.launch import shard
from repro_torch.launch.mesh import token_block, tree_paths
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import (adamw_update, clip_by_global_norm,
                                     init_opt_state, make_schedule)

# dynamic loss scaling bounds (standard mixed-precision choices)
_DYNAMIC_SCALE_INIT = 2.0 ** 15
_SCALE_MIN = 1.0
_SCALE_MAX = 2.0 ** 24


class TrainState(NamedTuple):
    params: Any
    opt: Dict
    step: torch.Tensor                 # i32
    skipped: torch.Tensor              # i32: total skipped (non-finite) steps
    nonfinite_streak: torch.Tensor     # i32: CONSECUTIVE skipped steps
    good_streak: torch.Tensor          # i32: consecutive finite steps
    loss_scale: torch.Tensor           # f32: current loss scale


def init_loss_scale(tcfg: TrainConfig) -> float:
    return (_DYNAMIC_SCALE_INIT if tcfg.loss_scale == "dynamic"
            else float(tcfg.loss_scale))


def _master(p: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return p.detach().to(device=dev, dtype=torch.float32,
                         copy=True).requires_grad_(True)


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, *,
                     params: Optional[Dict[str, Any]] = None,
                     device=None, mesh=None, layout=None) -> TrainState:
    """A fresh state on ``device`` (``cuda`` unless given).  ``params`` (an
    f32 tree from ``init_params`` or ``convert.params_from_numpy``; under
    ``mesh`` already the rank's share) is copied into f32 masters; without
    it the weights are drawn from a ``torch.Generator`` seeded with
    ``tcfg.seed`` on the device, each leaf whole and then cut to the
    rank's block of ``layout`` (``launch/shard.layout_for(cfg, mesh)``,
    without FSDP, unless given).  The moments take the params' layout;
    the scalars are the same on every rank."""
    dev = resolve_device(device)
    if mesh is not None and layout is None:
        layout = shard.layout_for(cfg, mesh, fsdp=False)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(tcfg.seed)
        params = T.init_params(cfg, gen, device=dev, layout=layout)
    params = tree.map_(lambda p: _master(p, dev), params)

    def zero():
        return torch.zeros((), dtype=torch.int32, device=dev)
    return TrainState(params, init_opt_state(params, tcfg), zero(),
                      skipped=zero(), nonfinite_streak=zero(),
                      good_streak=zero(),
                      loss_scale=torch.tensor(init_loss_scale(tcfg),
                                              dtype=torch.float32,
                                              device=dev))


def _auto_chunks(S: int, V: int) -> int:
    """The reference's CE chunk count: one chunk's logits stay ~2^25
    elements per batch row."""
    target_tokens = max(16, 2 ** 25 // max(V, 1))
    nc = 1
    while S % (nc * 2) == 0 and S // nc > target_tokens and nc < 64:
        nc *= 2
    return nc


def chunked_ce_loss(params, cfg: ModelConfig, h: torch.Tensor,
                    targets: torch.Tensor, mask: torch.Tensor,
                    num_chunks: Optional[int] = None,
                    group=None, layout=None) -> torch.Tensor:
    """The unembed + CE over sequence chunks; h (B, S, d) → scalar.  With
    more than one chunk each chunk's body is recomputed in the backward
    (``torch.utils.checkpoint``), so only one chunk's (B, S/nc, V) logits
    are alive at a time, as in the reference's remat'd scan.  ``group``
    (a process group) makes it the mean over its ranks' tokens; ``layout``
    gathers a sharded head once, before the chunks (its gradient
    reduce-scattered once, after them)."""
    B, S, _ = h.shape
    head = T.head_params(params, cfg, layout)
    nc = num_chunks or _auto_chunks(S, cfg.vocab_size)
    while S % nc:
        nc -= 1

    def body(hi, ti, mi):
        logits = T.logits_from_hidden(head, cfg, hi).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, ti.long()[..., None])[..., 0]
        nll = (lse - gold) * mi
        return nll.sum(), mi.sum()

    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    c = S // nc
    for i in range(nc):
        args = (h[:, i * c:(i + 1) * c], targets[:, i * c:(i + 1) * c],
                mask[:, i * c:(i + 1) * c])
        t, n = (body(*args) if nc == 1
                else checkpoint(body, *args, use_reentrant=False))
        tot, cnt = tot + t, cnt + n
    if group is not None:
        tot, cnt = all_reduce_sum(tot, group), all_reduce_sum(cnt, group)
    return tot / torch.clamp(cnt, min=1.0)


def loss_and_grads(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                   scale: Optional[torch.Tensor] = None, *,
                   remat: str = "none",
                   noise: Optional[List[torch.Tensor]] = None,
                   faults: Optional[faults_mod.FaultPlan] = None,
                   step: Optional[torch.Tensor] = None, mesh=None,
                   layout=None, block=None):
    """(loss, ce, aux, grads) of one batch: the forward (``remat``, the
    per-layer gate ``noise``), the chunked CE and the backward, with the
    loss multiplied by ``scale`` (when given) before the backward.  The
    ``train.activations`` and ``train.loss`` seams of ``faults`` fire at
    the device counter ``step``.  ``grads`` has ``params``' structure.
    Under ``mesh`` ``batch`` holds this rank's token block ``block`` (a
    ``launch/mesh.TokenBlock``; None: whole rows), the losses are the
    global ones and ``grads`` this rank's contributions to them (a leaf
    ``layout`` gathers: summed over the gather's groups, the rank's
    block)."""
    h, aux, _ = T.forward(params, batch["inputs"], cfg, remat=remat,
                          noise=noise, mesh=mesh, layout=layout, block=block)
    h = faults_mod.apply_traced(faults, "train.activations", step, h)
    ce = chunked_ce_loss(params, cfg, h, batch["targets"],
                         batch["loss_mask"],
                         group=None if mesh is None else dist.group.WORLD,
                         layout=layout)
    loss = faults_mod.apply_traced(faults, "train.loss", step, ce + aux)
    scaled = loss if scale is None else loss * scale
    grads = torch.autograd.grad(scaled, tree.leaves(params))
    return (loss.detach(), ce.detach(), aux.detach(),
            tree.unflatten(params, list(grads)))


def noise_generator(tcfg: TrainConfig, step: int, device) -> torch.Generator:
    """The gate-noise generator of host step ``step``: a
    ``torch.Generator`` on ``device`` seeded from ``(tcfg.seed, step)``
    (numpy's ``SeedSequence`` mixes the pair)."""
    seed = int(np.random.SeedSequence((tcfg.seed, step)).generate_state(
        1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _reduce_grads(grads, layout):
    """Sum each leaf's gradient over its ``layout.reduce_axes``: the
    leaves of one set of axes in one flat buffer, the sets in a fixed
    order (every rank runs the same collectives)."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
    paths = [p for p, _ in tree_paths(grads)]
    leaves = tree.leaves(grads)
    out = list(leaves)
    buckets: Dict[Tuple[str, ...], List[int]] = {}
    for i, p in enumerate(paths):
        axes = layout.reduce_axes(p)
        if axes:
            buckets.setdefault(axes, []).append(i)
    for axes in sorted(buckets):
        idx = buckets[axes]
        flat = _flatten_dense_tensors([leaves[i] for i in idx])
        dist.all_reduce(flat, group=layout.group(axes))
        for i, g in zip(idx, _unflatten_dense_tensors(
                flat, [leaves[i] for i in idx]), strict=True):
            out[i] = g
    return tree.unflatten(grads, out)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    faults: Optional[faults_mod.FaultPlan] = None,
                    mesh=None, layout=None):
    """Returns ``train_step(state, batch, step=None, noise=None) →
    (state, metrics)``.

    ``batch`` holds the global batch; with ``tcfg.microbatches > 1`` it is
    split on the batch axis and the gradients averaged.  ``faults`` arms
    the traced seams; None inserts no op.  A noisy gate needs ``step``,
    the host's index of ``state.step`` (its draws are keyed by it), or
    ``noise``: one list of per-layer (tokens, E) draws per microbatch,
    over the microbatch's global tokens.  ``mesh`` trains across its
    ranks (the module docstring): ``state`` holds this rank's blocks of
    ``layout`` (``launch/shard.layout_for(cfg, mesh)``, without FSDP,
    unless given: the one ``init_train_state`` was given), and each
    microbatch must cut into the ranks' token blocks
    (``launch/mesh.token_block``: ``ValueError`` naming B, S and the mesh
    otherwise)."""
    if mesh is not None and layout is None:
        layout = shard.layout_for(cfg, mesh, fsdp=False)
    sched = make_schedule(tcfg)
    dynamic = tcfg.loss_scale == "dynamic"
    static_scale = not dynamic and float(tcfg.loss_scale) == 1.0
    noisy = T.noisy(cfg)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   step: Optional[int] = None,
                   noise: Optional[List[List[torch.Tensor]]] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        mbs = tcfg.microbatches
        scale = None if static_scale else state.loss_scale
        B, S = batch["inputs"].shape[:2]
        if B % mbs:
            raise ValueError(f"batch {B} is not divisible by "
                             f"microbatches={mbs}")
        # this rank's token block of each microbatch (raises before any
        # work when the microbatch does not cut over the ranks)
        block = None if mesh is None else token_block(mesh, B // mbs, S)
        parts = [{k: v[i * (B // mbs):(i + 1) * (B // mbs)]
                  for k, v in batch.items()} for i in range(mbs)]
        if noisy and noise is None:
            if step is None:
                raise ValueError(
                    f"gate={cfg.moe.gate!r} draws noise keyed by the step: "
                    f"pass train_step(..., step=<host step index>) or "
                    f"noise=")
            dev = batch["inputs"].device
            gen = noise_generator(tcfg, step, dev)
            # one row per token: B·S, for token ids and embeddings alike
            noise = [T.draw_gate_noise(
                cfg, math.prod(mb["inputs"].shape[:2]), gen, dev)
                for mb in parts]
        if mesh is not None:
            # this rank's block of each microbatch and the same flattened
            # block of its noise
            parts = [cut_batch(mb, block) for mb in parts]
            if noise is not None:
                noise = [[None if n is None else n[block.flat] for n in nz]
                         for nz in noise]
        kw = dict(remat=tcfg.remat, faults=faults, step=state.step,
                  mesh=mesh, layout=layout, block=block)
        loss, ce, aux, grads = loss_and_grads(
            state.params, parts[0], cfg, scale,
            noise=None if noise is None else noise[0], **kw)
        if mbs > 1:
            for i, mb in enumerate(parts[1:], 1):
                lo, c, a, g = loss_and_grads(
                    state.params, mb, cfg, scale,
                    noise=None if noise is None else noise[i], **kw)
                grads = tree.map_(torch.add, grads, g)
                loss, ce, aux = loss + lo, ce + c, aux + a
            grads = tree.map_(lambda g: g / mbs, grads)
            loss, ce, aux = loss / mbs, ce / mbs, aux / mbs
        if layout is not None:
            with torch.no_grad():
                grads = _reduce_grads(grads, layout)
        grads = faults_mod.apply_traced(faults, "train.grads", state.step,
                                        grads)

        with torch.no_grad():
            # -- non-finite guard -------------------------------------------
            ok = torch.isfinite(loss)
            for g in tree.leaves(grads):
                ok = ok & torch.all(torch.isfinite(g))
            if mesh is not None:
                # every rank skips the same steps
                oki = ok.to(torch.int32)
                dist.all_reduce(oki, op=dist.ReduceOp.MIN)
                ok = oki.bool()
            if not static_scale:
                # unscale AFTER the finite check (an overflowed Inf grad
                # must be seen as non-finite, not Inf/scale)
                inv = 1.0 / scale
                grads = tree.map_(lambda g: g * inv.to(g.dtype), grads)
            grads, gnorm = clip_by_global_norm(
                grads, tcfg.grad_clip, norm_axes=None if layout is None
                else [layout.norm_axes(p) for p, _ in tree_paths(grads)],
                group=None if layout is None else layout.group)
            lr = sched(state.step)
            new_params, new_opt = adamw_update(grads, state.opt,
                                               state.params, tcfg, lr)
            # bad step: params, moments AND the bias-correction count keep
            # their old bits — the update never happened
            new_params = tree.map_(
                lambda n, o: torch.where(ok, n, o.detach()).requires_grad_(
                    True), new_params, state.params)
            new_opt = tree.map_(lambda n, o: torch.where(ok, n, o),
                                new_opt, state.opt)

            oki = ok.to(torch.int32)
            skipped = state.skipped + (1 - oki)
            streak = torch.where(ok, 0, state.nonfinite_streak + 1)
            good = torch.where(ok, state.good_streak + 1, 0)
            if dynamic:
                grow = ok & (good >= tcfg.loss_scale_growth_interval)
                new_scale = torch.where(
                    ok, torch.where(grow, torch.clamp(scale * 2.0,
                                                      max=_SCALE_MAX), scale),
                    torch.clamp(scale * 0.5, min=_SCALE_MIN))
                good = torch.where(grow, 0, good)
            else:
                new_scale = state.loss_scale

        metrics = {"loss": loss, "ce": ce, "aux": aux, "grad_norm": gnorm,
                   "lr": lr, "skipped": skipped, "nonfinite_streak": streak,
                   "loss_scale": new_scale}
        return TrainState(new_params, new_opt, state.step + 1,
                          skipped=skipped, nonfinite_streak=streak,
                          good_streak=good, loss_scale=new_scale), metrics

    return train_step
