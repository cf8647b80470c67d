"""Training entry point with crash-safe resume — the port of
``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch hetumoe-paper-16e \\
      --steps 10 --batch 8 --seq 1024 [--remat block] \\
      [--ckpt-dir DIR --ckpt-every N --ckpt-keep K --resume] \\
      [--inject site:mode@steps] [--tune auto|off|calibrate] [--fabric F]

Across ranks (expert parallelism × data parallelism), one process per rank:

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch hetumoe-paper-16e --mesh 1x4 --batch 8 --seq 1024

runs under ``torchrun`` (``--backend nccl``, the default: one card per
rank), or calls :func:`run` with ``mesh_shape=`` from ranks that
``launch.mesh.spawn`` started (``backend="gloo"`` for the CPU or for
several ranks on one card).  Every rank draws the same global batch and
trains on its token block, the r-th contiguous block of the flattened
batch·seq tokens (``launch/mesh.token_block``): ``batch`` / (D·M) whole
rows when D·M divides ``batch``; else, when ``batch`` divides D·M and n =
D·M / ``batch`` divides ``seq``, a chunk of seq/n positions of one row,
attention context-parallel over the n ranks sharing the row (e.g.
``--mesh 2x2 --batch 2``, ``--mesh 1x4 --batch 1``); any other batch
raises ``ValueError`` before any work.  Rank 0 prints the banner (mesh,
backend, ``fsdp=``, the ranks a row is split over, the state's bytes a
rank, the resolved MoE knobs) and the log.  The train state is laid out by
the reference's sharding rules (``launch/mesh.state_shardings``, stored as
``launch/shard.py`` says): FSDP (ZeRO-3 over the ranks) where the
reference's ``needs_fsdp`` asks for it (master + moments over 6e9 bytes a
device under the model axis alone), else the experts over ``model`` and
every other leaf whole; ``run(fsdp=True|False)`` decides it instead (no
CLI flag, as the reference has none).

Runs on the GPU unless ``--device cpu`` is given.  The f32 master weights
are drawn from a ``torch.Generator`` seeded with ``--seed`` on the device;
the batches come from the deterministic synthetic pipeline keyed by
``(seed, step)``, and a noisy gate's draws by the same pair.

Fault tolerance, as in the reference: ``--ckpt-every N`` saves atomically
every N steps (keep-last ``--ckpt-keep``, default 3) and a save ends a run
with ``--ckpt-dir``; ``--resume`` restores the newest *intact* checkpoint
and continues — because data, gate noise and the lr schedule are keyed by
the global step, a killed-and-resumed run reproduces the uninterrupted
trajectory bitwise.  The checkpoint format and keys are the reference's
(``checkpoint/io.py``), so a run may resume from a checkpoint of the JAX
trainer and the reverse.  ``--ckpt-dir`` works with ``--mesh``: the state
is saved whole into the same one file (each leaf gathered onto rank 0's
host, rank 0 writes, the others wait), and every rank restores its own
blocks from it, so a checkpoint moves between meshes, with or without
FSDP, and to and from one device and the JAX trainer.  Non-finite steps
are skipped by the train step; the loop fails fast once
``TrainConfig.max_skipped_steps`` consecutive steps were skipped.  ``--inject site:mode@steps`` arms the fault harness
(``core/faults.py``): the ``train.loop`` crash point at the top of each
step, the checkpoint's crash points and the train step's traced seams.
``--history-out`` dumps the per-step metrics (and ``start``,
``resumed``) as JSON.

``--tune`` and ``--fabric`` are the reference's: ``auto`` resolves the
``"auto"`` MoE knobs from the α–β model over the named fabric, ``off``
pins them to the static defaults, ``calibrate`` measures a few AllToAll
payloads over the mesh's model group once and fits α–β
(``core/tuning.calibrate_fabric``).  ``run`` also takes a ``dispatch``
keyword (no CLI flag, as the reference has none) that overrides the MoE
dispatch mode the way ``serving.engine.serve_config`` does, ``moe``
keywords (e.g. ``gate=``) that replace fields of the preset's
``MoEConfig``, ``init_params``: a whole parameter tree in the
reference's layout (numpy leaves, e.g. a JAX trainer's initial
parameters) to start from, ``fsdp`` (above) and ``num_layers``, which
cuts the preset's depth (no CLI flag, as the reference has none; a
full-width run on one card, as ``launch.serve.run(num_layers=)``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import configs, resolve_device, tree
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.convert import params_from_numpy
from repro_torch.core import faults as faults_mod
from repro_torch.core import tuning
from repro_torch.core.config import TrainConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shard
from repro_torch.serving.engine import serve_config
from repro_torch.training.train_step import init_train_state, make_train_step


def _resolved_knobs(cfg, mesh, tokens_per_rank: int) -> str:
    """The MoE knobs as this run resolves them, for the banner."""
    if cfg.moe is None:
        return ""
    M = 1 if mesh is None else mesh.shape["model"]
    r = tuning.resolve_moe_config(cfg.moe, model_size=M,
                                  tokens_per_shard=tokens_per_rank,
                                  d_model=cfg.d_model,
                                  dtype=getattr(torch, cfg.dtype))
    return (f"dispatch={r.dispatch} gate={r.gate} a2a={r.a2a} "
            f"a2a_inner={r.a2a_inner} overlap_chunks={r.overlap_chunks} "
            f"payload_dtype={r.payload_dtype} "
            f"grouped_ep_bound_factor={r.grouped_ep_bound_factor} ")


def run(arch: str, *, steps: int, batch: int, seq: int, smoke: bool,
        lr: float = 3e-3, microbatches: int = 1, remat: str = "none",
        mesh_shape=(1, 1), log_every: int = 10, ckpt_dir: str = None,
        ckpt_every: int = None, ckpt_keep: int = 3, resume: bool = False,
        seed: int = 0, loss_scale="none", history_out: str = None,
        faults: Optional[faults_mod.FaultPlan] = None, tune: str = "auto",
        fabric=None, dispatch: Optional[str] = None,
        moe: Optional[dict] = None, device=None,
        stats: Optional[dict] = None, init_params=None,
        fsdp: Optional[bool] = None, num_layers: Optional[int] = None):
    """Train ``steps`` AdamW steps; returns ``(state, history)`` (under a
    mesh, this rank's state: its blocks of the layout).  ``stats`` (when
    given) receives, as the run goes (so a run cut by a fault leaves what
    it reached), ``step_s``: each step's host-clock seconds up to its
    metrics' arrival on the host; ``save_s``: seconds per checkpoint
    save; ``restore_s``: the resume's restore, or None; ``layout``: the
    state's ``launch/shard.Layout`` (None on one device).  A
    ``mesh_shape`` other than (1, 1) needs an initialized process group of
    D·M ranks; ``fsdp`` (None: the reference's ``needs_fsdp``) decides
    whether the state is stored FSDP-sharded there.  A batch that does
    not cut into the mesh's token blocks raises ``ValueError`` first."""
    if (ckpt_every or resume) and not ckpt_dir:
        raise ValueError("--ckpt-every/--resume require --ckpt-dir")
    if batch % microbatches:
        raise ValueError(f"batch {batch} is not divisible by "
                         f"microbatches={microbatches}")
    # a microbatch that does not cut over the mesh raises before any work;
    # the mesh makes the row groups its cut splits rows over
    split = mesh_lib.cut_tokens(tuple(mesh_shape), 0, batch // microbatches,
                                seq).n
    mesh = mesh_lib.make_smoke_mesh(tuple(mesh_shape), device=device,
                                    rows=(split,))
    lead = mesh is None or mesh.rank == 0
    cfg = configs.smoke_config(arch) if smoke else configs.get_config(arch)
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    if moe:
        if cfg.moe is None:
            raise ValueError(f"moe={moe!r} requested but {cfg.name} has no "
                             f"MoE layer (cfg.moe is None)")
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    cfg = serve_config(cfg, dispatch=dispatch)
    ls = 1.0 if loss_scale in (None, "none") else (
        "dynamic" if loss_scale == "dynamic" else float(loss_scale))
    tcfg = TrainConfig(learning_rate=lr, warmup_steps=max(steps // 10, 1),
                       total_steps=steps, microbatches=microbatches,
                       remat=remat, seed=seed, loss_scale=ls)
    tmode, tfab = tuning.configure(tune, fabric, mesh=mesh)
    if cfg.moe is not None and lead:
        print(f"tune={tmode} fabric={tfab}")
    layout = shard.layout_for(cfg, mesh, fsdp)
    step_fn = make_train_step(cfg, tcfg, faults=faults, mesh=mesh,
                              layout=layout)
    dev = resolve_device(device) if mesh is None else mesh.device
    state = init_train_state(
        cfg, tcfg, device=dev, mesh=mesh, layout=layout,
        params=(None if init_params is None
                else params_from_numpy(init_params, cfg, mesh,
                                       fsdp=layout is not None
                                       and layout.fsdp)))
    stats = {} if stats is None else stats
    stats.update(step_s=[], save_s=[], restore_s=None, layout=layout)
    start = 0
    if resume:
        if latest_step(ckpt_dir) is not None:
            t = time.perf_counter()
            state, start = restore_checkpoint(ckpt_dir, state, cfg=cfg,
                                              layout=layout)
            stats["restore_s"] = time.perf_counter() - t
            if lead:
                print(f"resumed from step {start} ({ckpt_dir})")
        elif lead:
            print(f"--resume: no checkpoint under {ckpt_dir}, starting fresh")

    def save(at: int):
        t = time.perf_counter()
        save_checkpoint(ckpt_dir, state, at, keep=ckpt_keep, cfg=cfg,
                        layout=layout)
        stats["save_s"].append(time.perf_counter() - t)

    n_params = sum(p.numel() for p in tree.leaves(state.params))
    if lead:
        world = 1 if mesh is None else mesh.world
        where = ("mesh=1x1 " if mesh is None
                 else f"mesh={mesh.describe()} fsdp={layout.fsdp} (params "
                      f"per rank) row_split={split} ")
        state_bytes = sum(t.numel() * t.element_size() for t in tree.leaves(
            (state.params, state.opt["m"], state.opt["v"])))
        print(f"arch={cfg.name} params={n_params / 1e6:.1f}M {where}"
              f"state={state_bytes / 1e9:.3f} GB a rank "
              + _resolved_knobs(cfg, mesh, batch * seq // world)
              + f"remat={remat} device={dev}")
    ds = SyntheticLM(cfg, batch=batch, seq_len=seq, seed=seed, device=dev)
    history = []
    t0 = time.time()
    with faults_mod.active(faults):
        for s in range(start, steps):
            faults_mod.crash_point("train.loop", index=s)
            bt = ds.next_batch(s)
            ts = time.perf_counter()
            state, m = step_fn(state, bt, step=s)
            m = {k: float(v) for k, v in m.items()}
            stats["step_s"].append(time.perf_counter() - ts)
            history.append({"step": s, **m})
            if lead and (s % log_every == 0 or s == steps - 1):
                dt = time.time() - t0
                tput = batch * seq * (s + 1 - start) / max(dt, 1e-9)
                print(f"step {s:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                      f"aux {m['aux']:.4f} gnorm {m['grad_norm']:.2f} "
                      f"skip {m['skipped']:.0f} streak "
                      f"{m['nonfinite_streak']:.0f} tok/s {tput:,.0f}")
            if m["nonfinite_streak"] >= tcfg.max_skipped_steps:
                raise RuntimeError(
                    f"aborting at step {s}: {int(m['nonfinite_streak'])} "
                    f"consecutive non-finite steps were skipped (>= "
                    f"max_skipped_steps={tcfg.max_skipped_steps}) — the run "
                    f"is diverging; restore an earlier checkpoint, lower the "
                    f"lr, or enable loss_scale='dynamic'")
            if ckpt_every and (s + 1) % ckpt_every == 0 and s + 1 < steps:
                save(s + 1)
    if ckpt_dir:
        save(steps)
        if lead:
            print("checkpoint saved to", ckpt_dir)
    if history_out and lead:
        with open(history_out, "w") as f:
            json.dump({"arch": cfg.name, "steps": steps, "start": start,
                       "resumed": bool(resume and start), "seed": seed,
                       "history": history}, f, indent=1)
        print("history written to", history_out)
    return state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU scale)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=["none", "block", "full"])
    ap.add_argument("--mesh", default="1x1", type=mesh_lib.mesh_cli_arg,
                    help="DxM data×model mesh of ranks (D·M processes, "
                         "e.g. under torchrun)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="save an atomic checkpoint every N steps")
    ap.add_argument("--ckpt-keep", type=int, default=3,
                    help="retain only the newest K checkpoints")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest intact checkpoint in --ckpt-dir")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loss-scale", default="none",
                    help="'none', 'dynamic', or a static float")
    ap.add_argument("--history-out", default=None,
                    help="dump the per-step metric history as JSON")
    ap.add_argument("--inject", action="append", default=[],
                    help="fault spec 'site:mode@steps' (repeatable), e.g. "
                         "'train.grads:nan@3' or "
                         "'ckpt.data_tmp_written:kill@20'")
    ap.add_argument("--tune", default="auto",
                    choices=list(tuning.TUNE_MODES),
                    help="'auto' resolves MoEConfig 'auto' knobs from the "
                         "α–β cost model, 'off' pins them to the static "
                         "defaults, 'calibrate' measures a few AllToAll "
                         "payloads over the mesh once and fits α–β "
                         "(persisted to TUNE_moe_torch.json)")
    ap.add_argument("--fabric", default="pcie_eth100",
                    type=mesh_lib.fabric_cli_arg,
                    help="named fast/slow LinkSpec pair the tuner scores "
                         "against (pcie_eth100)")
    ap.add_argument("--backend", default="nccl", choices=mesh_lib.BACKENDS,
                    help="process-group backend of a mesh run started "
                         "here (torchrun): nccl (one card per rank) or "
                         "gloo (the CPU)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    faults = faults_mod.plan_from_specs(args.inject) if args.inject else None
    started = False
    if tuple(args.mesh) != (1, 1) and not dist.is_initialized():
        if "RANK" not in os.environ:
            raise RuntimeError(
                f"--mesh {'x'.join(map(str, args.mesh))} runs one process "
                f"per rank: start it under torchrun (or call run() from "
                f"ranks that launch.mesh.spawn started)")
        dist.init_process_group(args.backend, init_method="env://")
        started = True
    try:
        run(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
            smoke=args.smoke, lr=args.lr, microbatches=args.microbatches,
            remat=args.remat, mesh_shape=args.mesh,
            log_every=args.log_every, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every, ckpt_keep=args.ckpt_keep,
            resume=args.resume, seed=args.seed, loss_scale=args.loss_scale,
            history_out=args.history_out, faults=faults, tune=args.tune,
            fabric=args.fabric, device=args.device)
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
