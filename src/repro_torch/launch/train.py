"""Training entry point with crash-safe resume — the port of
``repro/launch/train.py`` on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch hetumoe-paper-16e \\
      --steps 10 --batch 8 --seq 1024 [--remat block] \\
      [--ckpt-dir DIR --ckpt-every N --ckpt-keep K --resume] \\
      [--inject site:mode@steps]

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
trainer and the reverse.  Non-finite steps are skipped by the train step;
the loop fails fast once ``TrainConfig.max_skipped_steps`` consecutive
steps were skipped.  ``--inject site:mode@steps`` arms the fault harness
(``core/faults.py``): the ``train.loop`` crash point at the top of each
step, the checkpoint's crash points and the train step's traced seams.
``--history-out`` dumps the per-step metrics (and ``start``,
``resumed``) as JSON.

Not ported yet (each raises ``NotImplementedError`` naming ROADMAP.md):
meshes other than ``1x1`` and ``--tune`` other than ``auto``.  ``run``
also takes a ``dispatch`` keyword (no CLI flag, as the reference has
none) that overrides the MoE dispatch mode the way
``serving.engine.serve_config`` does, and ``moe`` keywords (e.g.
``gate=``) that replace fields of the preset's ``MoEConfig``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

from repro_torch import configs, resolve_device, tree
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.core import faults as faults_mod
from repro_torch.core.config import TrainConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.serving.engine import serve_config
from repro_torch.training.train_step import init_train_state, make_train_step


def mesh_cli_arg(spec: str):
    """'DxM' → (D, M); only (1, 1) runs (``run`` raises for the rest)."""
    try:
        d, m = (int(x) for x in str(spec).split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--mesh {spec!r}: expected DxM, e.g. 1x1") from None
    return (d, m)


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md)")


def run(arch: str, *, steps: int, batch: int, seq: int, smoke: bool,
        lr: float = 3e-3, microbatches: int = 1, remat: str = "none",
        mesh_shape=(1, 1), log_every: int = 10, ckpt_dir: str = None,
        ckpt_every: int = None, ckpt_keep: int = 3, resume: bool = False,
        seed: int = 0, loss_scale="none", history_out: str = None,
        faults: Optional[faults_mod.FaultPlan] = None, tune: str = "auto",
        dispatch: Optional[str] = None, moe: Optional[dict] = None,
        device=None, stats: Optional[dict] = None):
    """Train ``steps`` AdamW steps; returns ``(state, history)``.
    ``stats`` (when given) receives, as the run goes (so a run cut by a
    fault leaves what it reached), ``step_s``: each step's host-clock
    seconds up to its metrics' arrival on the host; ``save_s``: seconds
    per checkpoint save; ``restore_s``: the resume's restore, or None."""
    if (ckpt_every or resume) and not ckpt_dir:
        raise ValueError("--ckpt-every/--resume require --ckpt-dir")
    if tuple(mesh_shape) != (1, 1):
        raise _unported(f"mesh {tuple(mesh_shape)} (only 1x1)")
    if tune != "auto":
        raise _unported(f"--tune {tune}")
    cfg = configs.smoke_config(arch) if smoke else configs.get_config(arch)
    if moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    cfg = serve_config(cfg, dispatch=dispatch)
    ls = 1.0 if loss_scale in (None, "none") else (
        "dynamic" if loss_scale == "dynamic" else float(loss_scale))
    tcfg = TrainConfig(learning_rate=lr, warmup_steps=max(steps // 10, 1),
                       total_steps=steps, microbatches=microbatches,
                       remat=remat, seed=seed, loss_scale=ls)
    step_fn = make_train_step(cfg, tcfg, faults=faults)
    dev = resolve_device(device)
    state = init_train_state(cfg, tcfg, device=dev)
    stats = {} if stats is None else stats
    stats.update(step_s=[], save_s=[], restore_s=None)
    start = 0
    if resume:
        if latest_step(ckpt_dir) is not None:
            t = time.perf_counter()
            state, start = restore_checkpoint(ckpt_dir, state, cfg=cfg)
            stats["restore_s"] = time.perf_counter() - t
            print(f"resumed from step {start} ({ckpt_dir})")
        else:
            print(f"--resume: no checkpoint under {ckpt_dir}, starting fresh")

    def save(at: int):
        t = time.perf_counter()
        save_checkpoint(ckpt_dir, state, at, keep=ckpt_keep, cfg=cfg)
        stats["save_s"].append(time.perf_counter() - t)

    n_params = sum(p.numel() for p in tree.leaves(state.params))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M mesh=1x1 "
          f"dispatch={cfg.moe.dispatch} gate={cfg.moe.gate} remat={remat} "
          f"device={dev}")
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
            if s % log_every == 0 or s == steps - 1:
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
        print("checkpoint saved to", ckpt_dir)
    if history_out:
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
    ap.add_argument("--mesh", default="1x1", type=mesh_cli_arg)
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
                    choices=["auto", "off", "calibrate"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    faults = faults_mod.plan_from_specs(args.inject) if args.inject else None
    run(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        smoke=args.smoke, lr=args.lr, microbatches=args.microbatches,
        remat=args.remat, mesh_shape=args.mesh, log_every=args.log_every,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        ckpt_keep=args.ckpt_keep, resume=args.resume, seed=args.seed,
        loss_scale=args.loss_scale, history_out=args.history_out,
        faults=faults, tune=args.tune, device=args.device)


if __name__ == "__main__":
    main()
