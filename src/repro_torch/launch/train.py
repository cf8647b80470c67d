"""Training entry point — the port of ``repro/launch/train.py`` on one
device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch hetumoe-paper-16e \\
      --steps 10 --batch 8 --seq 1024

Runs on the GPU unless ``--device cpu`` is given.  The f32 master weights
are drawn from a ``torch.Generator`` seeded with ``--seed`` on the device;
the batches come from the deterministic synthetic pipeline keyed by
``(seed, step)``.  Non-finite steps are skipped by the train step; the
loop fails fast once ``TrainConfig.max_skipped_steps`` consecutive steps
were skipped.  ``--history-out`` dumps the per-step metrics as JSON.

Not ported yet (each raises ``NotImplementedError`` naming ROADMAP.md):
``--remat`` other than ``none``, checkpoints (``--ckpt-dir``,
``--ckpt-every``, ``--resume``), fault injection (``--inject``), meshes
other than ``1x1`` and ``--tune`` other than ``auto``.  ``run`` also takes
a ``dispatch`` keyword (no CLI flag, as the reference has none) that
overrides the MoE dispatch mode the way ``serving.engine.serve_config``
does.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

from repro_torch import configs, resolve_device, tree
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
        ckpt_every: int = None, resume: bool = False, seed: int = 0,
        loss_scale="none", history_out: str = None, faults=None,
        tune: str = "auto", dispatch: Optional[str] = None, device=None,
        stats: Optional[dict] = None):
    """Train ``steps`` AdamW steps; returns ``(state, history)``.
    ``stats`` (when given) receives ``step_s``, each step's host-clock
    seconds up to its metrics' arrival on the host."""
    if (ckpt_every or resume) and not ckpt_dir:
        raise ValueError("--ckpt-every/--resume require --ckpt-dir")
    if ckpt_dir or ckpt_every or resume:
        raise _unported("checkpointing (--ckpt-dir/--ckpt-every/--resume)")
    if faults is not None:
        raise _unported("fault injection (--inject)")
    if tuple(mesh_shape) != (1, 1):
        raise _unported(f"mesh {tuple(mesh_shape)} (only 1x1)")
    if tune != "auto":
        raise _unported(f"--tune {tune}")
    cfg = configs.smoke_config(arch) if smoke else configs.get_config(arch)
    cfg = serve_config(cfg, dispatch=dispatch)
    ls = 1.0 if loss_scale in (None, "none") else (
        "dynamic" if loss_scale == "dynamic" else float(loss_scale))
    tcfg = TrainConfig(learning_rate=lr, warmup_steps=max(steps // 10, 1),
                       total_steps=steps, microbatches=microbatches,
                       remat=remat, seed=seed, loss_scale=ls)
    step_fn = make_train_step(cfg, tcfg)
    dev = resolve_device(device)
    state = init_train_state(cfg, tcfg, device=dev)
    n_params = sum(p.numel() for p in tree.leaves(state.params))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M mesh=1x1 "
          f"dispatch={cfg.moe.dispatch} device={dev}")
    ds = SyntheticLM(cfg, batch=batch, seq_len=seq, seed=seed, device=dev)
    history, step_s = [], []
    t0 = time.time()
    for s in range(steps):
        bt = ds.next_batch(s)
        ts = time.perf_counter()
        state, m = step_fn(state, bt)
        m = {k: float(v) for k, v in m.items()}
        step_s.append(time.perf_counter() - ts)
        history.append({"step": s, **m})
        if s % log_every == 0 or s == steps - 1:
            dt = time.time() - t0
            tput = batch * seq * (s + 1) / max(dt, 1e-9)
            print(f"step {s:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                  f"aux {m['aux']:.4f} gnorm {m['grad_norm']:.2f} "
                  f"skip {m['skipped']:.0f} streak "
                  f"{m['nonfinite_streak']:.0f} tok/s {tput:,.0f}")
        if m["nonfinite_streak"] >= tcfg.max_skipped_steps:
            raise RuntimeError(
                f"aborting at step {s}: {int(m['nonfinite_streak'])} "
                f"consecutive non-finite steps were skipped (>= "
                f"max_skipped_steps={tcfg.max_skipped_steps}) — the run "
                f"is diverging; lower the lr, or enable "
                f"loss_scale='dynamic'")
    if history_out:
        with open(history_out, "w") as f:
            json.dump({"arch": cfg.name, "steps": steps, "start": 0,
                       "resumed": False, "seed": seed,
                       "history": history}, f, indent=1)
        print("history written to", history_out)
    if stats is not None:
        stats["step_s"] = step_s
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
    ap.add_argument("--ckpt-every", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loss-scale", default="none",
                    help="'none', 'dynamic', or a static float")
    ap.add_argument("--history-out", default=None,
                    help="dump the per-step metric history as JSON")
    ap.add_argument("--inject", action="append", default=[],
                    help="fault spec 'site:mode@steps' (not ported yet)")
    ap.add_argument("--tune", default="auto",
                    choices=["auto", "off", "calibrate"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.inject:
        raise _unported("fault injection (--inject)")
    run(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        smoke=args.smoke, lr=args.lr, microbatches=args.microbatches,
        remat=args.remat, mesh_shape=args.mesh, log_every=args.log_every,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        resume=args.resume, seed=args.seed, loss_scale=args.loss_scale,
        history_out=args.history_out, tune=args.tune, device=args.device)


if __name__ == "__main__":
    main()
