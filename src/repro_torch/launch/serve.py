"""Serving entry point: prefill a batch of prompts, decode with batched steps.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch hetumoe-paper-16e \\
      --batch 8 --prompt-len 1024 --gen 32 --dispatch grouped
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \\
      --batch 4 --prompt-len 8064 --gen 128

Every registered preset with token inputs serves (``configs.ARCHS``);
the frontend presets (``hubert-xlarge``, encoder-only, and
``internvl2-2b``) are refused, as the reference's entry point refuses them:
``internvl2-2b`` is served through the API (``serving.engine
.refuse_frontend``).  A windowed one
(``h2o-danube-3-4b``, ``gemma2-9b``'s local layers) decodes through ring
caches of its window's length.  Runs on the GPU unless ``--device cpu``
is given.  The weights are drawn from a ``torch.Generator`` seeded with
``--seed`` on the device, and the prompts from one seeded on the CPU.  ``--dispatch {sort,grouped}``
overrides the preset's MoE dispatch mode (validated; a typo fails fast,
and so does the flag on a dense preset such as ``yi-6b``).
``--repeat N`` serves the same prompts N times on one model and prints
each run's prefill and per-step decode time, then their medians over the
runs after the first (which includes the kernels' build, the libraries'
warm-up and the capture of the decode step's CUDA graph).

Across ranks, one process per rank:

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch dbrx-132b --mesh 2x2 --batch 8 --prompt-len 1024 --gen 16

runs under ``torchrun`` (``--backend nccl``, the default: one card per
rank; ``--backend gloo`` lets several ranks share one card, or run on the
CPU), or calls :func:`run` with ``mesh_shape=`` from ranks that
``launch.mesh.spawn`` started.  Each rank stores the model by the
reference's serving rule (``models/transformer.Transformer(mesh=)``): its
E/M experts, and under expert TP their f-slice over the data group, every
other weight whole (``run(fsdp=True)``: sharded as the reference's
``param_shardings(fsdp=True)``).  Every rank is given the same prompts
and serves its data rank's rows of them, the prefill context-parallel
over the model group (each rank its chunk of the positions), and stores
its block of the caches by the reference's cache rule
(``launch/shard.cache_layout_for``); the prefill gathers each block's
experts whole in f inside the block, and a decode step runs expert
tensor parallelism over the data group on the stored slice
(``REPRO_EXPERT_TP=0`` stores the experts whole in f and turns it off).
The decode step across ranks is eager
(``serving.engine.decode_graph``).  Rank 0 prints the banner (mesh,
backend, the MoE knobs resolved for the prefill and the decode step, the
decode mode), the cache bytes a rank stores beside one process's, and
the sample; every rank returns the same tokens.  ``--tune`` and
``--fabric`` are ``launch/train.py``'s.
"""
from __future__ import annotations

import argparse
import os
import statistics
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import configs, resolve_device
from repro_torch.core import tuning
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.transformer import Transformer
from repro_torch.serving.engine import (_tokens_per_shard, clear_step_cache,
                                        decode_graph, generate,
                                        refuse_frontend, serve_config,
                                        validate_dispatch)


def dispatch_cli_arg(name: str) -> str:
    try:
        return validate_dispatch(name)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))


def _knobs(cfg, mesh, tokens_per_rank: int) -> str:
    """The MoE knobs as resolved at ``tokens_per_rank``."""
    M = 1 if mesh is None else mesh.shape["model"]
    r = tuning.resolve_moe_config(cfg.moe, model_size=M,
                                  tokens_per_shard=tokens_per_rank,
                                  d_model=cfg.d_model,
                                  dtype=getattr(torch, cfg.dtype))
    return (f"a2a={r.a2a} a2a_inner={r.a2a_inner} "
            f"overlap_chunks={r.overlap_chunks} "
            f"payload_dtype={r.payload_dtype} "
            f"grouped_ep_bound_factor={r.grouped_ep_bound_factor}")


def _banner(cfg, mesh, dispatch, tmode, tfab, batch, prompt_len,
            model) -> str:
    """Rank 0's banner: mesh, backend, the MoE knobs resolved for the
    prefill and for the decode step, and the decode mode."""
    where = "mesh=1x1" if mesh is None else f"mesh={mesh.describe()}"
    graph = decode_graph(model)
    mode = ("graph" if graph and model.device.type == "cuda" else
            "eager" if mesh is None else "eager (collectives across ranks)")
    parts = [where, f"device={model.device}"]
    if mesh is not None:
        parts.append(f"fsdp={model.layout_key[0]}")
    if cfg.moe is not None:
        prefill = _tokens_per_shard(mesh, batch * prompt_len)
        decode = _tokens_per_shard(mesh, batch)
        parts += [f"dispatch={cfg.moe.dispatch} "
                  f"({'flag' if dispatch else 'config default'})",
                  f"tune={tmode} fabric={tfab}",
                  f"prefill: {_knobs(cfg, mesh, prefill)}",
                  f"decode: {_knobs(cfg, mesh, decode)} "
                  f"expert_tp={'data' if model.layout_key[1] else None}"]
    return " ".join(parts) + f" decode={mode}"


def run(arch: str, *, smoke: bool, batch: int, prompt_len: int, gen: int,
        temperature: float = 0.0, seed: int = 0,
        dispatch: Optional[str] = None, device=None,
        stats: Optional[dict] = None, repeat: int = 1, mesh_shape=(1, 1),
        tune: str = "auto", fabric=None,
        num_layers: Optional[int] = None,
        fsdp: Optional[bool] = False) -> torch.Tensor:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens for ``gen``
    new tokens, ``repeat`` times; returns the (batch, prompt_len + gen)
    token ids of the last run.  ``stats`` (when given) receives the last
    run's ``generate`` timings.  A ``mesh_shape`` other than (1, 1) needs
    an initialized process group of D·M ranks, every one of which calls
    this alike; ``num_layers`` (no CLI flag, as the reference has none) serves
    the preset cut to that depth, as ``chip_smoke.py`` serves the presets
    that do not fit one card.  ``fsdp`` (no CLI flag: the reference's
    serve has none) stores the dense leaves sharded too
    (``Transformer(fsdp=)``; None asks ``needs_fsdp``)."""
    cfg = configs.smoke_config(arch) if smoke else configs.get_config(arch)
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    if not cfg.has_decode:
        raise ValueError(f"{arch} is encoder-only")
    refuse_frontend(cfg)
    cfg = serve_config(cfg, dispatch=dispatch)
    mesh = mesh_lib.make_smoke_mesh(tuple(mesh_shape), device=device)
    lead = mesh is None or mesh.rank == 0
    dev = resolve_device(device) if mesh is None else mesh.device
    tmode, tfab = tuning.configure(tune, fabric, mesh=mesh)
    model = Transformer(cfg, device=dev, seed=seed, mesh=mesh, fsdp=fsdp)
    if lead:
        print(_banner(cfg, mesh, dispatch, tmode, tfab, batch, prompt_len,
                      model))
    gen_cpu = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen_cpu)
    times = []
    for _ in range(repeat):
        sample_gen = torch.Generator(device=dev).manual_seed(seed)
        st = {}
        t0 = time.perf_counter()
        out = generate(model, prompt, steps=gen, temperature=temperature,
                       generator=sample_gen, stats=st)
        dt = time.perf_counter() - t0
        decode_ms = 1e3 * st["decode_s"] / max(st["decode_steps"], 1)
        if lead:
            print(f"arch={cfg.name} batch={batch} prompt={prompt_len} "
                  f"gen={gen} -> {tuple(out.shape)} in {dt:.2f}s "
                  f"({batch * gen / dt:.1f} tok/s); prefill "
                  f"{1e3 * st['prefill_s']:.3f} ms, decode "
                  f"{decode_ms:.3f} ms/step")
        times.append((1e3 * st["prefill_s"], decode_ms))
    if mesh is not None and lead:
        lay = model.cache_layout(batch, prompt_len + gen)
        print(f"caches a rank: {lay.bytes} bytes (one process: "
              f"{lay.whole_bytes}; forms {sorted(set(lay.forms) - {None})}, "
              f"state cuts {sorted(set(lay.dims) - {()})})")
    clear_step_cache(model)        # the model's last user: free its steps
    if repeat > 1 and lead:
        warm = times[1:]
        print(f"median of runs 2-{repeat}: prefill "
              f"{statistics.median(t[0] for t in warm):.3f} ms, decode "
              f"{statistics.median(t[1] for t in warm):.3f} ms/step")
    if stats is not None:
        stats.update(st)
    if lead:
        print("sample continuation ids:",
              out[0, prompt_len:prompt_len + 16].tolist())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="1x1", type=mesh_lib.mesh_cli_arg,
                    help="DxM data×model mesh of ranks (D·M processes, "
                         "e.g. under torchrun)")
    ap.add_argument("--backend", default="nccl", choices=mesh_lib.BACKENDS,
                    help="process-group backend of a mesh run started "
                         "here (torchrun): nccl (one card per rank) or "
                         "gloo (ranks sharing a card, or the CPU)")
    ap.add_argument("--dispatch", default=None, type=dispatch_cli_arg,
                    help="MoE dispatch mode override (sort|grouped)")
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
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--repeat", type=int, default=1,
                    help="serve the same prompts this many times")
    args = ap.parse_args(argv)
    if args.repeat < 1:
        ap.error(f"--repeat must be >= 1, got {args.repeat}")
    if len(args.mesh) != 2:
        ap.error(f"--mesh must be DxM, got {'x'.join(map(str, args.mesh))}")
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
        run(args.arch, smoke=args.smoke, batch=args.batch,
            prompt_len=args.prompt_len, gen=args.gen,
            temperature=args.temperature, seed=args.seed,
            dispatch=args.dispatch, device=args.device, repeat=args.repeat,
            mesh_shape=args.mesh, tune=args.tune, fabric=args.fabric)
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
