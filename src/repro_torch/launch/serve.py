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
warm-up and the capture of the decode step's CUDA graph).  Only the
one-device mesh ``1x1`` is ported.
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Optional

import torch

from repro_torch import configs, resolve_device
from repro_torch.models.transformer import Transformer
from repro_torch.serving.engine import (clear_step_cache, generate,
                                        refuse_frontend, serve_config,
                                        validate_dispatch)


def dispatch_cli_arg(name: str) -> str:
    try:
        return validate_dispatch(name)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))


def mesh_cli_arg(spec: str):
    if str(spec) != "1x1":
        raise argparse.ArgumentTypeError(
            f"--mesh {spec!r}: only the one-device mesh '1x1' is ported to "
            f"repro_torch (expert parallelism comes with the EP slice)")
    return (1, 1)


def run(arch: str, *, smoke: bool, batch: int, prompt_len: int, gen: int,
        temperature: float = 0.0, seed: int = 0,
        dispatch: Optional[str] = None, device=None,
        stats: Optional[dict] = None, repeat: int = 1) -> torch.Tensor:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens for ``gen``
    new tokens, ``repeat`` times; returns the (batch, prompt_len + gen)
    token ids of the last run.  ``stats`` (when given) receives the last
    run's ``generate`` timings."""
    cfg = configs.smoke_config(arch) if smoke else configs.get_config(arch)
    if not cfg.has_decode:
        raise ValueError(f"{arch} is encoder-only")
    refuse_frontend(cfg)
    cfg = serve_config(cfg, dispatch=dispatch)
    dev = resolve_device(device)
    moe = (f"dispatch={cfg.moe.dispatch} "
           f"({'flag' if dispatch else 'config default'}) "
           if cfg.moe is not None else "")
    print(f"{moe}device={dev}")
    model = Transformer(cfg, device=dev, seed=seed)
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
        print(f"arch={cfg.name} batch={batch} prompt={prompt_len} gen={gen} "
              f"-> {tuple(out.shape)} in {dt:.2f}s "
              f"({batch * gen / dt:.1f} tok/s); prefill "
              f"{1e3 * st['prefill_s']:.3f} ms, decode {decode_ms:.3f} "
              f"ms/step")
        times.append((1e3 * st["prefill_s"], decode_ms))
    clear_step_cache(model)        # the model's last user: free its steps
    if repeat > 1:
        warm = times[1:]
        print(f"median of runs 2-{repeat}: prefill "
              f"{statistics.median(t[0] for t in warm):.3f} ms, decode "
              f"{statistics.median(t[1] for t in warm):.3f} ms/step")
    if stats is not None:
        stats.update(st)
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
    ap.add_argument("--mesh", default="1x1", type=mesh_cli_arg)
    ap.add_argument("--dispatch", default=None, type=dispatch_cli_arg,
                    help="MoE dispatch mode override (sort|grouped)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--repeat", type=int, default=1,
                    help="serve the same prompts this many times")
    args = ap.parse_args(argv)
    if args.repeat < 1:
        ap.error(f"--repeat must be >= 1, got {args.repeat}")
    run(args.arch, smoke=args.smoke, batch=args.batch,
        prompt_len=args.prompt_len, gen=args.gen,
        temperature=args.temperature, seed=args.seed,
        dispatch=args.dispatch, device=args.device, repeat=args.repeat)


if __name__ == "__main__":
    main()
