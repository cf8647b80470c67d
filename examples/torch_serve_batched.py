"""Batched serving in the PyTorch port: prefill a batch of prompts, then
decode step by step with a shared batched KV cache — the eager steps of
``serving/engine.py`` driven end to end, the twin of
``examples/serve_batched.py``.

  PYTHONPATH=src python examples/torch_serve_batched.py [--arch dbrx-132b] \
      [--device cpu]
"""
import argparse
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.models.transformer import Transformer
from repro_torch.serving.engine import make_prefill_step, make_serve_step


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dbrx-132b",
                    help="any assigned arch id (reduced smoke variant used)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the model runs (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.smoke_config(args.arch)
    assert cfg.has_decode, f"{args.arch} is encoder-only"
    model = Transformer(cfg, device=dev, seed=0)
    cache_len = args.prompt_len + args.gen

    prefill = make_prefill_step(cfg, cache_len=cache_len)
    step = make_serve_step(cfg)

    # a batch of "requests" (synthetic prompts of equal length; ragged
    # batching would left-pad and mask — same cache machinery)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(0))
    t0 = time.time()
    logits, caches = prefill(model, prompts)
    _sync(dev)
    t_prefill = time.time() - t0

    toks = []
    t0 = time.time()
    tok = logits[:, -1].argmax(-1)[:, None]
    for _ in range(args.gen):
        toks.append(tok)
        logits, caches = step(model, tok, caches)
        tok = logits[:, -1].argmax(-1)[:, None]
    _sync(dev)
    t_decode = time.time() - t0

    out = torch.cat(toks, dim=1)
    print(f"arch={cfg.name}  batch={args.batch}")
    print(f"prefill {args.prompt_len} toks: {t_prefill*1e3:.1f} ms")
    print(f"decode  {args.gen} steps: {t_decode*1e3:.1f} ms "
          f"({args.batch*args.gen/t_decode:.1f} tok/s batched)")
    print("continuations[0]:", out[0].tolist())


if __name__ == "__main__":
    main()
