"""End-to-end driver in the PyTorch port: train an MoE language model on
synthetic data — the twin of ``examples/train_moe_e2e.py``.

Defaults are CPU-sized (~7M params, 200 steps, loss visibly falls).
``--hundred-m`` switches to a ~100M-param 16-expert model.

  PYTHONPATH=src python examples/torch_train_moe_e2e.py [--steps 200] \
      [--hundred-m] [--device cpu]
"""
import argparse

from repro_torch import configs, resolve_device
from repro_torch.core.config import (AttentionConfig, ModelConfig,
                                     MoEConfig)
from repro_torch.launch.train import run as train_run


def small_moe(hundred_m: bool) -> ModelConfig:
    if hundred_m:
        d, f, L, E, V = 512, 1024, 8, 16, 32000      # ≈100M params
    else:
        d, f, L, E, V = 128, 256, 4, 8, 2048         # ≈7M params (CPU)
    return ModelConfig(
        name="moe-e2e", family="moe", num_layers=L, d_model=d, d_ff=f,
        vocab_size=V, block_pattern=("dense", "moe"),
        attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=32),
        moe=MoEConfig(num_experts=E, top_k=1, gate="switch",
                      capacity_factor=1.5, dispatch="sort"),
        act="swiglu")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the model trains (default cuda)")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    cfg = small_moe(args.hundred_m)
    configs.ARCHS[cfg.name] = cfg          # register for the train driver
    try:
        state, history = train_run(cfg.name, steps=args.steps,
                                   batch=args.batch, seq=args.seq,
                                   smoke=False, lr=3e-3, mesh_shape=(1, 1),
                                   log_every=20, device=device)
    finally:
        del configs.ARCHS[cfg.name]
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'FELL ✓' if last < first - 0.3 else 'did not fall ✗'})")


if __name__ == "__main__":
    main()
