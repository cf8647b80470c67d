"""Quickstart (the PyTorch port): the HetuMoE layer in one screen.

Builds the paper's 16-expert MoE layer and routes a batch of tokens
through every stage of Algorithm 1 (gate → layout transform → AllToAll →
experts → reverse transform) on an 8-way expert-parallel mesh (1x8):
eight rank processes over gloo (``launch/mesh.spawn``), with both flat and
hierarchical AllToAll — the twin of ``examples/quickstart.py``.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The ranks run on ``cuda`` (all eight sharing the card over gloo) unless
``--device cpu`` is given.
"""
import argparse

import numpy as np
import torch

from repro_torch import draw, resolve_device
from repro_torch.core import moe
from repro_torch.core.config import MoEConfig
from repro_torch.launch.mesh import make_mesh, spawn

SHAPE = (1, 8)                    # 8-way expert parallelism
D_MODEL, D_FF, E = 256, 512, 16


def layer_rank(rank, device):
    """Both AllToAll forms on this rank's block of the tokens: (y, aux,
    max_load) each, y as numpy."""
    mesh = make_mesh(SHAPE, device=device)
    n = E // SHAPE[1]
    out = {}
    for a2a in ("flat", "hierarchical"):
        cfg = MoEConfig(num_experts=E, gate="switch", capacity_factor=1.25,
                        a2a=a2a, a2a_inner=4)
        gen = torch.Generator(device=mesh.device).manual_seed(0)
        params = moe.init_moe_params(
            gen, cfg, D_MODEL, D_FF, E, act="swiglu", device=mesh.device,
            cut=lambda name, t: t[mesh.model_index * n:
                                  (mesh.model_index + 1) * n].contiguous())
        x = draw(gen, (4, 128, D_MODEL), 1.0, device=mesh.device)  # (B, S, d)
        xl, valid, _, _ = moe.rank_tokens(mesh, x)
        with torch.no_grad():
            y, aux, metrics = moe.sharded_moe_apply(
                mesh, cfg, params, xl, num_experts=E, act="swiglu",
                valid=valid)
        out[a2a] = (y.float().cpu().numpy(), float(aux),
                    float(metrics["expert_load_max"]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the ranks run (default cuda)")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    ranks = spawn(layer_rank, SHAPE[0] * SHAPE[1], backend="gloo",
                  args=(device,), threads=1)
    for a2a in ("flat", "hierarchical"):
        y = np.concatenate([r[a2a][0] for r in ranks]).reshape(4, 128,
                                                               D_MODEL)
        _, aux, load = ranks[0][a2a]
        print(f"a2a={a2a:13s} out={tuple(y.shape)} aux={aux:.4f} "
              f"max_load={load:.3f}")
        if a2a == "flat":
            y_flat = y
        else:
            np.testing.assert_allclose(y_flat, y, rtol=1e-5, atol=1e-6)
            print("flat == hierarchical ✓ (the paper's optimization is "
                  "semantics-preserving; the win is in message aggregation)")


if __name__ == "__main__":
    main()
