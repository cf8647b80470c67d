"""Tour of all 8 gating strategies (paper Fig. 2) in the PyTorch port —
the twin of ``examples/gating_tour.py``.

Routes the same tokens through every strategy and prints the per-expert
load profile + drop rate under a fixed capacity, making the balance
trade-offs (greedy switch vs structurally-balanced BASE vs hash, etc.)
visible side by side.

  PYTHONPATH=src python examples/torch_gating_tour.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import capacity, gating, layout
from repro_torch.core.config import MoEConfig

STRATEGIES = [
    ("switch", dict()),
    ("gshard", dict()),
    ("topk", dict(top_k=2)),
    ("ktop1", dict(num_prototypes=2)),
    ("sam", dict(num_groups=4, top_k=2)),
    ("base", dict()),
    ("hash", dict()),
    ("dense_to_sparse", dict(top_k=2, gumbel_temperature=0.5)),
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the gates run (default cuda)")
    dev = resolve_device(ap.parse_args(argv).device)
    S, E = 512, 8
    gen = torch.Generator(device=dev).manual_seed(0)
    # mildly skewed router inputs — the realistic hard case for balance
    logits = (torch.randn((S, E), generator=gen, device=dev)
              + torch.linspace(1.0, 0.0, E, device=dev)[None, :])
    token_ids = torch.randint(0, 50000, (S,), generator=gen, device=dev)

    print(f"{'strategy':18s} {'k':>2s} "
          f"{'load per expert (of {:d} tokens)'.format(S):40s} "
          f"{'drop%':>6s}")
    for name, kw in STRATEGIES:
        cfg = MoEConfig(num_experts=E, gate=name, capacity_factor=1.25, **kw)
        noise = gating.draw_noise(cfg, (S, E), gen, device=dev)
        out = gating.route(cfg, logits, noise=noise, token_ids=token_ids)
        k = gating.gate_k(cfg)
        C = capacity.expert_capacity(cfg, S, E)
        plan = layout.plan_sort(out, E, C)
        counts = np.bincount(out.expert_index.cpu().numpy().ravel(),
                             minlength=E)
        dropped = float((plan.slot < 0).float().mean()) * 100
        print(f"{name:18s} {k:2d} {str(counts.tolist()):40s} {dropped:5.1f}%")


if __name__ == "__main__":
    main()
