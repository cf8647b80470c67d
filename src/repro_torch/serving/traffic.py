"""Seeded workload-replay harness for the slot-based serving scheduler —
the port of ``repro/serving/traffic.py``.

Replays a *deterministic, seeded* workload against a ``SlotServer`` and
reports the serving numbers that matter: p50/p99 per-token latency,
time to the first token, and slot utilization.

Everything is reproducible from ``TrafficConfig.seed``, with the
reference's numpy draws, so a workload is the reference's bitwise
(arrivals, lengths, prompt ids as int64 tensors):

* **arrivals** — ``"poisson"`` draws exponential inter-arrival gaps
  (mean ``1/rate`` decode steps); ``"bursty"`` releases requests in
  bursts of ``burst_size`` every ``burst_every`` steps (the
  queue-pressure worst case for a fixed slot pool);
* **shapes** — prompt lengths and output budgets are drawn per request
  from ``prompt_lens`` / ``max_new_choices``;
* **skew** — :func:`skew_router` biases every MoE router toward one
  expert (adds a large constant to that expert's logit column), the
  adversarial hot-expert distribution.  It returns a new model (or
  tree), so one model serves both the uniform and the skewed scenario.

The replay clock is the decode-step counter, not wall time — arrivals
are keyed to steps so the workload is identical across machines — while
the reported latencies are wall-clock (what a user would see on this
host; each step ends in a host copy of its tokens, so they include the
device's time).  Per-token latency for a request is (completion −
arrival) / tokens produced; utilization is the mean over decode steps of
active slots / slots.  Requests that terminate without producing tokens
(rejections, failed prefills) are counted in the report but excluded from
the latency percentiles.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.config import ModelConfig
from repro_torch.models.transformer import Transformer
from repro_torch.serving.scheduler import Request, SlotServer


@dataclass(frozen=True)
class TrafficConfig:
    """One seeded traffic scenario."""
    num_requests: int = 16
    arrival: str = "poisson"            # "poisson" | "bursty"
    rate: float = 0.5                   # poisson: mean arrivals per decode step
    burst_size: int = 4                 # bursty: requests per burst
    burst_every: int = 8                # bursty: steps between bursts
    prompt_lens: Tuple[int, ...] = (4, 6, 8)
    max_new_choices: Tuple[int, ...] = (3, 5, 8)
    seed: int = 0

    ARRIVALS = ("poisson", "bursty")

    def __post_init__(self):
        if self.arrival not in self.ARRIVALS:
            raise ValueError(
                f"TrafficConfig.arrival={self.arrival!r} not in "
                f"{self.ARRIVALS}")
        if self.num_requests < 1:
            raise ValueError(
                f"TrafficConfig.num_requests must be >= 1, got "
                f"{self.num_requests}")


@dataclass
class TrafficReport:
    """Replay outcome.  Latencies in wall-clock seconds; the step counts
    are the deterministic (machine-independent) shape of the run."""
    completed: int = 0
    rejected: int = 0
    failed: int = 0
    evicted: int = 0
    decode_steps: int = 0
    p50_per_token_s: float = float("nan")
    p99_per_token_s: float = float("nan")
    p50_first_token_s: float = float("nan")
    p99_first_token_s: float = float("nan")
    slot_utilization: float = 0.0
    tokens_out: int = 0
    wall_s: float = 0.0
    statuses: Dict[int, str] = field(default_factory=dict)

    def summary(self) -> str:
        return (f"completed={self.completed} rejected={self.rejected} "
                f"failed={self.failed} evicted={self.evicted} "
                f"steps={self.decode_steps} util={self.slot_utilization:.2f} "
                f"p50/tok={self.p50_per_token_s * 1e3:.2f}ms "
                f"p99/tok={self.p99_per_token_s * 1e3:.2f}ms")


def synthesize_workload(tc: TrafficConfig, cfg: ModelConfig
                        ) -> List[Tuple[int, Request]]:
    """Deterministic ``[(arrival_step, Request)]``, sorted by arrival.
    Token ids draw uniformly from the model vocab; the same
    ``(TrafficConfig, vocab)`` always yields the same workload."""
    rng = np.random.default_rng(tc.seed)
    arrivals: List[int] = []
    if tc.arrival == "poisson":
        t = 0.0
        for _ in range(tc.num_requests):
            t += rng.exponential(1.0 / max(tc.rate, 1e-6))
            arrivals.append(int(t))
    else:                               # bursty
        step = 0
        while len(arrivals) < tc.num_requests:
            n = min(tc.burst_size, tc.num_requests - len(arrivals))
            arrivals.extend([step] * n)
            step += tc.burst_every
    out = []
    for uid, at in enumerate(arrivals):
        n = int(rng.choice(tc.prompt_lens))
        prompt = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int64))
        req = Request(uid=uid, prompt=prompt,
                      max_new=int(rng.choice(tc.max_new_choices)))
        out.append((at, req))
    out.sort(key=lambda p: p[0])
    return out


def skew_router(params, bias: float = 16.0, expert: int = 0):
    """Adversarially skew every MoE router toward ``expert`` by adding
    ``bias`` to that expert's logit column, in the router's own dtype
    (gate logits are O(1) at init, so 16 wins every top-k comparison).
    ``params`` is a :class:`Transformer` or a parameter tree; returns a
    new one (a model shares every other weight with its input) and
    leaves the input untouched."""

    def walk(p):
        if isinstance(p, dict):
            out = {}
            for k, v in p.items():
                if k == "moe" and isinstance(v, dict) and "gate_w" in v:
                    gw = v["gate_w"].detach().clone()
                    gw[..., expert] += torch.tensor(bias, dtype=gw.dtype)
                    v = {**v, "gate_w": gw}
                else:
                    v = walk(v)
                out[k] = v
            return out
        if isinstance(p, (tuple, list)):
            return type(p)(walk(v) for v in p)
        return p

    if not isinstance(params, Transformer):
        return walk(params)
    model = params
    return Transformer(model.cfg, device=model.device,
                       params=walk(model.tree()), mesh=model.mesh)


def replay(server: SlotServer, workload: List[Tuple[int, Request]],
           *, max_steps: int = 10_000) -> TrafficReport:
    """Drive ``server`` through ``workload``.

    The loop advances one decode step per iteration (idle iterations —
    nothing active yet — still advance the arrival clock, modeling the
    server waiting for traffic).  Admission reuses the server's bounded
    queue and alignment-gated refill; rejected requests are final.
    """
    pending = list(workload)
    arrival_wall: Dict[int, float] = {}
    first_tok_wall: Dict[int, float] = {}
    done: List[Request] = []
    util_samples: List[float] = []
    t_start = time.perf_counter()
    step = 0
    while pending or server.queue or server.active:
        if step >= max_steps:
            raise RuntimeError(
                f"traffic replay exceeded max_steps={max_steps} "
                f"({len(pending)} pending, {len(server.queue)} queued, "
                f"{len(server.active)} active)")
        while pending and pending[0][0] <= step:
            _, req = pending.pop(0)
            arrival_wall[req.uid] = time.perf_counter()
            if not server.enqueue(req):
                done.append(req)        # validation / queue_full rejection
        had_first = {r.uid for r in server.active.values() if r.out}
        done += server.pump()
        now = time.perf_counter()
        for r in server.active.values():
            # prefill emits the first token; stamp it once
            if r.out and r.uid not in had_first and r.uid not in first_tok_wall:
                first_tok_wall[r.uid] = now
        util_samples.append(len(server.active) / server.slots)
        finished = server.step()
        now = time.perf_counter()
        for r in finished:
            r._finish_wall = now        # stashed for the percentile pass
        done += finished
        step += 1

    rep = TrafficReport(decode_steps=step, wall_s=time.perf_counter() - t_start)
    per_tok, first = [], []
    for r in done:
        rep.statuses[r.uid] = r.status
        rep.tokens_out += len(r.out)
        if r.status == "ok":
            rep.completed += 1
        elif r.status == "rejected":
            rep.rejected += 1
        elif r.status == "failed":
            rep.failed += 1
        elif r.status == "evicted":
            rep.evicted += 1
        end = getattr(r, "_finish_wall", None)
        start = arrival_wall.get(r.uid)
        if r.out and start is not None and end is not None:
            per_tok.append((end - start) / len(r.out))
        if r.uid in first_tok_wall and start is not None:
            first.append(first_tok_wall[r.uid] - start)
    if per_tok:
        rep.p50_per_token_s = float(np.percentile(per_tok, 50))
        rep.p99_per_token_s = float(np.percentile(per_tok, 99))
    if first:
        rep.p50_first_token_s = float(np.percentile(first, 50))
        rep.p99_first_token_s = float(np.percentile(first, 99))
    if util_samples:
        rep.slot_utilization = float(np.mean(util_samples))
    return rep
