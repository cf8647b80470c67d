"""Deterministic fault injection — the port of ``repro/core/faults.py``.

Production MoE training lives with preemptions, flaky NICs, and
numerically unstable bf16 steps; every guard (skip-step, crash-safe
checkpointing) must therefore be *provable under test*.  This module is
the single source of injected faults: seeded, config-addressable fault
**sites** — named seams instrumented in the production code paths — that
fire deterministically at chosen step/uid indices, never randomly at run
time.  The plan, its parsing, the host seams and the file corruption are
the reference's, with the same seeded numpy draws, so ``inject_array``
and ``corrupt_file`` give the reference's bytes.

A :class:`FaultPlan` maps site names to :class:`FaultSpec`\\ s.  Sites in
use today:

====================================  =======================================
site                                  seam (who calls it, with what index)
====================================  =======================================
``train.activations``                 traced: hidden states before the CE
                                      loss (``make_train_step``, step)
``train.loss``                        traced: the scalar loss (step)
``train.grads``                       traced: every grad leaf after the
                                      (possibly accumulated) backward (step)
``train.loop``                        host: top of the training loop
                                      (``launch/train.py``, step) — ``raise``
                                      / ``kill`` simulate preemption
``ckpt.data_tmp_written``             host: checkpoint tmp file written +
                                      fsynced, before ``os.replace`` (step)
``ckpt.data_replaced``                host: ``.npz`` in place, manifests not
                                      yet written (step)
``ckpt.manifest_step_written``        host: per-step manifest written,
                                      ``manifest.json`` not yet updated (step)
``serve.prefill``                     host: before a request's prefill
                                      (``serving/scheduler.SlotServer``,
                                      request uid) — ``raise`` = prefill
                                      blows up
``serve.prefill_logits``              host: the request's prefill logits
                                      (uid) — ``nan``/``inf`` = poisoned
``serve.step_logits``                 host: one slot's decode logits (uid)
``serve.step``                        host: before each batched decode step
                                      (decode-step counter) — ``stall``
                                      simulates a step-time stall
``serve.decode_row``                  host: the batched decode logits as a
                                      decode step returns them
                                      (``serving/engine.DecodeStep``, after
                                      the graph replay; decode-step
                                      counter) — ``nan``/``inf`` poisons ONE
                                      seeded element, i.e. one slot's row
====================================  =======================================

The ``serve.*`` seams pull logits to the host only when a plan is active;
without one the logits stay on the device (a ``SlotServer`` step copies
each row's argmax and finiteness, 2·slots values).

Two delivery mechanisms:

* **Traced** (:func:`traced_factor`): a 0-d tensor on the step's device
  that is ``1.0`` except at the spec'd step values, where it is NaN/Inf —
  multiplied into the tensors at the seam.  The firing test is
  ``torch.isin`` of the device step counter against a steps tensor built
  once per plan and device, so it never makes the host wait; a missing
  site (or no plan) returns ``None`` and adds no op.
* **Host** (:func:`crash_point`, :func:`inject_array`,
  :func:`maybe_stall`): consult the *ambient* plan installed with
  :func:`active`; no-ops when no plan is active, so the seams cost
  nothing in production.

File-corruption helpers (:func:`corrupt_file`) are plain deterministic
utilities — tests call them directly on checkpoint files to exercise the
fallback-restore path.
"""
from __future__ import annotations

import contextlib
import os
import signal
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib


class FaultInjected(RuntimeError):
    """Raised by a ``raise``-mode fault site (simulated crash/poison)."""


@dataclass(frozen=True)
class FaultSpec:
    """When and how one fault site fires.

    ``steps`` are the index values (train step, request uid, decode-step
    counter — whatever the seam passes) at which the site fires;
    ``always=True`` fires at every index.  ``mode``:

    * ``nan`` / ``inf`` — poison the value at the seam
    * ``raise``         — raise :class:`FaultInjected` (in-process crash)
    * ``kill``          — SIGKILL the process (real crash; subprocess tests)
    * ``stall``         — sleep ``stall_s`` seconds (simulated slow step)
    """
    steps: Tuple[int, ...] = ()
    mode: str = "nan"
    always: bool = False
    stall_s: float = 0.05

    MODES = ("nan", "inf", "raise", "kill", "stall")

    def __post_init__(self):
        if self.mode not in self.MODES:
            raise ValueError(f"FaultSpec.mode={self.mode!r} not in {self.MODES}")


@dataclass
class FaultPlan:
    """A seeded set of fault sites.  ``fired`` records (site, index) hits
    so tests can assert a guard was actually exercised."""
    sites: Dict[str, FaultSpec] = field(default_factory=dict)
    seed: int = 0
    fired: List[Tuple[str, int]] = field(default_factory=list)
    # (site, device) -> the site's steps as a device tensor (traced seams)
    _steps_tensors: Dict[Tuple[str, str], torch.Tensor] = field(
        default_factory=dict, repr=False, compare=False)

    def spec(self, site: str) -> Optional[FaultSpec]:
        return self.sites.get(site)

    def fires(self, site: str, index: int = 0) -> Optional[FaultSpec]:
        """The spec if ``site`` fires at ``index`` (recording the hit)."""
        sp = self.sites.get(site)
        if sp is None or not (sp.always or index in sp.steps):
            return None
        self.fired.append((site, index))
        return sp


def plan_from_specs(specs: Sequence[str], seed: int = 0) -> FaultPlan:
    """Parse CLI-style fault specs: ``site:mode@step[,step...]`` (or
    ``site:mode@*`` for every index), e.g.
    ``train.grads:nan@3`` or ``ckpt.data_tmp_written:kill@20``."""
    sites: Dict[str, FaultSpec] = {}
    for raw in specs:
        try:
            site, rest = raw.split(":", 1)
            mode, at = rest.split("@", 1)
        except ValueError:
            raise ValueError(
                f"fault spec {raw!r} is not 'site:mode@steps' "
                f"(e.g. 'train.grads:nan@3' or 'serve.step:stall@*')")
        if at.strip() == "*":
            sites[site] = FaultSpec(mode=mode, always=True)
        else:
            steps = tuple(int(s) for s in at.split(",") if s.strip())
            sites[site] = FaultSpec(steps=steps, mode=mode)
    return FaultPlan(sites=sites, seed=seed)


# ---------------------------------------------------------------------------
# ambient (host-side) plan
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultPlan] = None


def get_active() -> Optional[FaultPlan]:
    return _ACTIVE


@contextlib.contextmanager
def active(plan: Optional[FaultPlan]):
    """Install ``plan`` as the ambient plan for host-side seams."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, plan
    try:
        yield plan
    finally:
        _ACTIVE = prev


def crash_point(site: str, index: int = 0) -> None:
    """Host seam: raise / SIGKILL here if the ambient plan says so."""
    plan = _ACTIVE
    sp = plan.fires(site, index) if plan is not None else None
    if sp is None:
        return
    if sp.mode == "raise":
        raise FaultInjected(f"injected crash at {site}[{index}]")
    if sp.mode == "kill":
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_stall(site: str, index: int = 0) -> None:
    """Host seam: sleep if a ``stall`` fault fires (simulated slow step)."""
    plan = _ACTIVE
    sp = plan.fires(site, index) if plan is not None else None
    if sp is not None and sp.mode == "stall":
        time.sleep(sp.stall_s)


def inject_array(site: str, x, index: int = 0) -> np.ndarray:
    """Host seam: return ``x`` (as numpy) with one seeded element poisoned
    if the ambient plan fires ``site`` at ``index``; else ``x`` unchanged."""
    plan = _ACTIVE
    arr = np.asarray(x)
    sp = plan.fires(site, index) if plan is not None else None
    if sp is None or sp.mode not in ("nan", "inf"):
        return arr
    out = np.array(arr, copy=True)
    flat = out.reshape(-1)
    rng = np.random.default_rng((plan.seed, abs(hash(site)) % 2**31, index))
    pos = int(rng.integers(flat.size)) if flat.size else 0
    if flat.size:
        flat[pos] = np.nan if sp.mode == "nan" else np.inf
    return out


# ---------------------------------------------------------------------------
# traced (device-side) injection
# ---------------------------------------------------------------------------

def _steps_tensor(plan: FaultPlan, site: str, sp: FaultSpec, device):
    """``sp.steps`` as an int32 tensor on ``device``, built once per plan,
    site and device out of on-device fills (no host-to-device copy)."""
    cache = plan._steps_tensors
    key = (site, str(device))
    if key not in cache:
        cache[key] = torch.stack([
            torch.full((), s, dtype=torch.int32, device=device)
            for s in sp.steps])
    return cache[key]


def traced_factor(plan: Optional[FaultPlan], site: str, step):
    """A 0-d f32 multiplier on ``step``'s device: 1.0 except at the spec'd
    step values, where it is NaN (``nan`` mode) or Inf (``inf``).  Returns
    None when the site is absent so callers can skip the multiply (keeps
    un-faulted steps bitwise identical)."""
    if plan is None:
        return None
    sp = plan.sites.get(site)
    if sp is None or sp.mode not in ("nan", "inf"):
        return None
    bad = float("nan") if sp.mode == "nan" else float("inf")
    if sp.always:
        return torch.full((), bad, dtype=torch.float32, device=step.device)
    if not sp.steps:
        return None
    fire = torch.isin(step.to(torch.int32),
                      _steps_tensor(plan, site, sp, step.device))
    return torch.where(fire, bad, 1.0).to(torch.float32)


def apply_traced(plan: Optional[FaultPlan], site: str, step, tree):
    """Multiply every leaf of ``tree`` (a tensor, or nested dicts/lists of
    tensors) by :func:`traced_factor` (no-op — and no inserted ops — when
    the site is absent)."""
    f = traced_factor(plan, site, step)
    if f is None:
        return tree
    return tree_lib.map_(lambda x: x * f.to(x.dtype), tree)


# ---------------------------------------------------------------------------
# file corruption (checkpoint fault utilities)
# ---------------------------------------------------------------------------

def corrupt_file(path: str, *, mode: str = "truncate", seed: int = 0,
                 nbytes: int = 16) -> None:
    """Deterministically damage a file in place.  ``truncate`` cuts it to
    half size (a torn write); ``bitflip`` XOR-flips ``nbytes`` seeded
    bytes (bit rot / bad NIC DMA)."""
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))
        return
    if mode == "bitflip":
        rng = np.random.default_rng((seed, size))
        with open(path, "r+b") as f:
            for off in rng.integers(0, max(size, 1), size=nbytes):
                f.seek(int(off))
                b = f.read(1)
                if not b:
                    continue
                f.seek(int(off))
                f.write(bytes([b[0] ^ 0xFF]))
        return
    raise ValueError(f"corrupt_file mode={mode!r} not in ('truncate', 'bitflip')")
