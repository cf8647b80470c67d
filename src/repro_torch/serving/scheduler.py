"""Continuous-batching serving scheduler (slot-based) with overload
degradation — the port of ``repro/serving/scheduler.py``.

A fixed-size slot pool over ONE cached decode step
(``engine.build_decode``: a captured CUDA graph on ``cuda``, static
shapes): arriving requests claim free slots through a per-slot prefill
(``engine.build_slot_prefill``) whose single-row caches are copied into
the step's batched caches (``engine.put_slot``); finished or evicted
slots are refilled mid-flight, and the hot decode loop never builds or
captures anything.  The server holds its step's caches while it lives
(``build_decode(owner=)``): a second live server of the same key gets
its own instance of the step, and a later one reuses the first's.

Fault tolerance / overload degradation, as the reference:

* **admission**: requests are validated up front (prompt length against
  ``cache_len``, token range against the vocab, ``max_new``) and rejected
  with a structured status instead of writing past their slot's cache;
* **backpressure**: a bounded admission queue (``queue_limit``) rejects
  with ``status="rejected", error="queue_full"`` once full;
* **poisoned-request containment**: a prefill that raises or yields
  non-finite logits marks THAT request ``failed`` and frees the slot
  without committing its cache writes; a slot whose decode logits go
  non-finite is likewise failed and freed while the rest of the batch
  keeps decoding;
* **deadlines**: ``Request.deadline_steps`` (or the server-wide
  ``default_deadline_steps``) evicts a request after that many decode
  steps.

Aligned refill: the caches carry ONE position shared by every slot (a 0-d
device tensor per layer, mirrored on the host as ``_pos``), and a prefill
sets it to the new prompt's length, so a queued request is prefilled only
when no slot is active or its prompt length equals the current shared
position; the queue is scanned first-fit.  The shared position is the
reference's (per-slot positions would be a feature it lacks).  The host
mirror refuses a decode step past the end of a linear cache.

Per step the reference copies the whole (slots, V) logits to the host.
Here each row's argmax (the first maximum, as ``np.argmax``) and
finiteness are read on the device and 2·slots values are copied; with an
ambient fault plan the whole rows are pulled, so that
``serve.step_logits`` poisons what the reference's poisons.

Fault-injection seams (``core/faults.py``): ``serve.prefill`` /
``serve.prefill_logits`` (indexed by request uid), ``serve.step_logits``
(uid), ``serve.step`` (decode-step counter; ``stall`` simulates a slow
step — deadlines count steps, not seconds), and ``serve.decode_row``
(decode-step counter), delivered inside the decode step
(``engine.DecodeStep``).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import faults as faults_mod
from repro_torch.serving import engine

# terminal request statuses (Request.done=True implies one of these)
TERMINAL_STATUSES = ("ok", "rejected", "failed", "evicted")


@dataclass
class Request:
    uid: int
    prompt: torch.Tensor             # (S,) token ids
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False
    status: str = "pending"          # pending|queued|active|ok|rejected|failed|evicted
    error: Optional[str] = None      # structured rejection/failure reason
    deadline_steps: Optional[int] = None  # decode-step budget (None = server default)
    steps_used: int = 0              # decode steps consumed while active


def _read_rows(rows: torch.Tensor, site: str,
               uids: List[int]) -> List[Tuple[bool, int]]:
    """(finite, argmax) of each row of (n, V) logits, row i under the
    ``site`` fault index ``uids[i]``.  Without an ambient plan both are
    read on the device and 2·n values copied; with one the rows are pulled
    whole and poisoned on the host (``faults.inject_array``)."""
    if faults_mod.get_active() is None:
        both = torch.stack([torch.isfinite(rows).all(-1).long(),
                            rows.argmax(-1)]).cpu().tolist()
        return [(bool(f), int(t)) for f, t in zip(*both)]
    out = []
    for row, uid in zip(rows.float().cpu().numpy(), uids):
        row = faults_mod.inject_array(site, row, index=uid)
        out.append((bool(np.all(np.isfinite(row))), int(np.argmax(row))))
    return out


class SlotServer:
    """Fixed-slot continuous batching over one cached decode step.

    ``model`` is a ``models.transformer.Transformer``; ``graph=False``
    serves through the same step run eagerly (for comparison; the default
    across ranks, ``engine.decode_graph``).  A model with a mesh (the
    reference's ``mesh=``) is served by one server per rank, every rank
    given the same requests in the same order: admission, prefills, the
    fault seams and every decode step run alike on all of them, so their
    collectives match, and each reads the same tokens from logits that
    are bitwise equal on every rank."""

    @torch.inference_mode()
    def __init__(self, model, *, slots: int, cache_len: int,
                 eos_id: Optional[int] = None,
                 queue_limit: Optional[int] = None,
                 default_deadline_steps: Optional[int] = None,
                 dispatch: Optional[str] = None,
                 graph: Optional[bool] = None):
        cfg = model.cfg
        if not cfg.has_decode or cfg.frontend is not None:
            raise ValueError(
                f"SlotServer serves token prompts through decode steps: "
                f"{cfg.name} is encoder-only or takes a {cfg.frontend} "
                f"frontend's embeddings")
        if queue_limit is not None and queue_limit < 1:
            raise ValueError(
                f"SlotServer queue_limit must be >= 1 or None (unbounded), "
                f"got {queue_limit}")
        cfg = engine.serve_config(cfg, dispatch=dispatch)
        # fail HERE, at server construction, not at the first decode step
        engine.validate_decode_config(cfg, slots, cache_len=cache_len,
                                      mesh=model.mesh)
        self.cfg, self.model = cfg, model
        self.slots = slots
        self.cache_len = cache_len
        self.eos_id = eos_id
        self.queue_limit = queue_limit
        self.default_deadline_steps = default_deadline_steps
        self.active: Dict[int, Request] = {}          # slot → request
        self.queue: Deque[Request] = deque()          # admitted, awaiting a slot
        self.tokens = torch.zeros((slots, 1), dtype=torch.long)
        self._decode_steps = 0
        self._pos = 0            # host mirror of the caches' shared position
        # steps from the shared builder cache: a later server over the same
        # (model, cfg, cache_len, slots) reuses the captured step, a server
        # alive beside this one gets another instance of it
        self._step = engine.build_decode(model, cfg, batch=slots,
                                         cache_len=cache_len, graph=graph,
                                         owner=self)
        self._step.reset()
        self._prefill = engine.build_slot_prefill(model, cfg,
                                                  cache_len=cache_len)

    @property
    def caches(self):
        """The decode step's batched caches, one per layer."""
        return self._step.caches

    # -- validation / admission ---------------------------------------------
    def _validate(self, req: Request) -> Optional[str]:
        """Structured rejection reason, or None if admissible."""
        n = int(req.prompt.shape[-1]) if req.prompt.ndim else 0
        if req.prompt.ndim != 1 or n < 1:
            return f"bad_prompt_shape:{tuple(req.prompt.shape)}"
        # prefill writes n cache rows and every decode step writes one
        # more; n > cache_len - 1 would write past the slot's cache
        if n > self.cache_len - 1:
            return f"prompt_too_long:{n}>cache_len-1={self.cache_len - 1}"
        lo, hi = int(req.prompt.min()), int(req.prompt.max())
        if lo < 0 or hi >= self.cfg.vocab_size:
            return (f"token_out_of_range:[{lo},{hi}]∉[0,"
                    f"{self.cfg.vocab_size})")
        if req.max_new < 1:
            return f"bad_max_new:{req.max_new}"
        return None

    def _reject(self, req: Request, reason: str) -> None:
        req.status, req.error, req.done = "rejected", reason, True

    def enqueue(self, req: Request) -> bool:
        """Admit into the bounded queue.  False = terminally rejected
        (validation failure, or backpressure when the queue is full)."""
        reason = self._validate(req)
        if reason is not None:
            self._reject(req, reason)
            return False
        if self.queue_limit is not None and len(self.queue) >= self.queue_limit:
            self._reject(req, "queue_full")
            return False
        req.status = "queued"
        self.queue.append(req)
        return True

    def _aligned(self, req: Request) -> bool:
        """True when prefilling ``req`` now cannot corrupt in-flight
        slots: either no slot is active (the shared position resets
        cleanly) or the prompt length equals the current shared position
        (the reset is a no-op)."""
        return not self.active or int(req.prompt.shape[-1]) == self._pos

    @torch.inference_mode()
    def _admit(self, req: Request, slot: int) -> bool:
        """Prefill into ``slot``.  A prefill that raises or yields
        non-finite logits fails the request WITHOUT committing its cache
        writes (the slot stays clean for the next request).  True = the
        slot is now occupied."""
        try:
            faults_mod.crash_point("serve.prefill", index=req.uid)
            logits, sub = self._prefill(req.prompt[None, :])
            [(finite, tok)] = _read_rows(logits[None], "serve.prefill_logits",
                                         [req.uid])
            if not finite:
                raise faults_mod.FaultInjected("non-finite prefill logits")
        except Exception as e:  # containment: poisoned request, not the server
            req.status, req.error, req.done = "failed", f"prefill:{e}", True
            return False
        engine.put_slot(self._step.caches, sub, slot)
        self._pos = int(req.prompt.shape[-1])
        self.tokens[slot, 0] = tok
        req.out.append(tok)
        req.status = "active"
        self.active[slot] = req
        return True

    # -- public API ---------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Claim a free slot directly.  False = no slot can take the
        request right now (pool full, or refill not aligned — retry
        later); True = the request was consumed: admitted, or terminally
        rejected/failed (check ``req.status``)."""
        reason = self._validate(req)
        if reason is not None:
            self._reject(req, reason)
            return True
        if not self._aligned(req):
            return False
        for s in range(self.slots):
            if s not in self.active:
                self._admit(req, s)   # failed prefill still consumes req
                return True
        return False

    def pump(self) -> List[Request]:
        """Move queued requests into free slots (first-fit over the queue
        — only alignment-safe refills, see ``_aligned``); returns
        requests that terminally failed during prefill."""
        failed = []
        for s in range(self.slots):
            if s in self.active:
                continue
            for req in list(self.queue):
                if not self._aligned(req):
                    continue
                self.queue.remove(req)
                if self._admit(req, s):
                    break
                failed.append(req)
        return failed

    def _deadline(self, req: Request) -> Optional[int]:
        return (req.deadline_steps if req.deadline_steps is not None
                else self.default_deadline_steps)

    @torch.inference_mode()
    def step(self) -> List[Request]:
        """One batched decode step for every active slot; returns newly
        finished requests — ok, failed (non-finite logits) or evicted
        (deadline) — with their slots freed."""
        if not self.active:
            return []
        cap = self._step.capacity
        if cap is not None and self._pos >= cap:
            raise ValueError(f"cache of {cap} positions is full at "
                             f"pos={self._pos}")
        faults_mod.maybe_stall("serve.step", index=self._decode_steps)
        logits = self._step(self.tokens, step_index=self._decode_steps)
        self._decode_steps += 1
        self._pos += 1
        slots = list(self.active)
        rows = _read_rows(logits[slots, -1], "serve.step_logits",
                          [self.active[s].uid for s in slots])
        finished = []
        for s, (finite, tok) in zip(slots, rows):
            req = self.active[s]
            req.steps_used += 1
            if not finite:
                # poisoned mid-decode: fail THIS request, free the slot —
                # its cache line is overwritten by the next prefill, so the
                # other slots never see the damage
                req.status, req.error, req.done = \
                    "failed", "non_finite_decode_logits", True
                finished.append(req)
                del self.active[s]
                continue
            self.tokens[s, 0] = tok
            req.out.append(tok)
            dl = self._deadline(req)
            if len(req.out) >= req.max_new or (self.eos_id is not None
                                               and tok == self.eos_id):
                req.status, req.done = "ok", True
                finished.append(req)
                del self.active[s]
            elif dl is not None and req.steps_used >= dl:
                req.status, req.error, req.done = "evicted", "deadline", True
                finished.append(req)
                del self.active[s]
        return finished

    def run(self, requests: List[Request]) -> List[Request]:
        """Drive a request list to completion with continuous refill.
        Returns EVERY request once terminal (``ok``/``rejected``/
        ``failed``/``evicted``) — a mixed workload with oversized or
        poisoned requests still drains the healthy ones."""
        pending = list(requests)
        done: List[Request] = []
        while pending or self.queue or self.active:
            # feed with backpressure: only hand the queue what it has room
            # for, so a huge batch never trips its own queue_limit
            while pending and (self.queue_limit is None
                               or len(self.queue) < self.queue_limit):
                req = pending.pop(0)
                if not self.enqueue(req):
                    done.append(req)          # validation rejection
            done += self.pump()               # prefill failures
            done += self.step()
        return done
