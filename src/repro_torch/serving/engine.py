"""Serving: prefill + batched single-token decode steps, built through
one step builder with a process-wide step cache — the port of
``repro/serving/engine.py``.

Step-builder / cache contract
-----------------------------

Every serving entry point (``generate`` here, ``SlotServer`` in
``serving/scheduler.py``, the ``launch/serve.py`` CLI) takes its steps
from the builders below:

* ``build_prefill(model, cfg, cache_len=, batch=, long_context=)`` —
  ``(tokens (B, S), caches) -> (last logits (B, 1, V), caches)``, the
  caches (the decode step's) filled in place; eager;
* ``build_decode(model, cfg, batch=, cache_len=, long_context=, graph=)``
  — a :class:`DecodeStep`, ``(token (B, 1), step_index=0) -> logits (B,
  1, V)`` over the caches it owns;
* ``build_slot_prefill(model, cfg, cache_len=, long_context=)`` —
  ``(prompt (1, S)) -> (last logits (V,), single-row caches)``, eager;
  :func:`put_slot` commits those into row ``slot`` of the decode step's
  caches (``SlotServer``'s per-slot refill; a failed prefill commits
  nothing).

Each builder returns the SAME object for the same cache key ``(kind,
cfg, model, cache_len, batch, long_context)`` (a decode key adds
``graph``, and an instance number past the first: see below): the
reference's key, with the model in the place of the mesh — the model
carries its mesh (``Transformer(mesh=)``), so the key holds it too.
``ModelConfig`` is a frozen dataclass, so the key holds the dispatch mode
and every other knob.  The model is in the key because a CUDA graph binds
addresses: a second model of the same config (``traffic.skew_router``'s
copy beside the uniform one) gets its own step instead of replaying the
first model's weights.

Across ranks (a model with a mesh) every rank runs the same host loop —
the same prefills, decode steps, sampling and admission — so their
collectives match in number and order; the greedy tokens come from
logits that are bitwise equal on every rank (the activations are
replicated and the ``moe`` outputs all-gathered), a temperature draw from
a generator seeded equally on every rank.  The decode step across ranks
is eager (``graph=False``): a gloo collective on CUDA tensors stages
through the host and synchronises, which ``torch.cuda.graph`` cannot
capture, and a step's expert-TP and AllToAll collectives are issued on
the host each step.

On ``cuda`` a decode entry owns one captured ``torch.cuda.CUDAGraph``
and everything it reads or writes, at fixed addresses: the model, one
cache per layer (``batch`` rows, ``cache_len`` positions, the position a
0-d device tensor), the token buffer, the gate noise (drawn once,
``transformer.decode_noise``), the graph's private memory pool and the
logits it returns, which the next call overwrites.  The build runs one
eager step on a side stream on the zeroed buffers (it really launches its
kernels), zeroes them again and captures one step; a call copies the
token in and replays the graph, which launches no wrapper: the rise of
the kernels' launch counters during the capture is taken back after it
and added at each replay (``kernels/ops.add_launch_counts``), so the
counters count the launches that ran.  On the CPU the same entry runs the
step eagerly.  ``trace_counts[key]`` counts captures on ``cuda`` and
builds on the CPU: one per key either way (the contract of PR 7).
:func:`clear_step_cache` drops the cache's entries (or one model's) and
their counts, and with them the cache's hold on the models, caches,
graphs and pools; an entry a caller still holds (a live ``SlotServer``'s
step) stays usable.  ``generate`` and each ``SlotServer`` prefill into
the step's caches in place: they never allocate caches per call.  Each
claims its step for as long as it serves (``build_decode(owner=)``), and
a second live user of one key gets its own instance of the key, with its
own caches and graph: two users never share caches.

* ``serve_config(cfg, dispatch=, payload_dtype=)`` derives the serving
  config: the MoE dispatch override is validated against
  ``DISPATCH_MODES``, the wire dtype by ``MoEConfig``.
* ``validate_decode_config(cfg, batch, cache_len=, mesh=)`` raises at
  step-build time for a configuration that cannot run, at the decode
  step's tokens a rank (:func:`_tokens_per_shard`).

Fault seam (``core/faults.py``): a decode step applies the host-side
``serve.decode_row`` site to its logits (indexed by the caller's
``step_index``).  With no ambient plan it adds no op and no host wait;
with one it pulls the logits to the host, poisons one seeded element (one
row) and puts them back.  ``generate`` runs under
``torch.inference_mode()``, as every builder's step does, and takes token
prompts: a frontend preset is served through the API
(:func:`refuse_frontend`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
import weakref
from collections import Counter
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core import faults as faults_mod
from repro_torch.core import moe as moe_lib
from repro_torch.core import tuning
from repro_torch.core.config import DISPATCH_MODES, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import transformer as T

# process-wide step cache: key -> step.  Keys are (kind, cfg, model,
# cache_len, batch, long_context[, graph[, instance]]); an nn.Module
# hashes by identity, and the entry holds the model, so its id is never
# reused while the entry lives.
_STEP_CACHE: Dict[tuple, Any] = {}
trace_counts: Counter = Counter()


def clear_step_cache(model=None) -> None:
    """Drop every cached step (only those of ``model`` when given) and
    their ``trace_counts``."""
    for key in [k for k in _STEP_CACHE if model is None or k[2] is model]:
        del _STEP_CACHE[key]
    for key in [k for k in trace_counts if model is None or k[2] is model]:
        del trace_counts[key]


def trace_budget_report(budget: int = 1, counts=None) -> Dict[tuple, int]:
    """Step-builder keys that were captured (built, on the CPU) MORE than
    ``budget`` times since the last ``clear_step_cache`` — the probe of a
    cache-key leak (a key that does not find its cached step).
    ``counts`` defaults to the live ``trace_counts``."""
    counts = trace_counts if counts is None else counts
    return {k: int(v) for k, v in counts.items() if int(v) > budget}


def _cached(key: tuple, make: Callable[[], Any]) -> Any:
    fn = _STEP_CACHE.get(key)
    if fn is None:
        fn = make()
        _STEP_CACHE[key] = fn
    return fn


def validate_dispatch(dispatch: str) -> str:
    """Validate a serving dispatch-mode name against ``DISPATCH_MODES``."""
    if dispatch not in DISPATCH_MODES:
        raise ValueError(
            f"serving dispatch={dispatch!r} is not a known dispatch "
            f"mode; valid options: {DISPATCH_MODES}")
    return dispatch


def serve_config(cfg: ModelConfig, *, dispatch: Optional[str] = None,
                 payload_dtype: Optional[str] = None) -> ModelConfig:
    """The config actually served: ``dispatch`` / ``payload_dtype`` (when
    given) override the MoE dispatch mode and the grouped exchange's wire
    dtype — validated (``MoEConfig`` checks the wire dtype), never
    silently dropped."""
    if dispatch is None and payload_dtype is None:
        return cfg
    if dispatch is not None:
        validate_dispatch(dispatch)
    if cfg.moe is None:
        knob = "dispatch" if dispatch is not None else "payload_dtype"
        raise ValueError(
            f"{knob}={dispatch or payload_dtype!r} requested but {cfg.name} "
            f"has no MoE layer (cfg.moe is None) — MoE serving overrides "
            f"only apply to MoE architectures")
    kw = {}
    if dispatch is not None and cfg.moe.dispatch != dispatch:
        kw["dispatch"] = dispatch
    if payload_dtype is not None and cfg.moe.payload_dtype != payload_dtype:
        kw["payload_dtype"] = payload_dtype
    if not kw:
        return cfg
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))


def _tokens_per_shard(mesh, batch: int) -> int:
    """A decode step's tokens a rank: ``batch`` single tokens padded to
    the world (``moe.rank_tokens``) and split over it."""
    world = 1 if mesh is None else mesh.world
    return -(-batch // world)


def _model_size(mesh) -> int:
    return 1 if mesh is None else mesh.shape["model"]


def validate_decode_config(cfg: ModelConfig, batch: int, *,
                           cache_len: Optional[int] = None,
                           mesh=None) -> None:
    """Raise ``ValueError`` for a decode configuration that cannot run,
    before any step does: the dispatch, a2a and overlap combination and
    the overlap windows' bound at the decode step's tokens a rank
    (``mesh``: the model's)."""
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name} is encoder-only — no decode step")
    if batch < 1:
        raise ValueError(f"decode batch must be >= 1, got {batch}")
    if cache_len is not None and cache_len < 2:
        raise ValueError(
            f"cache_len must be >= 2 (one prompt token + one generated), "
            f"got {cache_len}")
    if cfg.moe is not None:
        moe_lib.validate_dispatch_config(
            cfg.moe, model_size=_model_size(mesh),
            tokens_per_shard=_tokens_per_shard(mesh, batch),
            d_model=cfg.d_model, dtype=getattr(torch, cfg.dtype))


def refuse_frontend(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a frontend config (audio, vision), which
    takes embeddings, not the token prompts ``generate`` samples from;
    the reference's serving entry point refuses it the same way."""
    if cfg.frontend is not None:
        raise ValueError(
            f"{cfg.name}: a {cfg.frontend} frontend takes (B, S, d) "
            f"embeddings, not token prompts; serve it through the API: "
            f"Transformer.forward(embeddings, caches=model.init_caches(B, "
            f"L)), then Transformer.decode_step fed (B, 1, d) embeddings "
            f"(models/frontend.synthetic_embeddings)")


def resolve_decode_config(cfg: ModelConfig, batch: int,
                          mesh=None) -> ModelConfig:
    """The decode-step config: ``"auto"`` MoE knobs resolved at the decode
    step's tokens a rank (one token per row; ``mesh``: the model's)."""
    if cfg.moe is None or not tuning.has_auto_knobs(cfg.moe):
        return cfg
    return cfg.replace(moe=tuning.resolve_moe_config(
        cfg.moe, model_size=_model_size(mesh),
        tokens_per_shard=_tokens_per_shard(mesh, batch),
        d_model=cfg.d_model, dtype=getattr(torch, cfg.dtype)))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# raw (uncached) step factories — the eager steps, kept for the checks that
# drive them beside the built ones; the builders below wrap these
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, *, cache_len: int,
                      long_context: bool = False):
    """``prefill(model, tokens (B, S)) -> (last logits (B, 1, V), caches)``
    into fresh caches of ``cache_len``."""
    @torch.inference_mode()
    def prefill(model, tokens):
        caches = model.init_caches(tokens.shape[0], cache_len,
                                   long_context=long_context)
        h, _, caches = model.forward(tokens.to(model.device), caches=caches,
                                     cfg=cfg, long_context=long_context)
        return model.logits_from_hidden(h[:, -1:]), caches
    return prefill


def make_serve_step(cfg: ModelConfig, *, long_context: bool = False):
    """The eager decode step: ``serve_step(model, token (B, 1), caches) ->
    (logits (B, 1, V), caches)``, the caches updated in place."""
    @torch.inference_mode()
    def serve_step(model, token, caches):
        return model.decode_step(token.to(model.device), caches, cfg,
                                 long_context=long_context)
    return serve_step


# ---------------------------------------------------------------------------
# cached step builders
# ---------------------------------------------------------------------------

def build_prefill(model, cfg: Optional[ModelConfig] = None, *,
                  cache_len: int, batch: Optional[int] = None,
                  long_context: bool = False):
    """Cached prefill ``(tokens (B, S), caches) -> (last logits (B, 1, V),
    caches)``, ``caches`` (a decode step's) filled in place."""
    cfg = cfg or model.cfg
    key = ("prefill", cfg, model, cache_len, batch, long_context)

    def make():
        trace_counts[key] += 1

        @torch.inference_mode()
        def prefill(tokens, caches):
            h, _, caches = model.forward(tokens.to(model.device),
                                         caches=caches, cfg=cfg,
                                         long_context=long_context)
            return model.logits_from_hidden(h[:, -1:]), caches
        return prefill
    return _cached(key, make)


class DecodeStep:
    """One cached decode step over the caches it owns (see the module
    docstring): ``step(token (B, 1), step_index=0) -> logits (B, 1, V)``.
    ``graph`` is the captured ``torch.cuda.CUDAGraph`` (None: eager, on
    the CPU or when built with ``graph=False``), ``rise`` the launches a
    replay adds to the counters, ``calls`` the steps run (graph replays,
    or eager steps), ``capacity`` the positions the caches hold before a
    linear one is full (None: rings only)."""

    @torch.inference_mode()
    def __init__(self, key: tuple, model, cfg: ModelConfig, *, batch: int,
                 cache_len: int, long_context: bool, graph: bool):
        dev = model.device
        self.model, self.cfg = model, cfg
        self.long_context = long_context
        self.caches = model.init_caches(batch, cache_len,
                                        long_context=long_context)
        self.capacity = T.linear_capacity(cfg, self.caches, long_context)
        self.token = torch.zeros((batch, 1), dtype=torch.long, device=dev)
        self.noise = T.decode_noise(cfg, batch, dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self.rise: Dict[str, int] = {}
        self.calls = 0
        self._owner = None
        if graph and dev.type == "cuda":
            self._capture()
        trace_counts[key] += 1

    def _run(self) -> torch.Tensor:
        logits, _ = self.model.decode_step(self.token, self.caches, self.cfg,
                                           long_context=self.long_context,
                                           noise=self.noise)
        return logits

    def _capture(self) -> None:
        dev = self.model.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._run()               # warm-up: launches for real
        main.wait_stream(side)
        self.reset()
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.logits = self._run()
        after = ops.launch_counts()
        self.rise = {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}
        ops.add_launch_counts({k: -n for k, n in self.rise.items()})
        self.graph = graph

    @torch.inference_mode()
    def reset(self) -> None:
        """Zero the caches, their positions and the recurrent states, as a
        fresh init leaves them."""
        for t in _cache_leaves(self.caches):
            t.zero_()

    def claim(self, owner) -> bool:
        """Hold the caches for ``owner`` until it is collected or gives
        them back (:meth:`release`); False when another live owner holds
        them."""
        held = self._owner() if self._owner is not None else None
        if held is not None and held is not owner:
            return False
        self._owner = weakref.ref(owner)
        return True

    def release(self, owner) -> None:
        if self._owner is not None and self._owner() is owner:
            self._owner = None

    @torch.inference_mode()
    def __call__(self, token: torch.Tensor,
                 step_index: int = 0) -> torch.Tensor:
        self.token.copy_(token)
        if self.graph is None:
            logits = self._run()
        else:
            self.graph.replay()
            ops.add_launch_counts(self.rise)
            logits = self.logits
        self.calls += 1
        if faults_mod.get_active() is not None:
            poisoned = faults_mod.inject_array(
                "serve.decode_row", logits.float().cpu().numpy(),
                index=step_index)
            logits = torch.from_numpy(poisoned).to(logits.device,
                                                   logits.dtype)
        return logits


def decode_graph(model, graph: Optional[bool] = None) -> bool:
    """Whether a decode step of ``model`` is captured: ``graph`` as given,
    by default True on one device (eager on the CPU all the same) and
    False across ranks.  ``graph=True`` with a mesh raises: a gloo
    collective on CUDA tensors stages through the host and synchronises,
    which a CUDA graph cannot capture."""
    mesh = model.mesh
    if graph is None:
        return mesh is None
    if graph and mesh is not None:
        raise ValueError(
            f"graph=True with mesh {mesh.describe()}: a decode step across "
            f"ranks issues its collectives from the host each step (gloo "
            f"stages CUDA tensors through the host and synchronises), which "
            f"CUDA graph capture cannot hold; serve it eagerly (graph=False "
            f"or the default)")
    return graph


def build_decode(model, cfg: Optional[ModelConfig] = None, *, batch: int,
                 cache_len: int, long_context: bool = False,
                 graph: Optional[bool] = None, owner=None) -> DecodeStep:
    """The cached :class:`DecodeStep` of ``batch`` rows over caches of
    ``cache_len``: a captured CUDA graph on ``cuda`` (``graph=False``:
    the same step run eagerly, for comparison), eager on the CPU and
    across ranks (:func:`decode_graph`).  ``"auto"`` MoE knobs resolve
    here (:func:`resolve_decode_config`), so the resolved config is the
    key.  With ``owner`` (a ``SlotServer``, a ``generate`` call) the step
    is claimed for it: the key's step when no other live owner holds it,
    else the first free further instance of the key (its own caches and
    graph, built at first use), so that two live users never share
    caches."""
    graph = decode_graph(model, graph)
    cfg = resolve_decode_config(cfg or model.cfg, batch, model.mesh)
    base = ("decode", cfg, model, cache_len, batch, long_context, graph)
    for i in itertools.count():
        key = base + ((i,) if i else ())
        step = _cached(key, lambda: DecodeStep(
            key, model, cfg, batch=batch, cache_len=cache_len,
            long_context=long_context, graph=graph))
        if owner is None or step.claim(owner):
            return step


class _Holder:
    """The owner a :func:`holding_decode` block claims a step with."""


@contextlib.contextmanager
def holding_decode(model, cfg: Optional[ModelConfig] = None, **kw):
    """:func:`build_decode` with an owner for the length of a ``with``
    block, which the block's step is given back by."""
    owner = _Holder()
    step = build_decode(model, cfg, owner=owner, **kw)
    try:
        yield step
    finally:
        step.release(owner)


def build_slot_prefill(model, cfg: Optional[ModelConfig] = None, *,
                       cache_len: int, long_context: bool = False):
    """Cached per-slot prefill for ``SlotServer``: the full forward of a
    ``(1, S)`` prompt into fresh single-row caches of ``cache_len``;
    ``(prompt) -> (last logits (V,), caches)``.  :func:`put_slot`
    commits them; until then the served caches are untouched."""
    cfg = cfg or model.cfg
    key = ("slot_prefill", cfg, model, cache_len, None, long_context)

    def make():
        trace_counts[key] += 1

        @torch.inference_mode()
        def slot_prefill(prompt):
            sub = model.init_caches(1, cache_len, long_context=long_context)
            h, _, sub = model.forward(prompt.to(model.device), caches=sub,
                                      cfg=cfg, long_context=long_context)
            return model.logits_from_hidden(h[:, -1:])[0, -1], sub
        return slot_prefill
    return _cached(key, make)


def _cache_leaves(caches):
    """Every tensor of the per-layer caches (attention ``k``, ``v``,
    ``pos``; recurrent ``s``, ``x_last``, ``conv``, ``pos``), in a fixed
    order."""
    out = []
    for c in caches:
        for v in c.values():
            out.extend(_cache_leaves([v]) if isinstance(v, dict) else [v])
    return out


@torch.inference_mode()
def put_slot(caches, sub, slot: int) -> None:
    """Copy single-row caches ``sub`` into row ``slot`` of ``caches`` in
    place — the attention keys and values and the recurrent states — and
    set the shared positions (the 0-d tensors) to theirs: the reference's
    ``put`` in ``build_slot_prefill``."""
    for full, one in zip(_cache_leaves(caches), _cache_leaves(sub),
                         strict=True):
        if full.ndim == 0:
            full.copy_(one)
        else:
            full[slot].copy_(one[0])


# ---------------------------------------------------------------------------
# host-side generation loop
# ---------------------------------------------------------------------------

@torch.inference_mode()
def generate(model, prompt: torch.Tensor, *, steps: int,
             cache_len: Optional[int] = None, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             dispatch: Optional[str] = None, long_context: bool = False,
             stats: Optional[dict] = None,
             payload_dtype: Optional[str] = None) -> torch.Tensor:
    """Greedy/temperature generation.  prompt (B, S) → (B, S+steps).

    ``model`` is a ``models.transformer.Transformer`` (with a mesh: every
    rank calls this with the same prompt and an equally seeded
    ``generator``, and gets the same tokens); ``dispatch`` overrides the
    MoE dispatch mode and ``payload_dtype`` the grouped exchange's wire
    dtype (:func:`serve_config`); ``long_context`` serves the
    long-context variant (``global`` layers capped to ``local_window``).
    Steps come from the step cache (``build_prefill``, ``build_decode``):
    a repeated call with the same shapes builds and captures nothing.  As
    in the reference, the last token is sampled without a further decode
    step (1 prefill + steps-1 decode steps).  With ``stats`` given, the
    device is synchronised after the prefill and at the end, and
    ``prefill_s``, ``decode_s`` and ``decode_steps`` are written into it,
    with ``logits_finite``: whether every logits row sampled from was
    finite.
    """
    cfg = serve_config(model.cfg, dispatch=dispatch,
                       payload_dtype=payload_dtype)
    B, S = prompt.shape[:2]
    cache_len = cache_len or (S + steps)
    validate_decode_config(cfg, B, cache_len=cache_len, mesh=model.mesh)
    refuse_frontend(cfg)
    prefill = build_prefill(model, cfg, cache_len=cache_len, batch=B,
                            long_context=long_context)
    prompt = prompt.to(model.device)
    with holding_decode(model, cfg, batch=B, cache_len=cache_len,
                        long_context=long_context) as step:
        # the host mirror of the position: decode step i writes S + i
        if (steps > 1 and step.capacity is not None
                and S + steps - 2 >= step.capacity):
            raise ValueError(f"cache of {step.capacity} positions is full "
                             f"at pos={step.capacity}")
        t0 = time.perf_counter()
        step.reset()
        logits, _ = prefill(prompt, step.caches)
        if stats is not None:
            _sync(model.device)
            t1 = time.perf_counter()
        out = [prompt]
        finite = torch.ones((), dtype=torch.bool, device=model.device)
        for i in range(steps):
            last = logits[:, -1].float()
            if stats is not None:
                finite &= torch.isfinite(last).all()
            if temperature > 0:
                probs = torch.softmax(last / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)
            else:
                tok = last.argmax(dim=-1, keepdim=True)
            out.append(tok.to(prompt.dtype))
            if i + 1 < steps:
                logits = step(tok, step_index=i)
        result = torch.cat(out, dim=1)
        if stats is not None:
            _sync(model.device)
            stats.update(prefill_s=t1 - t0,
                         decode_s=time.perf_counter() - t1,
                         decode_steps=max(steps - 1, 0),
                         logits_finite=bool(finite))
    return result
