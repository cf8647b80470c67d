"""Parameters of the JAX package ↔ the port's parameter tree.

The JAX model (``repro.models.transformer.init_model``) keeps its blocks
as a tuple over the block pattern whose leaves are stacked over
super-blocks ``(nsb, ...)``.  :func:`params_from_numpy` takes that tree as
nested dicts/tuples of numpy arrays (``jax.tree.map(np.asarray, params)``)
and returns the port's tree — one dict per layer, layer
``s·period + j`` from super-block ``s`` and pattern slot ``j`` — as f32
CPU tensors, ready for ``Transformer(cfg, params=...)`` or a trainer's
masters.  :func:`params_to_numpy` is its reverse: the port's tree (e.g. a
trainer's parameters after some steps) as the reference's stacked tree of
f32 numpy arrays.

:func:`state_to_numpy` and :func:`state_from_numpy` carry a whole
``TrainState`` (params, the AdamW moments and count, the step, the skip
and loss-scale counters) as a flat dict keyed by the names the
reference's checkpoint gives its ``TrainState``
(``repro.checkpoint.io._flatten``: ``.params/blocks/0/attn/wq``,
``.opt/m/...``, ``.opt/count``, ``.step``, ...), blocks stacked over
super-blocks.  The port's checkpoints (``checkpoint/io.py``) use them for
their keys, so a checkpoint moves between the JAX trainer and the port in
either direction.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.config import ModelConfig
from repro_torch.models.transformer import _check_supported
from repro_torch.training.train_step import TrainState


def _expected_shapes(cfg: ModelConfig) -> Dict[Tuple, Tuple[int, ...]]:
    """Path → shape of every leaf the JAX tree holds for ``cfg``."""
    d, nsb = cfg.d_model, cfg.num_super_blocks
    a, m = cfg.attention, cfg.moe
    hd = cfg.head_dim
    f = m.d_ff_expert or cfg.d_ff
    E = m.num_experts
    block = {("ln1",): (d,), ("ln2",): (d,),
             ("attn", "wq"): (d, a.num_heads * hd),
             ("attn", "wk"): (d, a.num_kv_heads * hd),
             ("attn", "wv"): (d, a.num_kv_heads * hd),
             ("attn", "wo"): (a.num_heads * hd, d),
             ("moe", "gate_w"): (d, E),
             ("moe", "w_up"): (E, d, f),
             ("moe", "w_out"): (E, f, d)}
    if a.qk_norm:
        block.update({("attn", "q_norm"): (hd,), ("attn", "k_norm"): (hd,)})
    if cfg.act in ("swiglu", "geglu"):
        block[("moe", "w_gate")] = (E, d, f)
    out = {("final_norm",): (d,), ("embed",): (cfg.vocab_size, d)}
    if not cfg.tie_embeddings:
        out[("lm_head",)] = (d, cfg.vocab_size)
    for j in range(len(cfg.block_pattern)):
        for path, shape in block.items():
            out[("blocks", j) + path] = (nsb,) + shape
    return out


def _flatten(tree: Any, prefix: Tuple = ()) -> Dict[Tuple, Any]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, prefix + (k,)))
    return flat


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig
                      ) -> Dict[str, Any]:
    """The JAX parameter tree (numpy leaves) → the port's f32 tree.
    Raises ``ValueError`` naming missing keys, unexpected keys and shape
    mismatches."""
    _check_supported(cfg)
    want = _expected_shapes(cfg)
    got = _flatten(tree)
    fmt = lambda paths: sorted("/".join(map(str, p)) for p in paths)  # noqa: E731
    missing, extra = set(want) - set(got), set(got) - set(want)
    bad = sorted(f"{'/'.join(map(str, p))}: {tuple(np.shape(got[p]))} != "
                 f"{want[p]}" for p in set(want) & set(got)
                 if tuple(np.shape(got[p])) != want[p])
    if missing or extra or bad:
        raise ValueError(
            f"params_from_numpy({cfg.name}): missing keys {fmt(missing)}; "
            f"unexpected keys {fmt(extra)}; shape mismatches {bad}")

    def t(p, *index):
        return torch.from_numpy(np.array(got[p][index], dtype=np.float32))

    period = len(cfg.block_pattern)
    blocks = []
    for s in range(cfg.num_super_blocks):
        for j in range(period):
            layer: Dict[str, Any] = {"attn": {}, "moe": {}}
            for path in want:
                if path[:2] != ("blocks", j):
                    continue
                rest = path[2:]
                if len(rest) == 1:
                    layer[rest[0]] = t(path, s)
                else:
                    layer[rest[0]][rest[1]] = t(path, s)
            blocks.append(layer)
    out = {"blocks": blocks, "final_norm": t(("final_norm",)),
           "embed": t(("embed",))}
    if not cfg.tie_embeddings:
        out["lm_head"] = t(("lm_head",))
    return out


def params_to_numpy(params: Dict[str, Any], cfg: ModelConfig
                    ) -> Dict[str, Any]:
    """The port's per-layer tree → the JAX package's tree (blocks a tuple
    over the block pattern, leaves stacked over super-blocks) of f32 numpy
    arrays.  Raises ``ValueError`` when the layer count does not match."""
    _check_supported(cfg)
    period = len(cfg.block_pattern)
    if len(params["blocks"]) != cfg.num_layers:
        raise ValueError(f"params_to_numpy({cfg.name}): "
                         f"{len(params['blocks'])} layers, config has "
                         f"{cfg.num_layers}")

    def a(t):
        return t.detach().float().cpu().numpy()

    def stack(j, *path):
        rows = []
        for s in range(cfg.num_super_blocks):
            leaf = params["blocks"][s * period + j]
            for k in path:
                leaf = leaf[k]
            rows.append(a(leaf))
        return np.stack(rows)

    blocks = []
    for j in range(period):
        layer = params["blocks"][j]
        blocks.append({k: ({kk: stack(j, k, kk) for kk in v}
                           if isinstance(v, dict) else stack(j, k))
                       for k, v in layer.items()})
    out = {"blocks": tuple(blocks), "final_norm": a(params["final_norm"]),
           "embed": a(params["embed"])}
    if not cfg.tie_embeddings:
        out["lm_head"] = a(params["lm_head"])
    return out


# the TrainState's counters after params and opt, in field order
_COUNTERS = (("step", np.int32), ("skipped", np.int32),
             ("nonfinite_streak", np.int32), ("good_streak", np.int32),
             ("loss_scale", np.float32))
_TREES = (".params", ".opt/m", ".opt/v")


def _sorted_paths(cfg: ModelConfig) -> List[Tuple]:
    """The parameter paths in ``jax.tree``'s order: dict keys sorted, the
    blocks tuple by index."""
    return sorted(_expected_shapes(cfg))


def _key(*parts) -> str:
    return "/".join(map(str, parts))


def state_keys(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """Checkpoint key → (shape, numpy dtype) of a ``TrainState`` of
    ``cfg`` with f32 moments, in the reference's flatten order."""
    shapes = _expected_shapes(cfg)
    f32, i32 = np.dtype(np.float32), np.dtype(np.int32)

    def tree_keys(sec):
        return {_key(sec, *p): (shapes[p], f32) for p in _sorted_paths(cfg)}
    return {**tree_keys(".params"), ".opt/count": ((), i32),
            **tree_keys(".opt/m"), **tree_keys(".opt/v"),
            **{"." + n: ((), np.dtype(dt)) for n, dt in _COUNTERS}}


def state_to_numpy(state: TrainState, cfg: ModelConfig
                   ) -> Dict[str, np.ndarray]:
    """A port ``TrainState`` → {reference checkpoint key: numpy array}
    (params and moments stacked as the reference keeps them).  Only f32
    moments are carried: numpy has no bfloat16."""
    for mom in ("m", "v"):
        dt = {t.dtype for t in tree.leaves(state.opt[mom])}
        if dt != {torch.float32}:
            raise ValueError(
                f"state_to_numpy: opt/{mom} is {sorted(map(str, dt))}; only "
                f"f32 moments are carried (numpy has no bfloat16)")
    trees = dict(zip(_TREES, (state.params, state.opt["m"], state.opt["v"])))
    stacked = {sec: _flatten(params_to_numpy(t, cfg))
               for sec, t in trees.items()}
    flat = {}
    for sec in _TREES:
        if sec == ".opt/m":
            flat[".opt/count"] = _scalar(state.opt["count"], np.int32)
        flat.update({_key(sec, *p): stacked[sec][p]
                     for p in _sorted_paths(cfg)})
    for name, dt in _COUNTERS:
        flat["." + name] = _scalar(getattr(state, name), dt)
    return flat


def state_from_numpy(flat: Dict[str, np.ndarray], cfg: ModelConfig, *,
                     device=None) -> TrainState:
    """{reference checkpoint key: array} → a port ``TrainState`` on
    ``device`` (the CPU unless given): f32 masters that require grad, f32
    moments, int32 counters, an f32 loss scale.  Raises ``ValueError``
    naming missing and unexpected keys."""
    want = state_keys(cfg)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"state_from_numpy({cfg.name}): missing keys "
                         f"{missing[:10]}; unexpected keys {extra[:10]}")
    period = len(cfg.block_pattern)

    def section(sec):
        nested: Dict[str, Any] = {"blocks": tuple({} for _ in range(period))}
        for path in _sorted_paths(cfg):
            node = nested
            for part in path[:-1]:
                node = node[part] if isinstance(part, int) else \
                    node.setdefault(part, {})
            node[path[-1]] = np.asarray(flat[_key(sec, *path)])
        return tree.map_(lambda t: t.to(device),
                         params_from_numpy(nested, cfg))

    def scalar(key, dt):
        return torch.from_numpy(np.array(flat[key], dtype=dt)).to(device)

    params = tree.map_(lambda t: t.requires_grad_(True), section(".params"))
    opt = {"m": section(".opt/m"), "v": section(".opt/v"),
           "count": scalar(".opt/count", np.int32)}
    return TrainState(params, opt, **{n: scalar("." + n, dt)
                                      for n, dt in _COUNTERS})


def _scalar(t: torch.Tensor, dt) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), dtype=dt).reshape(())
