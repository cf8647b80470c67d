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
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.config import ModelConfig
from repro_torch.models.transformer import _check_supported


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
