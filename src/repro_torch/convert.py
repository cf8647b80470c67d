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

Across ranks each of them takes this rank's ``launch/shard.Layout``:
:func:`params_from_numpy` (given a mesh) and :func:`state_from_numpy` cut
each leaf to the rank's block of its spec on the host, leaf by leaf,
before it reaches the device; :func:`state_to_numpy` gathers each leaf
whole onto rank 0's host over the groups of its spec, one leaf at a
time (the other ranks send their blocks and get None).
:func:`param_shapes` gives the port's tree of shapes for the sharding
rules without drawing a weight.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.config import ModelConfig
from repro_torch.launch import shard
from repro_torch.launch.mesh import map_paths
from repro_torch.models.transformer import (LORA_R, _check_supported,
                                            layer_kinds, untied_head)
from repro_torch.training.train_step import TrainState


def _attn_shapes(cfg: ModelConfig, prefix: Tuple
                 ) -> Dict[Tuple, Tuple[int, ...]]:
    d, a, hd = cfg.d_model, cfg.attention, cfg.head_dim
    out = {prefix + ("wq",): (d, a.num_heads * hd),
           prefix + ("wk",): (d, a.num_kv_heads * hd),
           prefix + ("wv",): (d, a.num_kv_heads * hd),
           prefix + ("wo",): (a.num_heads * hd, d)}
    if a.qk_norm:
        out.update({prefix + ("q_norm",): (hd,), prefix + ("k_norm",): (hd,)})
    return out


def _block_shapes(cfg: ModelConfig, kind: str) -> Dict[Tuple, Tuple[int, ...]]:
    """Path → shape of one block of ``kind``'s leaves (unstacked)."""
    d = cfg.d_model
    gated = cfg.act in ("swiglu", "geglu")

    def mlp(name, f):
        return {(name, "w_in"): (d, 2 * f if gated else f),
                (name, "w_out"): (f, d)}
    if kind == "rwkv":
        r = cfg.rwkv
        block = {("ln1",): (d,), ("ln2",): (d,), ("rwkv", "mu"): (5, d),
                 ("rwkv", "mix_a"): (d, 5 * r.mix_lora),
                 ("rwkv", "mix_b"): (5, r.mix_lora, d),
                 ("rwkv", "decay_a"): (d, r.decay_lora),
                 ("rwkv", "decay_b"): (r.decay_lora, d)}
        block.update({("rwkv", n): (d, d) for n in ("wr", "wk", "wv", "wg",
                                                    "wo")})
        block.update({("rwkv", n): (d,) for n in ("w0", "u", "ln_x")})
        block.update(mlp("mlp", cfg.d_ff))
        return block
    if kind in ("mamba", "mamba_sa"):
        m = cfg.ssm
        d_in = m.expand * d
        H, gn = d_in // m.head_dim, 2 * m.n_groups * m.d_state
        block = {("ln1",): (d,), ("mamba", "w_in"): (d, 2 * d_in + gn + H),
                 ("mamba", "conv_w"): (m.conv_width, d_in + gn),
                 ("mamba", "conv_b"): (d_in + gn,), ("mamba", "A_log"): (H,),
                 ("mamba", "D"): (H,), ("mamba", "dt_bias"): (H,),
                 ("mamba", "norm"): (d_in,), ("mamba", "w_out"): (d_in, d)}
        if kind == "mamba_sa":
            block.update({("sa_ln",): (d,), ("sa_lora_a",): (d, LORA_R),
                          ("sa_lora_b",): (LORA_R, d)})
        return block
    block = {("ln1",): (d,), ("ln2",): (d,)}
    block.update(_attn_shapes(cfg, ("attn",)))
    if kind != "moe":
        block.update(mlp("mlp", cfg.d_ff))
        return block
    m = cfg.moe
    f, E = m.d_ff_expert or cfg.d_ff, m.num_experts
    block.update({("moe", "gate_w"): (d, E), ("moe", "w_up"): (E, d, f),
                  ("moe", "w_out"): (E, f, d)})
    if gated:
        block[("moe", "w_gate")] = (E, d, f)
    if m.num_shared_experts:
        block.update(mlp("shared_mlp", f * m.num_shared_experts))
    return block


def _expected_shapes(cfg: ModelConfig) -> Dict[Tuple, Tuple[int, ...]]:
    """Path → shape of every leaf the JAX tree holds for ``cfg``: pattern
    slot ``j``'s leaves under ``("blocks", j, ...)``, stacked over the
    super-blocks ``(nsb, ...)``."""
    d, nsb = cfg.d_model, cfg.num_super_blocks
    out = {("final_norm",): (d,)}
    out.update(_top_shapes(cfg))
    for j, kind in enumerate(cfg.block_pattern):
        for path, shape in _block_shapes(cfg, kind).items():
            out[("blocks", j) + path] = (nsb,) + shape
    return out


def _top_shapes(cfg: ModelConfig) -> Dict[Tuple, Tuple[int, ...]]:
    """The embedding table (none for a frontend config), the head (an
    untied config's, always a frontend's) and zamba2's shared attention
    block (``mamba_sa`` configs), as the reference's ``init_model`` keeps
    them."""
    d, V = cfg.d_model, cfg.vocab_size
    out = {}
    if cfg.frontend is None:
        out[("embed",)] = (V, d)
    if untied_head(cfg):
        out[("lm_head",)] = (d, V)
    if "mamba_sa" in cfg.block_pattern:
        out[("shared_attn", "ln")] = (d,)
        out.update(_attn_shapes(cfg, ("shared_attn", "attn")))
    return out


def _put(tree: Dict[Any, Any], path: Tuple, leaf) -> None:
    """Set ``leaf`` at ``path`` in nested dicts, making the dicts on the
    way."""
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = leaf


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


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The port's parameter tree of ``cfg`` with ``meta`` tensors for
    leaves: the shapes, no storage (the sharding rules' input)."""
    _check_supported(cfg)

    def meta(shape):
        return torch.empty(shape, device="meta")
    blocks = []
    for kind in layer_kinds(cfg):
        layer: Dict[str, Any] = {}
        for path, shape in _block_shapes(cfg, kind).items():
            _put(layer, path, meta(shape))
        blocks.append(layer)
    out = {"blocks": blocks, "final_norm": meta((cfg.d_model,))}
    for path, shape in _top_shapes(cfg).items():
        _put(out, path, meta(shape))
    return out


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      mesh=None, *, fsdp: bool = False) -> Dict[str, Any]:
    """The JAX parameter tree (numpy leaves) → the port's f32 tree; with
    ``mesh`` (a ``launch/mesh.Mesh``) this rank's share by its layout
    (``launch/shard.layout_for(cfg, mesh, fsdp)``): under ``fsdp=False``
    each expert leaf (E, …) cut to the rank's E/M slice and the rest
    whole, under ``fsdp=True`` every leaf as its spec says.  Raises
    ``ValueError`` naming missing keys, unexpected keys and shape
    mismatches."""
    return _params_from_numpy(tree, cfg,
                              shard.layout_for(cfg, mesh, fsdp=fsdp))


def _params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                       layout: Optional[shard.Layout]) -> Dict[str, Any]:
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

    def t(p, port_path, *index):
        # the rank's block of the leaf, cut before the copy
        a = np.asarray(got[p])[index]
        if layout is not None:
            a = layout.cut(port_path, a)
        return torch.from_numpy(np.array(a, dtype=np.float32))

    period = len(cfg.block_pattern)
    blocks = []
    for s in range(cfg.num_super_blocks):
        for j in range(period):
            i = s * period + j
            layer: Dict[str, Any] = {}
            for path in want:
                if path[:2] == ("blocks", j):
                    _put(layer, path[2:], t(path, _key("blocks", i,
                                                       *path[2:]), s))
            blocks.append(layer)
    out = {"blocks": blocks, "final_norm": t(("final_norm",), "final_norm")}
    for p in _top_shapes(cfg):
        _put(out, p, t(p, _key(*p)))
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
    out = {"blocks": tuple(blocks), "final_norm": a(params["final_norm"])}
    for p in _top_shapes(cfg):
        leaf = params
        for k in p:
            leaf = leaf[k]
        _put(out, p, a(leaf))
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


def state_to_numpy(state: TrainState, cfg: ModelConfig, *,
                   layout: Optional[shard.Layout] = None
                   ) -> Optional[Dict[str, np.ndarray]]:
    """A port ``TrainState`` → {reference checkpoint key: numpy array}
    (params and moments stacked as the reference keeps them).  Only f32
    moments are carried: numpy has no bfloat16.  With ``layout`` (the
    state stored across ranks; every rank calls it) each leaf is gathered
    whole onto rank 0's host, one at a time (``Layout.to_host``): rank 0
    gets the arrays, the other ranks None."""
    for mom in ("m", "v"):
        dt = {t.dtype for t in tree.leaves(state.opt[mom])}
        if dt != {torch.float32}:
            raise ValueError(
                f"state_to_numpy: opt/{mom} is {sorted(map(str, dt))}; only "
                f"f32 moments are carried (numpy has no bfloat16)")
    trees = dict(zip(_TREES, (state.params, state.opt["m"], state.opt["v"])))
    if layout is not None:
        trees = {sec: map_paths(layout.to_host, t)
                 for sec, t in trees.items()}
        if layout.rank != 0:
            return None
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
                     device=None, layout: Optional[shard.Layout] = None
                     ) -> TrainState:
    """{reference checkpoint key: array} → a port ``TrainState`` on
    ``device`` (the CPU unless given): f32 masters that require grad, f32
    moments, int32 counters, an f32 loss scale; with ``layout`` this
    rank's blocks of params and moments (cut on the host).  Raises
    ``ValueError`` naming missing and unexpected keys."""
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
                         _params_from_numpy(nested, cfg, layout))

    def scalar(key, dt):
        return torch.from_numpy(np.array(flat[key], dtype=dt)).to(device)

    params = tree.map_(lambda t: t.requires_grad_(True), section(".params"))
    opt = {"m": section(".opt/m"), "v": section(".opt/v"),
           "count": scalar(".opt/count", np.int32)}
    return TrainState(params, opt, **{n: scalar("." + n, dt)
                                      for n, dt in _COUNTERS})


def _scalar(t: torch.Tensor, dt) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), dtype=dt).reshape(())
