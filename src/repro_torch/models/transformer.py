"""Model assembly for every block kind of the reference — the port of
``repro/models/transformer.py`` (init, ``forward``, ``init_caches``,
``decode_step``, ``logits_from_hidden``).

Block kinds (``cfg.block_pattern``), each pre-norm with residuals:

* ``attn``, ``local``, ``global``, ``dense``: attention, then an MLP;
* ``moe``: attention, then the HetuMoE layer (plus the shared experts'
  MLP where the config has them);
* ``rwkv``: the RWKV-6 time mix (``models/rwkv6.py``), then the config's
  MLP as the channel mix (the reference's: a plain MLP, no token shift);
* ``mamba``: a Mamba-2 block (``models/mamba2.py``), no MLP;
* ``mamba_sa``: a Mamba-2 block, then zamba2's SHARED attention block:
  one parameter set (the tree's top-level ``shared_attn``, ``{ln,
  attn}``) used at every ``mamba_sa`` layer, its input adapted per layer
  by ``sa_ln`` and a rank-``LORA_R`` LoRA (``sa_lora_a``, ``sa_lora_b``).

Layer ``i·P + j`` is pattern slot ``j`` of super-block ``i`` (``P =
len(cfg.block_pattern)``), the order of the reference's scan over
super-blocks.  A layer's attention window is :func:`block_window`'s: the
config's ``attention.window`` (``attn``, ``dense``, ``moe``, and
``mamba_sa`` unless ``long_context``), ``local_window`` (``local``, and
``global`` and ``mamba_sa`` with ``long_context``), else none; a windowed
layer's attention cache is a ring of the window's length once the
requested cache is longer.  A layer's cache (:func:`init_cache`) is the
attention cache ``{k, v, pos}`` of an attention kind, ``{"rwkv": {s,
x_last}}`` of an ``rwkv`` layer, ``{"mamba": {s, conv, pos}}`` of a
``mamba`` layer and that plus ``"sa"``, the shared attention's cache, of
a ``mamba_sa`` layer; every tensor of it is written in place, so a CUDA
graph can hold the decode step (``serving/engine.py``).

A frontend config (``cfg.frontend``: ``hubert-xlarge``'s audio,
``internvl2-2b``'s vision) takes (B, S, d) embeddings in place of token
ids (``models/frontend.py``), as the reference's ``_embed_inputs`` does:
its tree holds no ``embed`` table, and always an untied ``lm_head``.

Parameters are a tree of f32 tensors in the reference's layout, with the
``(nsb, ...)`` stacked block leaves split per layer
(:func:`init_params`, or ``convert.params_from_numpy`` from the JAX
package's tree).  :func:`forward` and :func:`logits_from_hidden` run over
that tree as the reference's do: each weight is cast to ``cfg.dtype`` at
its use, so a trainer's gradients land in f32 on the masters.  For
serving, :class:`Transformer` keeps one copy in the compute dtype instead,
made when the weights are loaded (or drawn straight in it, leaf by leaf)
— the same values, without re-reading the f32 weights at every decode
step.  The leaves the reference uses in f32 (``_F32_LEAVES``: the norm
scales, the router, the qk-norm scales, RWKV's decay LoRA, bonus and
group-norm scale, Mamba's ``A_log``, ``D``, ``dt_bias`` and norm) stay
f32.

Across ranks (``mesh``, a ``launch/mesh.Mesh``): in training each rank's
activations are its own token block (``launch/mesh.token_block``: whole
rows, or a chunk of one row's positions, attention then context-parallel
over the row group and each recurrent block run over its gathered whole
rows), and a ``moe`` block runs ``moe.sharded_moe_apply`` over the rank's
tokens with the rank's E/M experts (:func:`expert_leaf_mask` marks them).
The trainer's tree is stored by a ``launch/shard.Layout`` (``layout``):
under FSDP (ZeRO-3) each block gathers its stored blocks whole at its
start, inside a ``torch.utils.checkpoint`` region, so the whole weights
live only while the block runs forward and again while it recomputes in
the backward (whatever ``remat``); the embedding is gathered for its
lookup (which keeps only the ids for its backward), the head once for the
chunked CE (:func:`head_params`).  Serving (:class:`Transformer` with a
mesh) holds the reference's activation and cache layout: a rank's
activations are its data rank's rows of the batch (whole where they do
not divide over ``data``), and in the prefill its model rank's chunk of
their positions (``launch/mesh.serve_block``: attention context-parallel
over the model group, recurrent blocks over gathered whole rows); its
caches are its blocks by ``launch/shard.cache_layout_for``, the
reference's ``cache_shardings``: its rows, and over ``model`` one inner
dim of each leaf (an attention cache's kv heads, positions or channels;
RWKV's key dim, Mamba's head dim and conv channels where they divide),
described per layer by ``models/cache_cut.CacheCut``.  A ``moe`` block routes the
reference's block of the flattened tokens on every rank
(``moe.served_tokens``): the rank's own tokens where they are that
block, its cut of the tokens its group holds alike (a decode step's rows
over ``model``, ``moe.replicated_moe_apply``), or tokens exchanged into
the block and back (``moe.TokenRoute``: a context-parallel prefill of
several rows).  A served model stores its
tree by the reference's serving rule (``launch/shard.serve_layout_for``):
under expert TP the experts' f over the data group, which the prefill
gathers whole inside each block (:func:`gathered_block`) and a decode
step's ``moe`` blocks compute on as stored — expert tensor parallelism
over the data group (:func:`decode_expert_tp_axis`), as the reference's
decode does.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import draw, resolve_device, tree
from repro_torch.core import gating
from repro_torch.core import moe as moe_lib
from repro_torch.core.config import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers, mamba2, rwkv6

# leaves used in f32 whatever the compute dtype
_F32_LEAVES = (("ln1", "ln2", "final_norm", "gate_w", "q_norm", "k_norm",
                "sa_ln", "ln") + rwkv6.F32_LEAVES + mamba2.F32_LEAVES)
REMAT_MODES = ("none", "block", "full")
# attention + an MLP (attn, local, global, dense) or + the MoE layer (moe):
# the reference's dense is its attn under another name, local and global
# differ from it in their window only
ATTN_KINDS = ("attn", "local", "global", "dense", "moe")
BLOCK_KINDS = ATTN_KINDS + ("rwkv", "mamba", "mamba_sa")
LORA_R = 16   # zamba2's per-occurrence adapter rank of the shared block
# the expert leaves of a moe block: sharded over the model axis
EXPERT_LEAVES = ("w_up", "w_gate", "w_out")


def use_expert_tp() -> bool:
    """The expert-TP decode toggle: ``REPRO_EXPERT_TP`` (default ``"1"``),
    read when a served model is built; ``"0"`` stores the experts whole
    in f and decodes without expert TP."""
    return os.environ.get("REPRO_EXPERT_TP", "1") == "1"


def decode_expert_tp_axis(mesh) -> Optional[str]:
    """The axis a decode step's ``moe`` blocks shard the expert f dim over:
    ``"data"`` when :func:`use_expert_tp` and ``mesh`` has more than one
    rank, else None (one device has no TP).  The one decision point: a
    served model's layout stores the experts' f-slice by it
    (``launch/shard.serve_expert_tp``)."""
    if not use_expert_tp() or mesh is None or mesh.world == 1:
        return None
    return "data"


def _check_supported(cfg: ModelConfig) -> None:
    unknown = sorted(set(cfg.block_pattern) - set(BLOCK_KINDS))
    if unknown:
        raise ValueError(
            f"{cfg.name}: unknown block kinds {unknown} in "
            f"{cfg.block_pattern}; known: {BLOCK_KINDS}")


def block_window(kind: str, cfg: ModelConfig,
                 long_context: bool = False) -> Optional[int]:
    """The attention window of a ``kind`` layer (the reference's
    ``_block_window``, and its ``mamba_sa`` rule): ``local_window`` for
    ``local`` layers, and for ``global`` and ``mamba_sa`` ones in the
    long-context variant; none for ``rwkv`` and ``mamba``, which do not
    attend; else the config's."""
    if kind == "local" or (kind in ("global", "mamba_sa") and long_context):
        return cfg.local_window
    if kind in ("rwkv", "mamba"):
        return None
    return cfg.attention.window


def _is_ring(cache, window: Optional[int], cut=None) -> bool:
    """A windowed layer's cache of the window's length is a ring (``cut``:
    the cache is a rank's block of a whole cache of that length)."""
    return (window is not None
            and attn_lib.cache_length(cache, cut) == window)


def attention_cache(cache, kind: str):
    """The attention cache inside a layer's cache: the whole of an
    attention kind's, ``"sa"`` of a ``mamba_sa`` layer's, else None."""
    if kind == "mamba_sa":
        return cache["sa"]
    return cache if kind in ATTN_KINDS else None


def linear_capacity(cfg: ModelConfig, caches,
                    long_context: bool = False,
                    cuts=None) -> Optional[int]:
    """The positions ``caches`` hold before the shortest linear attention
    cache is full; None when every attention cache is a ring, which never
    fills, or there is none (a recurrent state never fills).  ``cuts``:
    each layer's ``cache_cut.CacheCut`` when the caches are a rank's
    blocks."""
    lens = []
    cuts = cuts or [None] * len(caches)
    for c, kind, cut in zip(caches, layer_kinds(cfg), cuts, strict=True):
        a = attention_cache(c, kind)
        if a is not None and not _is_ring(a, block_window(kind, cfg,
                                                          long_context), cut):
            lens.append(attn_lib.cache_length(a, cut))
    return min(lens) if lens else None


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The block kind of each layer: layer ``i·P + j`` is pattern slot
    ``j`` of super-block ``i``."""
    P = len(cfg.block_pattern)
    return [cfg.block_pattern[i % P] for i in range(cfg.num_layers)]


def init_block(cfg: ModelConfig, kind: str, generator: torch.Generator, *,
               device=None, dtype=torch.float32,
               cut_expert=None) -> Dict[str, Any]:
    """One block of ``kind``, drawn from ``generator`` in a fixed order:
    ln1, then attention, ln2 and the MLP, or the MoE layer and the shared
    experts' MLP; ``rwkv``: ln1, the time mix, ln2, the MLP; ``mamba``:
    ln1, the Mamba-2 block, and for ``mamba_sa`` then ``sa_ln`` and the
    LoRA (``sa_lora_b`` zero, as in the reference).  Each leaf is cast to
    ``dtype`` right after its draw (the f32 leaves excepted);
    ``cut_expert(name, leaf)`` keeps a rank's block of each expert leaf
    (``moe.init_moe_params``)."""
    d = cfg.d_model
    kw = dict(device=device, dtype=dtype)
    if kind == "rwkv":
        return {"ln1": torch.zeros((d,), device=device),
                "rwkv": rwkv6.init_rwkv_block(generator, cfg.rwkv, d, **kw),
                "ln2": torch.zeros((d,), device=device),
                "mlp": layers.init_mlp(generator, d, cfg.d_ff, cfg.act,
                                       **kw)}
    if kind in ("mamba", "mamba_sa"):
        blk = {"ln1": torch.zeros((d,), device=device),
               "mamba": mamba2.init_mamba_block(generator, cfg.ssm, d, **kw)}
        if kind == "mamba_sa":
            blk["sa_ln"] = torch.zeros((d,), device=device)
            blk["sa_lora_a"] = draw(generator, (d, LORA_R), d ** -0.5, **kw)
            blk["sa_lora_b"] = torch.zeros((LORA_R, d), **kw)
        return blk
    blk = {"ln1": torch.zeros((d,), device=device),
           "attn": attn_lib.init_attention(generator, cfg.attention, d, **kw),
           "ln2": torch.zeros((d,), device=device)}
    if kind == "moe":
        m = cfg.moe
        f = m.d_ff_expert or cfg.d_ff
        blk["moe"] = moe_lib.init_moe_params(generator, m, d, f,
                                             m.num_experts, act=cfg.act,
                                             cut=cut_expert, **kw)
        if m.num_shared_experts:
            blk["shared_mlp"] = layers.init_mlp(
                generator, d, f * m.num_shared_experts, cfg.act, **kw)
    else:
        blk["mlp"] = layers.init_mlp(generator, d, cfg.d_ff, cfg.act, **kw)
    return blk


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device=None, dtype=torch.float32,
                layout=None) -> Dict[str, Any]:
    """Random parameters in the port's tree layout, drawn in a fixed order
    from ``generator``, layer by layer (:func:`init_block`), then the
    embedding table (none for a frontend config), the head (untied, or a
    frontend's) and zamba2's shared attention block (``mamba_sa``
    configs).  With ``dtype`` each leaf is cast right after its draw (the
    f32 leaves excepted): the same values as the f32 tree cast
    afterwards, with one f32 leaf alive at a time.  ``layout`` (a
    ``launch/shard.Layout``) keeps the rank's block of every leaf: each
    expert leaf right after its draw, every other leaf of a layer (and
    the embedding, the head) right after the layer is drawn, so the
    values are those of the unsharded draw and the whole model is never
    held."""
    _check_supported(cfg)
    d = cfg.d_model
    kw = dict(device=device, dtype=dtype)

    def keep(path, t):
        return t if layout is None else layout.cut_tree(t, path,
                                                        experts=False)

    def cut_expert(i):
        if layout is None:
            return None
        return lambda name, t: layout.cut(f"blocks/{i}/moe/{name}", t)
    params = {"blocks": [keep(f"blocks/{i}", init_block(
        cfg, kind, generator, cut_expert=cut_expert(i), **kw))
        for i, kind in enumerate(layer_kinds(cfg))],
        "final_norm": torch.zeros((d,), device=device)}
    if cfg.frontend is None:
        params["embed"] = keep("embed", draw(
            generator, (cfg.vocab_size, d), d ** -0.5, **kw))
    if untied_head(cfg):
        params["lm_head"] = keep("lm_head", draw(
            generator, (d, cfg.vocab_size), d ** -0.5, **kw))
    if "mamba_sa" in cfg.block_pattern:
        params["shared_attn"] = keep("shared_attn", {
            "ln": torch.zeros((d,), device=device),
            "attn": attn_lib.init_attention(generator, cfg.attention, d,
                                            **kw)})
    return params


def expert_leaf_mask(params: Dict[str, Any]) -> Dict[str, Any]:
    """A tree of ``params``' structure: True at the expert leaves of the
    ``moe`` blocks (sharded over the model axis), False elsewhere
    (replicated on every rank)."""
    mask = tree.map_(lambda _: False, params)
    for blk in mask["blocks"]:
        for k in EXPERT_LEAVES:
            if k in blk.get("moe", {}):
                blk["moe"][k] = True
    return mask


def untied_head(cfg: ModelConfig) -> bool:
    """Whether the tree holds an ``lm_head``: an untied config's, and
    always a frontend's, which has no table to tie it to."""
    return not cfg.tie_embeddings or cfg.frontend is not None


def embed_inputs(params: Dict[str, Any], cfg: ModelConfig,
                 inputs: torch.Tensor, dtype, layout=None) -> torch.Tensor:
    """The reference's ``_embed_inputs`` on one device: token ids (B, S)
    through the table (gathered whole by ``layout`` when it is stored
    sharded), or a frontend's precomputed (B, S, d) embeddings cast to
    ``dtype``."""
    if cfg.frontend is not None:
        return inputs.to(dtype)
    return layers.embed(_whole(params, "embed", layout, dtype), inputs,
                        dtype, cfg.scale_embeddings)


def _whole(params: Dict[str, Any], name: str, layout, dtype):
    """The top-level leaf ``name``, gathered whole by ``layout`` in
    ``dtype``."""
    t = params[name]
    return t if layout is None else layout.whole(t, name, dtype)


def _leaf(name: str, t: torch.Tensor, dtype, device) -> nn.Parameter:
    dt = torch.float32 if name in _F32_LEAVES else dtype
    return nn.Parameter(t.to(device=device, dtype=dt), requires_grad=False)


def init_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
               *, long_context: bool = False, dtype=torch.bfloat16,
               device=None) -> Dict[str, Any]:
    """One ``kind`` layer's cache (the reference's ``init_caches``, one
    layer): attention ``{k, v, pos}`` of ``min(cache_len, window)``
    positions for a windowed layer (a ring when that is the window) and
    ``cache_len`` otherwise; ``{"rwkv": {s, x_last}}``; ``{"mamba": {s,
    conv, pos}}``, with the shared attention's ``"sa"`` for ``mamba_sa``.
    The recurrent states are f32; every position a 0-d int32 tensor on
    the device."""
    def attention():
        win = block_window(kind, cfg, long_context)
        L = cache_len if win is None else min(cache_len, win)
        return attn_lib.init_cache(cfg.attention, batch, L, cfg.d_model,
                                   dtype, device)
    if kind == "rwkv":
        return {"rwkv": rwkv6.init_rwkv_state(cfg.rwkv, batch, cfg.d_model,
                                              device)}
    if kind in ("mamba", "mamba_sa"):
        c = {"mamba": mamba2.init_mamba_state(cfg.ssm, batch, cfg.d_model,
                                              device)}
        if kind == "mamba_sa":
            c["sa"] = attention()
        return c
    return attention()


def _write_state(cache: Dict[str, torch.Tensor],
                 new: Dict[str, torch.Tensor], cut=None) -> None:
    """Copy a recurrent state into its cache's tensors, in place (the new
    tensors are never views of the cache's, so no copy reads what an
    earlier one wrote).  ``cut`` (an ``cache_cut.CacheCut``): the cache
    is this rank's block over ``model`` and ``new`` a prefill's whole
    state of the rank's rows, of which the block is written (a decode
    step's new state is the block already: ``cut=None``)."""
    for name, t in new.items():
        dim = None if cut is None else cut.dim(name)
        cache[name].copy_(t if dim is None else cut.take(t, dim))


def _attention(p, h, cfg: ModelConfig, window, *, positions, cache,
               decode: bool, causal: bool, block=None, cut=None):
    """Attention over ``window``: a decode step into ``cache``, or a full
    pass that fills ``cache`` when given (context-parallel over ``block``'s
    row group when it splits rows); ``cut`` (an ``cache_cut.CacheCut``):
    the cache is the rank's block over ``model``.  Returns (y, cache)."""
    if decode:
        return attn_lib.decode_attention(p, h, cache, cfg.attention,
                                         ring=_is_ring(cache, window, cut),
                                         window=window, cut=cut)
    a, kv = attn_lib.full_attention(p, h, cfg.attention, positions=positions,
                                    causal=causal, window=window,
                                    block=block)
    if cache is not None:
        cache = attn_lib.fill_cache(cache, kv,
                                    ring=_is_ring(cache, window, cut),
                                    cut=cut)
    return a, cache


def block_forward(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, *,
                  kind: str, positions=None, cache=None,
                  decode: bool = False, long_context: bool = False,
                  noise: Optional[torch.Tensor] = None,
                  shared: Optional[Dict[str, Any]] = None, mesh=None,
                  served=None, block=None,
                  expert_tp: bool = False, cut=None):
    """One ``kind`` block over its parameter dict ``p`` (see the module
    docstring), pre-norm residuals: attention over the kind's window
    (:func:`block_window`), then the MLP or the MoE layer plus the shared
    experts' MLP (``moe``); ``noise`` is a MoE layer's gate draw;
    ``shared`` the tree's ``shared_attn`` (``mamba_sa``); ``mesh`` runs
    the MoE layer across its ranks: over the rank's own tokens, or with
    ``served`` (serving: ``moe.served_tokens``' answer) over its block of
    the reference's tokens — a group name (``model``, ``data``,
    ``world``) whose ranks hold them alike (``moe.replicated_moe_apply``),
    or a ``moe.TokenRoute`` (``moe.routed_moe_apply``); with
    ``expert_tp`` (a served model
    whose layout stores the experts' f-slice) a decode step's runs expert
    TP over the data group on it.  ``block`` (a
    ``launch/mesh.TokenBlock``) splitting rows (``n > 1``): x is this
    rank's chunk of its rows, attention runs context-parallel over the
    row group, and a recurrent block (``rwkv``, ``mamba``, ``mamba_sa``)
    gathers its input's whole rows over the group, runs them and keeps
    its chunk (:func:`_whole_rows`).  ``cut`` (an
    ``cache_cut.CacheCut``): the layer's caches are the rank's blocks
    over ``model`` (its attention cache's form, its states' dims).  Returns (x, cache, aux); a block
    without a MoE layer has no aux loss (None: the reference adds its
    zero)."""
    if kind in ("rwkv", "mamba", "mamba_sa") and block is not None \
            and block.n > 1:
        return _whole_rows(p, x, cfg, kind, block, cache, decode,
                           long_context, shared, cut)
    if kind == "rwkv":
        return _rwkv_block(p, x, cfg, cache, decode, cut)
    if kind in ("mamba", "mamba_sa"):
        return _mamba_block(p, x, cfg, kind, cache, decode, positions,
                            long_context, shared, cut)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, cache = _attention(p["attn"], h, cfg,
                          block_window(kind, cfg, long_context),
                          positions=positions, cache=cache, decode=decode,
                          causal=not cfg.encoder_only, block=block, cut=cut)
    x = x + a
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" not in p:
        return x + layers.apply_mlp(p["mlp"], h, cfg.act), cache, None
    kw = dict(num_experts=cfg.moe.num_experts, act=cfg.act, noise=noise,
              expert_tp_axis="data" if expert_tp and decode else None)
    if isinstance(served, moe_lib.TokenRoute):
        y, aux, _ = moe_lib.routed_moe_apply(mesh, cfg.moe, p["moe"], h,
                                             served, **kw)
    elif served is not None:
        y, aux, _ = moe_lib.replicated_moe_apply(
            mesh, cfg.moe, p["moe"], h, group=served, **kw)
    else:
        y, aux, _ = moe_lib.sharded_moe_apply(mesh, cfg.moe, p["moe"], h,
                                              **kw)
    if "shared_mlp" in p:
        y = y + layers.apply_mlp(p["shared_mlp"], h, cfg.act)
    return x + y, cache, aux


def _whole_rows(p, x, cfg: ModelConfig, kind: str, block, cache,
                decode: bool, long_context: bool, shared, cut=None):
    """A recurrent block over a split row: its input's chunks gathered over
    the row group into whole rows (``launch/shard.row_gather``: the
    gradient reduce-scattered back), the block run over them, this rank's
    chunk of the output kept — the gather XLA inserts for these blocks in
    the reference (``shard_act``), not a parallel scan.  A prefill fills
    ``cache`` from the whole rows: the rank's block by ``cut`` of the
    state of its rows, and of ``mamba_sa``'s attention cache."""
    if decode:
        raise ValueError(f"a {kind} block over a split row runs full "
                         f"passes only (no decode step)")
    from repro_torch.launch import shard
    xw = shard.row_gather(x, block, dim=1)
    if kind == "rwkv":
        y, cache, _ = _rwkv_block(p, xw, cfg, cache, False, cut)
    else:
        pos = torch.arange(block.S, dtype=torch.int32, device=x.device)
        y, cache, _ = _mamba_block(p, xw, cfg, kind, cache, False, pos,
                                   long_context, shared, cut)
    return y[:, block.seq], cache, None


def _rwkv_block(p, x, cfg: ModelConfig, cache, decode: bool, cut=None):
    """The time mix over ln1, then ln2 and the MLP as the channel mix.
    The cache keeps the final state and ``x_last``, the last token's
    normed input (what the next token's shift reads); ``cut``: the
    state is the rank's block over ``model``."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if decode:
        y, state = rwkv6.rwkv_decode_step(p["rwkv"], h, cache["rwkv"],
                                          cfg.rwkv, cut)
        _write_state(cache["rwkv"], state)
    else:
        y, s = rwkv6.rwkv_time_mix(p["rwkv"], h, cfg.rwkv)
        if cache is not None:
            _write_state(cache["rwkv"], {"s": s, "x_last": h[:, -1].float()},
                         cut)
    x = x + y
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + layers.apply_mlp(p["mlp"], h, cfg.act), cache, None


def _mamba_block(p, x, cfg: ModelConfig, kind: str, cache, decode: bool,
                 positions, long_context: bool, shared, cut=None):
    """The Mamba-2 block over ln1; for ``mamba_sa`` then the shared
    attention block over ``sa_ln`` + the layer's LoRA + the shared
    ``ln``.  ``cut``: the layer's caches are the rank's blocks over
    ``model`` (the state's and the shared attention's)."""
    d = cfg.d_model
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if decode:
        y, state = mamba2.mamba_decode_step(p["mamba"], h, cache["mamba"],
                                            cfg.ssm, d, cut)
        _write_state(cache["mamba"], state)
    else:
        y, state = mamba2.mamba_forward(p["mamba"], h, cfg.ssm, d)
        if cache is not None:
            _write_state(cache["mamba"], state, cut)
    x = x + y
    if kind == "mamba_sa":
        h = layers.rms_norm(x, p["sa_ln"], cfg.norm_eps)
        h = h + (h @ p["sa_lora_a"].to(h.dtype)) @ p["sa_lora_b"].to(h.dtype)
        h = layers.rms_norm(h, shared["ln"], cfg.norm_eps)
        a, _ = _attention(shared["attn"], h, cfg,
                          block_window(kind, cfg, long_context),
                          positions=positions,
                          cache=None if cache is None else cache["sa"],
                          decode=decode, causal=True, cut=cut)
        x = x + a
    return x, cache, None


def draw_gate_noise(cfg: ModelConfig, tokens: int,
                    generator: torch.Generator, device=None
                    ) -> Optional[List[torch.Tensor]]:
    """One (tokens, E) gate draw per MoE layer, in layer order, from
    ``generator`` (``gating.draw_noise``), None in the place of a layer
    without one; None when the gate draws nothing."""
    if not noisy(cfg):
        return None
    return [gating.draw_noise(cfg.moe, (tokens, cfg.moe.num_experts),
                              generator, device) if kind == "moe" else None
            for kind in layer_kinds(cfg)]


def noisy(cfg: ModelConfig) -> bool:
    """Whether the config's gate draws noise (``gating.needs_noise``)."""
    return cfg.moe is not None and gating.needs_noise(cfg.moe)


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig,
            *, caches=None, remat: str = "none",
            noise: Optional[Sequence[torch.Tensor]] = None,
            long_context: bool = False, mesh=None,
            served=None, layout=None, block=None,
            cuts=None) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """Full-sequence pass (training, prefill) over a parameter tree — the
    f32 masters, or a :class:`Transformer`'s compute-dtype copy — with
    every weight cast to ``cfg.dtype`` at its use, as the reference's
    ``forward``.  tokens (B, S) — or a frontend's (B, S, d) embeddings —
    → (hidden (B, S, d), aux, caches);
    ``caches`` (one per layer) are filled in place.  ``long_context``
    caps the ``global`` layers to ``local_window`` (:func:`block_window`).
    ``mesh`` (a ``launch/mesh.Mesh``) runs the ``moe`` blocks across its
    ranks: ``tokens`` are this rank's token block, ``block`` (a
    ``launch/mesh.TokenBlock``; None: whole rows from position 0), whose
    positions they take and whose row group, when ranks share a row,
    every attending block attends over (context parallelism) and every
    recurrent block gathers its whole rows over; ``params`` hold the
    rank's experts, and ``noise`` its rows of each layer's draw;
    ``served`` (serving) brings the ``moe`` blocks' tokens to the
    reference's blocks (:func:`block_forward`).  ``cuts`` (serving across
    ranks): each layer's
    ``cache_cut.CacheCut`` of its cache, the rank's block.  ``layout`` (a
    ``launch/shard.Layout``) says how ``params`` are stored across the
    ranks; when it gathers leaves (FSDP) every block runs in a
    ``torch.utils.checkpoint`` region that gathers its weights first
    (module docstring), so ``remat="none"`` then recomputes each block
    as ``"block"`` does.

    ``noise`` holds one gate draw per layer (:func:`draw_gate_noise`);
    a noisy gate without it draws its own from a generator seeded 0 on
    the device, as the reference falls back to ``PRNGKey(0)`` (the same
    distribution, not JAX's bits).

    ``remat``: ``"block"`` and ``"full"`` both wrap each layer in
    ``torch.utils.checkpoint`` (non-reentrant), which keeps only the
    layer's inputs and recomputes the whole block in the backward — in the
    reference too both recompute the whole block (``jax.checkpoint`` with
    its default policy saves nothing inside it), so nothing tells the two
    apart in the port either.  The layer's forward kernels run twice a
    step under them (the gate, the gather, the grouped matmul and, past
    ``q_chunk``, the flash forward); its backward kernels once.  The gate
    noise is an input of the block, drawn before the forward: the
    recomputation routes every token as the forward did, and no RNG
    state is saved or restored (``preserve_rng_state=False``)."""
    _check_supported(cfg)
    if remat not in REMAT_MODES:
        raise ValueError(f"remat={remat!r} not in {REMAT_MODES}")
    if remat != "none" and caches is not None:
        raise ValueError("remat recomputes blocks in a backward; a pass "
                         "that fills caches has none")
    if caches is not None and layout is not None and torch.is_grad_enabled():
        raise ValueError("a pass that fills caches over gathered weights "
                         "runs without gradients (torch.inference_mode)")
    dtype = getattr(torch, cfg.dtype)
    if layout is not None and not layout.gathered:
        layout = None                 # every leaf is used as stored
    x = embed_inputs(params, cfg, tokens, dtype, layout)
    B, S = x.shape[:2]
    if block is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    else:
        positions = block.positions(x.device)
        if positions.shape[0] != S:
            raise ValueError(f"tokens hold {S} positions a row, the token "
                             f"block {block.seq.start}:{block.seq.stop}")
        if block.n == 1:
            block = None
    if noise is None and noisy(cfg):
        gen = torch.Generator(device=x.device).manual_seed(0)
        noise = draw_gate_noise(cfg, B * S, gen, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    shared = params.get("shared_attn")
    for i, (p, kind) in enumerate(zip(params["blocks"], layer_kinds(cfg),
                                      strict=True)):
        nz = None if noise is None else noise[i]
        cache = None if caches is None else caches[i]
        cut = None if cuts is None else cuts[i]
        if remat == "none" and layout is None:
            x, _, a = block_forward(
                p, x, cfg, kind=kind, positions=positions, noise=nz,
                cache=cache, long_context=long_context, shared=shared,
                mesh=mesh, served=served, block=block, cut=cut)
        elif layout is not None and not torch.is_grad_enabled():
            # serving: the block's stored leaves gathered whole for it
            # alone, freed when it returns
            x, _, a = gathered_block(
                layout, i, p, x, cfg, kind=kind, positions=positions,
                noise=nz, cache=cache, long_context=long_context,
                shared=shared, mesh=mesh, served=served, block=block,
                cut=cut)
        else:
            x, a = checkpoint(_remat_block, p, x, positions, nz, cfg, kind,
                              long_context, shared, mesh, served,
                              layout, i, block, use_reentrant=False,
                              preserve_rng_state=False)
        if a is not None:
            aux = aux + a
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux, caches


def gathered_block(layout, index: int, p, x, cfg: ModelConfig, *,
                   experts: bool = True, **kw):
    """:func:`block_forward` of layer ``index`` over its leaves gathered
    whole by ``layout`` in the compute dtype (and zamba2's shared block),
    the gathered copies alive only for the block; ``experts=False``
    keeps the expert leaves as stored (a decode step's expert TP)."""
    dt = getattr(torch, cfg.dtype)
    p = layout.whole(p, f"blocks/{index}", dt, experts=experts)
    if kw.get("shared") is not None:
        kw["shared"] = layout.whole(kw["shared"], "shared_attn", dt)
    return block_forward(p, x, cfg, **kw)


def _remat_block(p, x, positions, noise, cfg, kind, long_context, shared,
                 mesh, served, layout=None, index=0, block=None):
    if layout is not None:
        # ZeRO-3: the whole weights exist only inside this region
        dt = getattr(torch, cfg.dtype)
        p = layout.whole(p, f"blocks/{index}", dt)
        if shared is not None:
            shared = layout.whole(shared, "shared_attn", dt)
    x, _, aux = block_forward(p, x, cfg, kind=kind, positions=positions,
                              noise=noise, long_context=long_context,
                              shared=shared, mesh=mesh, served=served,
                              block=block)
    return x, aux


def head_params(params: Dict[str, Any], cfg: ModelConfig,
                layout=None) -> Dict[str, Any]:
    """The leaf :func:`logits_from_hidden` reads (``lm_head``, or the tied
    ``embed``), gathered whole by ``layout`` when it is stored sharded."""
    name = "lm_head" if untied_head(cfg) else "embed"
    return {name: _whole(params, name, layout, getattr(torch, cfg.dtype))}


def logits_from_hidden(params: Dict[str, Any], cfg: ModelConfig,
                       h: torch.Tensor) -> torch.Tensor:
    """The unembedding in ``h``'s dtype (the head cast at its use)."""
    w = params["lm_head"] if untied_head(cfg) else params["embed"].T
    logits = h @ w.to(h.dtype)
    if cfg.final_softcap:
        logits = layers.softcap(logits.float(), cfg.final_softcap)
    return logits


class Block(nn.Module):
    """One block's serving weights (run by :func:`block_forward`), the
    parameter dict's keys as attributes: a leaf as a parameter (``ln1``,
    ``sa_lora_a``, ...), a sub-tree as a ``ParameterDict`` (``attn``,
    ``mlp``, ``moe``, ``rwkv``, ``mamba``, ...)."""

    def __init__(self, p: Dict[str, Any], dtype, device):
        super().__init__()
        self.names = list(p)
        for k, v in p.items():
            setattr(self, k, nn.ParameterDict(
                {n: _leaf(n, t, dtype, device) for n, t in v.items()})
                if isinstance(v, dict) else _leaf(k, v, dtype, device))

    def tree(self) -> Dict[str, Any]:
        def one(k):
            v = getattr(self, k)
            return dict(v) if isinstance(v, nn.ParameterDict) else v
        return {k: one(k) for k in self.names}


class ServedCaches(list):
    """A rank's per-layer cache blocks (a list, as :func:`init_cache`'s
    per layer) with the ``launch/shard.CacheLayout`` they are stored by
    (``layout``): :meth:`Transformer.init_caches` with a mesh."""

    def __init__(self, caches=(), layout=None):
        super().__init__(caches)
        self.layout = layout


class Transformer(nn.Module):
    """The transformer for inference, on one device or across the ranks of
    a mesh.

    ``Transformer(cfg)`` runs on ``cuda`` (raising without a GPU) unless
    ``device="cpu"`` is passed.  ``params`` is an f32 tree from
    :func:`init_params` or ``convert.params_from_numpy``, copied into the
    compute dtype; without it the weights are drawn from a
    ``torch.Generator`` seeded with ``seed`` on the target device straight
    into the compute dtype, leaf by leaf (:func:`init_params` with
    ``dtype``): the values of the f32 tree cast afterwards, without holding
    that tree.

    With ``mesh`` (a ``launch/mesh.Mesh``; ``device`` defaults to the
    mesh's) the model is this rank's share, stored by the reference's
    serving rule (``launch/shard.serve_layout_for``, :attr:`layout`): the
    experts' E over ``model`` and, when a decode step runs expert TP
    (``REPRO_EXPERT_TP``, read here), their f over ``data``; the dense
    leaves whole unless ``fsdp`` (None: ``needs_fsdp`` over the served
    tree at the reference's 4e9 budget; an explicit value is honored).
    Drawn weights are drawn whole leaf by leaf and cut, so their values
    are one process's; a given ``params`` must already be the rank's
    share (``convert.params_from_numpy(..., mesh, serving=True)``).
    :meth:`forward` (the prefill) gathers each block's stored leaves
    whole inside that block and frees them after it; :meth:`decode_step`
    keeps the experts' f-slice (expert TP) and gathers only what
    ``fsdp`` shards.  The activations and caches are the reference's
    layout (module docstring): :meth:`forward` takes the whole batch on
    every rank and runs the rank's block of it
    (``launch/mesh.serve_block``), :meth:`init_caches` allocates the
    rank's blocks (:meth:`cache_layout`), and :meth:`decode_step` runs the
    rank's rows.
    The step builders' keys hold the model, and with it the mesh and the
    layout.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0,
                 params: Optional[Dict[str, Any]] = None, mesh=None,
                 fsdp: Optional[bool] = False):
        super().__init__()
        _check_supported(cfg)
        from repro_torch.launch import shard
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self.layout = shard.serve_layout_for(cfg, mesh, fsdp)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen, device=self.device,
                                 dtype=self.dtype, layout=self.layout)
        elif self.layout is not None:
            self._check_share(params)
        self.blocks = nn.ModuleList(
            Block(p, self.dtype, self.device) for p in params["blocks"])
        self.final_norm = _leaf("final_norm", params["final_norm"],
                                self.dtype, self.device)
        self.embed = (None if cfg.frontend is not None else
                      _leaf("embed", params["embed"], self.dtype,
                            self.device))
        self.lm_head = (_leaf("lm_head", params["lm_head"], self.dtype,
                              self.device) if untied_head(cfg) else None)
        self.shared_attn = (Block(params["shared_attn"], self.dtype,
                                  self.device)
                            if "shared_attn" in params else None)
        self._cache_layouts: Dict[tuple, Any] = {}

    def _check_share(self, params) -> None:
        """Raise unless every leaf of ``params`` has the shape of this
        rank's block by :attr:`layout`."""
        from repro_torch.convert import param_shapes
        from repro_torch.launch.mesh import tree_paths
        whole = dict(tree_paths(param_shapes(self.cfg)))
        bad = [f"{p}: {tuple(t.shape)} != "
               f"{self.layout.block_shape(p, whole[p].shape)}"
               for p, t in tree_paths(params)
               if tuple(t.shape) != self.layout.block_shape(
                   p, whole[p].shape)]
        if bad:
            raise ValueError(
                f"Transformer(mesh={self.mesh.describe()}): params are not "
                f"this rank's share (fsdp={self.layout.fsdp}, expert_tp="
                f"{self.layout.expert_tp}): {bad[:4]} "
                f"(convert.params_from_numpy(..., mesh, serving=True))")

    @property
    def layout_key(self) -> Tuple[bool, bool]:
        """``(fsdp, expert_tp)`` of the stored layout ((False, False)
        without a mesh): the step cache's keys carry it."""
        if self.layout is None:
            return False, False
        return self.layout.fsdp, self.layout.expert_tp

    def _gathering(self):
        """The layout when it gathers any leaf for use, else None."""
        return (self.layout if self.layout is not None
                and self.layout.gathered else None)

    def _shared(self) -> Optional[Dict[str, Any]]:
        return None if self.shared_attn is None else self.shared_attn.tree()

    def tree(self) -> Dict[str, Any]:
        """The served weights as a parameter tree (the compute-dtype copy,
        the f32 leaves f32), with the keys :func:`init_params` gives: the
        rank's stored blocks across ranks."""
        out = {"blocks": [blk.tree() for blk in self.blocks],
               "final_norm": self.final_norm}
        for name in ("embed", "lm_head"):
            if getattr(self, name) is not None:
                out[name] = getattr(self, name)
        if self.shared_attn is not None:
            out["shared_attn"] = self._shared()
        return out

    def stored_bytes(self) -> int:
        """Bytes of this rank's stored weights."""
        return sum(t.numel() * t.element_size()
                   for t in tree.leaves(self.tree()))

    def cache_layout(self, batch: int, cache_len: int,
                     long_context: bool = False):
        """This rank's ``launch/shard.CacheLayout`` of caches of ``batch``
        rows and ``cache_len`` positions (None without a mesh)."""
        if self.mesh is None:
            return None
        key = (batch, cache_len, long_context)
        if key not in self._cache_layouts:
            from repro_torch.launch import shard
            self._cache_layouts[key] = shard.cache_layout_for(
                self.cfg, self.mesh, batch, cache_len, long_context)
        return self._cache_layouts[key]

    def served_tokens(self, rows: slice, batch: int, seq: int,
                      split: bool):
        """How a ``moe`` block meets the reference's tokens for a served
        block of ``rows`` of ``batch`` and ``seq`` positions a row, split
        over ``model`` or not (``moe.served_tokens``; a route with its
        process group attached); None on one device."""
        if self.mesh is None:
            return None
        shape = (self.mesh.shape["data"], self.mesh.shape["model"])
        mode, how = moe_lib.served_tokens(
            shape, self.mesh.rank, batch, seq,
            rows.stop - rows.start < batch, split)
        if mode == "route":
            return dataclasses.replace(how, group=(
                self.mesh.model_group if how.axis == "model" else None))
        return how

    def init_caches(self, batch: int, cache_len: int, *,
                    long_context: bool = False) -> List[Dict[str, Any]]:
        """One cache per layer (:func:`init_cache`): attention caches of
        ``min(cache_len, window)`` positions for a windowed layer (a ring
        when that is the window) and ``cache_len`` for the others, the
        recurrent states of ``rwkv`` and ``mamba`` layers; each position a
        0-d int32 tensor on the device.  With a mesh, this rank's blocks
        of them (:meth:`cache_layout`: the reference's ``cache_shardings``
        for every leaf)."""
        layout = self.cache_layout(batch, cache_len, long_context)
        if layout is not None:
            return ServedCaches(layout.empty(self.device), layout)
        return [init_cache(self.cfg, kind, batch, cache_len,
                           long_context=long_context, dtype=self.dtype,
                           device=self.device)
                for kind in layer_kinds(self.cfg)]

    def _cache_layout_of(self, caches):
        """The ``launch/shard.CacheLayout`` ``caches`` (a rank's blocks, from
        :meth:`init_caches`) are stored by."""
        lay = getattr(caches, "layout", None)
        if lay is None:
            raise ValueError(
                f"on mesh {self.mesh.describe()} a served pass takes this "
                f"rank's cache blocks from Transformer.init_caches")
        return lay

    def forward(self, tokens: torch.Tensor, *, caches=None,
                cfg: Optional[ModelConfig] = None,
                long_context: bool = False, last: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        """Full-sequence pass (prefill).  tokens (B, S), or a frontend's
        (B, S, d) embeddings → (hidden (B,S,d), aux_loss, caches);
        ``caches`` from :meth:`init_caches` are filled in place.  ``cfg``
        overrides the served config (e.g. its dispatch).  ``last``: the
        hidden of each row's last position only, (B, 1, d).

        With a mesh every rank passes the whole batch and runs its block
        of it (``launch/mesh.serve_block``): the hidden returned is the block's
        (its rows, its chunk of their positions); with ``last`` the rows'
        last positions, broadcast over the model group from its last rank
        (which holds them) when the positions are split."""
        cfg = cfg or self.cfg
        if self.mesh is None:
            h, aux, caches = forward(self.tree(), tokens, cfg, caches=caches,
                                     long_context=long_context)
            return (h[:, -1:] if last else h), aux, caches
        from repro_torch.launch.mesh import serve_block
        B, S = tokens.shape[:2]
        blk = serve_block(self.mesh, B, S)
        noise = None
        if noisy(cfg):
            gen = torch.Generator(device=tokens.device).manual_seed(0)
            whole = draw_gate_noise(cfg, B * S, gen, tokens.device)
            noise = [None if n is None else n.reshape(B, S, -1)[
                blk.rows, blk.seq].reshape(-1, n.shape[-1]) for n in whole]
        cuts = None
        if caches is not None:
            lay = self._cache_layout_of(caches)
            if lay.batch != B:
                raise ValueError(f"caches of {lay.batch} rows for a batch "
                                 f"of {B}")
            cuts = lay.cuts()
        h, aux, caches = forward(
            self.tree(), tokens[blk.rows, blk.seq], cfg, caches=caches,
            long_context=long_context, mesh=self.mesh,
            served=self.served_tokens(blk.rows, B, S, blk.n > 1),
            layout=self._gathering(), block=blk, cuts=cuts, noise=noise)
        if not last:
            return h, aux, caches
        h = h[:, -1:]
        if blk.n > 1:
            from repro_torch.core import alltoall
            M = self.mesh.shape["model"]
            src = self.mesh.data_index * M + M - 1
            h = alltoall.broadcast(h, self.mesh.model_group, src, M, "model")
        return h, aux, caches

    def logits_from_hidden(self, h: torch.Tensor) -> torch.Tensor:
        return logits_from_hidden(
            head_params({"embed": self.embed, "lm_head": self.lm_head},
                        self.cfg, self._gathering()), self.cfg, h)

    def decode_step(self, token: torch.Tensor, caches,
                    cfg: Optional[ModelConfig] = None, *,
                    long_context: bool = False,
                    noise: Optional[Sequence[torch.Tensor]] = None):
        """One-token serve step: token (B, 1), or a frontend's (B, 1, d)
        embeddings → (logits (B, 1, V), caches), the caches updated in
        place.  ``noise``: a noisy gate's draws (:func:`decode_noise`),
        drawn here when not given; the step reads nothing on the host.
        Across ranks ``token`` is this rank's rows and ``caches`` its
        blocks (:meth:`init_caches`); each attention layer attends over
        the rank's cache block (its kv heads, positions or channels),
        each recurrent layer steps the rank's block of its state (the
        layer's ``cache_cut.CacheCut``), the ``moe`` blocks route the
        reference's tokens
        (:meth:`served_tokens`) and run expert TP on the stored f-slice when
        the layout stores one, and the leaves ``fsdp`` shards are gathered
        block by block."""
        cfg = cfg or self.cfg
        layout = self._gathering()
        tp = self.layout is not None and self.layout.expert_tp
        x = embed_inputs({"embed": self.embed}, cfg, token, self.dtype,
                         layout)
        if noise is None:
            noise = decode_noise(cfg, x.shape[0], x.device)
        shared = self._shared()
        cuts = served = None
        if self.mesh is not None:
            lay = self._cache_layout_of(caches)
            cuts = lay.cuts()
            served = self.served_tokens(lay.rows, lay.batch, 1, False)
        for i, (blk, cache, kind) in enumerate(zip(
                self.blocks, caches, layer_kinds(cfg), strict=True)):
            kw = dict(kind=kind, cache=cache, decode=True,
                      long_context=long_context,
                      noise=None if noise is None else noise[i],
                      shared=shared, mesh=self.mesh, served=served,
                      expert_tp=tp, cut=None if cuts is None else cuts[i])
            if layout is None:
                x, _, _ = block_forward(blk.tree(), x, cfg, **kw)
            else:
                x, _, _ = gathered_block(layout, i, blk.tree(), x, cfg,
                                         experts=not tp, **kw)
        x = layers.rms_norm(x, self.final_norm, cfg.norm_eps)
        return self.logits_from_hidden(x), caches


def decode_noise(cfg: ModelConfig, batch: int, device
                 ) -> Optional[List[torch.Tensor]]:
    """A decode step's gate draws for ``batch`` tokens: the same at every
    step, from a generator seeded 0 on ``device`` (the reference draws
    from ``PRNGKey(0)`` at each step); None for a gate that draws
    nothing.  A captured step takes them drawn once, as an input."""
    if not noisy(cfg):
        return None
    gen = torch.Generator(device=device).manual_seed(0)
    return draw_gate_noise(cfg, batch, gen, device)
