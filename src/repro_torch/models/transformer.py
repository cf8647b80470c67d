"""Model assembly for the ``attn``, ``local``, ``global``, ``dense`` and
``moe`` block kinds — the port of ``repro/models/transformer.py`` (init,
``forward``, ``init_caches``, ``decode_step``, ``logits_from_hidden``).

Every ported kind is pre-norm attention followed by an FFN: an MLP
(``attn``, ``local``, ``global``, ``dense``) or the HetuMoE layer
(``moe``), plus the shared experts' MLP where the config has them.  Layer
``i·P + j`` is pattern slot ``j`` of super-block ``i`` (``P =
len(cfg.block_pattern)``), the order of the reference's scan over
super-blocks.  A layer's attention window is :func:`block_window`'s: the
config's ``attention.window`` (``attn``, ``dense``, ``moe``),
``local_window`` (``local``, and ``global`` with ``long_context``), else
none; a windowed layer's cache is a ring of the window's length once the
requested cache is longer.  The recurrent kinds raise.

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
step.  The router and the norm scales stay f32, as they are used.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import draw, resolve_device
from repro_torch.core import gating
from repro_torch.core import moe as moe_lib
from repro_torch.core.config import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers

# leaves used in f32 whatever the compute dtype
_F32_LEAVES = ("ln1", "ln2", "final_norm", "gate_w", "q_norm", "k_norm")
REMAT_MODES = ("none", "block", "full")
# the ported block kinds: attention + an MLP (attn, local, global, dense)
# or + the MoE layer (moe); the reference's dense is its attn under another
# name, local and global differ from it in their window only
BLOCK_KINDS = ("attn", "local", "global", "dense", "moe")
# the FFN sub-trees a block may hold
_FFN_KEYS = ("mlp", "moe", "shared_mlp")


def _check_supported(cfg: ModelConfig) -> None:
    unported = sorted(set(cfg.block_pattern) - set(BLOCK_KINDS))
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {unported} of {cfg.block_pattern} are "
            f"not ported to repro_torch yet; ported: {BLOCK_KINDS} "
            f"(ROADMAP.md)")


def block_window(kind: str, cfg: ModelConfig,
                 long_context: bool = False) -> Optional[int]:
    """The attention window of a ``kind`` layer (the reference's
    ``_block_window``): ``local_window`` for ``local`` layers, and for
    ``global`` ones in the long-context variant; else the config's."""
    if kind == "local" or (kind == "global" and long_context):
        return cfg.local_window
    return cfg.attention.window


def _is_ring(cache, window: Optional[int]) -> bool:
    """A windowed layer's cache of the window's length is a ring."""
    return window is not None and cache["k"].shape[1] == window


def linear_capacity(cfg: ModelConfig, caches,
                    long_context: bool = False) -> Optional[int]:
    """The positions ``caches`` hold before the shortest linear one is
    full; None when every layer's cache is a ring, which never fills."""
    lens = [c["k"].shape[1] for c, kind in zip(caches, layer_kinds(cfg),
                                               strict=True)
            if not _is_ring(c, block_window(kind, cfg, long_context))]
    return min(lens) if lens else None


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The block kind of each layer: layer ``i·P + j`` is pattern slot
    ``j`` of super-block ``i``."""
    P = len(cfg.block_pattern)
    return [cfg.block_pattern[i % P] for i in range(cfg.num_layers)]


def init_block(cfg: ModelConfig, kind: str, generator: torch.Generator, *,
               device=None, dtype=torch.float32) -> Dict[str, Any]:
    """One block of ``kind``, drawn from ``generator`` in a fixed order:
    ln1, attention, ln2, then the MLP, or the MoE layer and the shared
    experts' MLP.  Each leaf is cast to ``dtype`` right after its draw."""
    d = cfg.d_model
    kw = dict(device=device, dtype=dtype)
    blk = {"ln1": torch.zeros((d,), device=device),
           "attn": attn_lib.init_attention(generator, cfg.attention, d, **kw),
           "ln2": torch.zeros((d,), device=device)}
    if kind == "moe":
        m = cfg.moe
        f = m.d_ff_expert or cfg.d_ff
        blk["moe"] = moe_lib.init_moe_params(generator, m, d, f,
                                             m.num_experts, act=cfg.act, **kw)
        if m.num_shared_experts:
            blk["shared_mlp"] = layers.init_mlp(
                generator, d, f * m.num_shared_experts, cfg.act, **kw)
    else:
        blk["mlp"] = layers.init_mlp(generator, d, cfg.d_ff, cfg.act, **kw)
    return blk


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device=None, dtype=torch.float32) -> Dict[str, Any]:
    """Random parameters in the port's tree layout, drawn in a fixed order
    from ``generator``, layer by layer (:func:`init_block`), then the
    embedding table (none for a frontend config) and the head (untied,
    or a frontend's).  With ``dtype`` each leaf is cast right after its
    draw (the f32 leaves excepted): the same values as the f32 tree cast
    afterwards, with one f32 leaf alive at a time."""
    _check_supported(cfg)
    d = cfg.d_model
    kw = dict(device=device, dtype=dtype)
    params = {"blocks": [init_block(cfg, kind, generator, **kw)
                         for kind in layer_kinds(cfg)],
              "final_norm": torch.zeros((d,), device=device)}
    if cfg.frontend is None:
        params["embed"] = draw(generator, (cfg.vocab_size, d), d ** -0.5,
                               **kw)
    if untied_head(cfg):
        params["lm_head"] = draw(generator, (d, cfg.vocab_size), d ** -0.5,
                                 **kw)
    return params


def untied_head(cfg: ModelConfig) -> bool:
    """Whether the tree holds an ``lm_head``: an untied config's, and
    always a frontend's, which has no table to tie it to."""
    return not cfg.tie_embeddings or cfg.frontend is not None


def embed_inputs(params: Dict[str, Any], cfg: ModelConfig,
                 inputs: torch.Tensor, dtype) -> torch.Tensor:
    """The reference's ``_embed_inputs`` on one device: token ids (B, S)
    through the table, or a frontend's precomputed (B, S, d) embeddings
    cast to ``dtype``."""
    if cfg.frontend is not None:
        return inputs.to(dtype)
    return layers.embed(params["embed"], inputs, dtype,
                        cfg.scale_embeddings)


def _leaf(name: str, t: torch.Tensor, dtype, device) -> nn.Parameter:
    dt = torch.float32 if name in _F32_LEAVES else dtype
    return nn.Parameter(t.to(device=device, dtype=dt), requires_grad=False)


def block_forward(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, *,
                  kind: str, positions=None, cache=None,
                  decode: bool = False, long_context: bool = False,
                  noise: Optional[torch.Tensor] = None):
    """One ``kind`` block over its parameter dict ``p``: attention over
    the kind's window (:func:`block_window`), then the MLP or the MoE
    layer plus the shared experts' MLP (``moe``), pre-norm residuals;
    ``noise`` is a MoE layer's gate draw.  Returns (x, cache, aux); a
    block without a MoE layer has no aux loss (None: the reference adds
    its zero)."""
    win = block_window(kind, cfg, long_context)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if decode:
        a, cache = attn_lib.decode_attention(p["attn"], h, cache,
                                             cfg.attention,
                                             ring=_is_ring(cache, win),
                                             window=win)
    else:
        a, kv = attn_lib.full_attention(p["attn"], h, cfg.attention,
                                        positions=positions,
                                        causal=not cfg.encoder_only,
                                        window=win)
        if cache is not None:
            cache = attn_lib.fill_cache(cache, kv, ring=_is_ring(cache, win))
    x = x + a
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" not in p:
        return x + layers.apply_mlp(p["mlp"], h, cfg.act), cache, None
    y, aux, _ = moe_lib.moe_apply(cfg.moe, p["moe"], h,
                                  num_experts=cfg.moe.num_experts,
                                  act=cfg.act, noise=noise)
    if "shared_mlp" in p:
        y = y + layers.apply_mlp(p["shared_mlp"], h, cfg.act)
    return x + y, cache, aux


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
            long_context: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """Full-sequence pass (training, prefill) over a parameter tree — the
    f32 masters, or a :class:`Transformer`'s compute-dtype copy — with
    every weight cast to ``cfg.dtype`` at its use, as the reference's
    ``forward``.  tokens (B, S) — or a frontend's (B, S, d) embeddings —
    → (hidden (B, S, d), aux, caches);
    ``caches`` (one per layer) are filled in place.  ``long_context``
    caps the ``global`` layers to ``local_window`` (:func:`block_window`).

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
    dtype = getattr(torch, cfg.dtype)
    x = embed_inputs(params, cfg, tokens, dtype)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    if noise is None and noisy(cfg):
        gen = torch.Generator(device=x.device).manual_seed(0)
        noise = draw_gate_noise(cfg, B * S, gen, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (p, kind) in enumerate(zip(params["blocks"], layer_kinds(cfg),
                                      strict=True)):
        nz = None if noise is None else noise[i]
        if remat == "none":
            x, _, a = block_forward(
                p, x, cfg, kind=kind, positions=positions, noise=nz,
                cache=None if caches is None else caches[i],
                long_context=long_context)
        else:
            x, a = checkpoint(_remat_block, p, x, positions, nz, cfg, kind,
                              long_context, use_reentrant=False,
                              preserve_rng_state=False)
        if a is not None:
            aux = aux + a
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux, caches


def _remat_block(p, x, positions, noise, cfg, kind, long_context):
    x, _, aux = block_forward(p, x, cfg, kind=kind, positions=positions,
                              noise=noise, long_context=long_context)
    return x, aux


def logits_from_hidden(params: Dict[str, Any], cfg: ModelConfig,
                       h: torch.Tensor) -> torch.Tensor:
    """The unembedding in ``h``'s dtype (the head cast at its use)."""
    w = params["lm_head"] if untied_head(cfg) else params["embed"].T
    logits = h @ w.to(h.dtype)
    if cfg.final_softcap:
        logits = layers.softcap(logits.float(), cfg.final_softcap)
    return logits


class Block(nn.Module):
    """One block's serving weights (run by :func:`block_forward`): the
    norms, the attention, and the block kind's FFN — ``mlp``, or ``moe``
    with ``shared_mlp`` where the config has shared experts."""

    def __init__(self, p: Dict[str, Any], dtype, device):
        super().__init__()
        self.ln1 = _leaf("ln1", p["ln1"], dtype, device)
        self.ln2 = _leaf("ln2", p["ln2"], dtype, device)
        self.attn = nn.ParameterDict(
            {k: _leaf(k, v, dtype, device) for k, v in p["attn"].items()})
        self.ffn = [k for k in _FFN_KEYS if k in p]
        for k in self.ffn:
            setattr(self, k, nn.ParameterDict(
                {n: _leaf(n, v, dtype, device) for n, v in p[k].items()}))

    def tree(self) -> Dict[str, Any]:
        return {"ln1": self.ln1, "ln2": self.ln2, "attn": dict(self.attn),
                **{k: dict(getattr(self, k)) for k in self.ffn}}


class Transformer(nn.Module):
    """The transformer on one device, for inference.

    ``Transformer(cfg)`` runs on ``cuda`` (raising without a GPU) unless
    ``device="cpu"`` is passed.  ``params`` is an f32 tree from
    :func:`init_params` or ``convert.params_from_numpy``, copied into the
    compute dtype; without it the weights are drawn from a
    ``torch.Generator`` seeded with ``seed`` on the target device straight
    into the compute dtype, leaf by leaf (:func:`init_params` with
    ``dtype``): the values of the f32 tree cast afterwards, without holding
    that tree.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0,
                 params: Optional[Dict[str, Any]] = None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen, device=self.device,
                                 dtype=self.dtype)
        self.blocks = nn.ModuleList(
            Block(p, self.dtype, self.device) for p in params["blocks"])
        self.final_norm = _leaf("final_norm", params["final_norm"],
                                self.dtype, self.device)
        self.embed = (None if cfg.frontend is not None else
                      _leaf("embed", params["embed"], self.dtype,
                            self.device))
        self.lm_head = (_leaf("lm_head", params["lm_head"], self.dtype,
                              self.device) if untied_head(cfg) else None)

    def init_caches(self, batch: int, cache_len: int, *,
                    long_context: bool = False) -> List[Dict[str, Any]]:
        """One cache per layer, of ``min(cache_len, window)`` positions for
        a windowed layer (a ring when that is the window) and
        ``cache_len`` for the others; each position a 0-d int32 tensor on
        the device (``attention.init_cache``)."""
        out = []
        for kind in layer_kinds(self.cfg):
            win = block_window(kind, self.cfg, long_context)
            L = cache_len if win is None else min(cache_len, win)
            out.append(attn_lib.init_cache(self.cfg.attention, batch, L,
                                           self.cfg.d_model, self.dtype,
                                           self.device))
        return out

    def forward(self, tokens: torch.Tensor, *, caches=None,
                cfg: Optional[ModelConfig] = None,
                long_context: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        """Full-sequence pass (prefill).  tokens (B, S), or a frontend's
        (B, S, d) embeddings → (hidden (B,S,d), aux_loss, caches);
        ``caches`` from :meth:`init_caches` are filled in place.  ``cfg``
        overrides the served config (e.g. its dispatch)."""
        tree = {"blocks": [blk.tree() for blk in self.blocks],
                "final_norm": self.final_norm, "embed": self.embed}
        return forward(tree, tokens, cfg or self.cfg, caches=caches,
                       long_context=long_context)

    def logits_from_hidden(self, h: torch.Tensor) -> torch.Tensor:
        return logits_from_hidden({"embed": self.embed,
                                   "lm_head": self.lm_head}, self.cfg, h)

    def decode_step(self, token: torch.Tensor, caches,
                    cfg: Optional[ModelConfig] = None, *,
                    long_context: bool = False,
                    noise: Optional[Sequence[torch.Tensor]] = None):
        """One-token serve step: token (B, 1), or a frontend's (B, 1, d)
        embeddings → (logits (B, 1, V), caches), the caches updated in
        place.  ``noise``: a noisy gate's draws (:func:`decode_noise`),
        drawn here when not given; the step reads nothing on the host."""
        cfg = cfg or self.cfg
        x = embed_inputs({"embed": self.embed}, cfg, token, self.dtype)
        if noise is None:
            noise = decode_noise(cfg, x.shape[0], x.device)
        for i, (blk, cache, kind) in enumerate(zip(
                self.blocks, caches, layer_kinds(cfg), strict=True)):
            x, _, _ = block_forward(blk.tree(), x, cfg, kind=kind,
                                    cache=cache, decode=True,
                                    long_context=long_context,
                                    noise=None if noise is None else noise[i])
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
