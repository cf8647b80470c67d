"""The HetuMoE layer on one device — the port of ``repro/core/moe.py``
(``moe_block_local`` at ``model_size=1``; ``moe_apply`` is the one-device
form of ``sharded_moe_apply``).

Flow: gate → dispatch plan (one sort) → layout transform → expert FFN →
reverse transform + combine.  Every gate strategy routes (``gating``;
``noise`` and ``token_ids`` reach the gate).  ``dispatch="grouped"`` is
the dropless path
(expert-sorted (T·K, d) buffer + grouped expert matmuls); ``"sort"`` is
the paper's capacity-padded (E·C, d) layout.  The gate, the row gathers
and the grouped matmuls always go through the kernels' wrappers, which
launch the hand-written kernels on a CUDA tensor and run their plain
versions on a CPU one.  Expert parallelism, expert TP and the overlap
pipeline come with later slices.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import balance, capacity, gating, layout, tuning
from repro_torch.core.config import MoEConfig
from repro_torch.kernels import grouped_ffn as gffn


def init_moe_params(generator: torch.Generator, cfg: MoEConfig, d_model: int,
                    d_ff: int, num_experts: int, *, act: str = "swiglu",
                    dtype=torch.float32, device=None
                    ) -> Dict[str, torch.Tensor]:
    """Router (f32) + expert weights, drawn from ``generator``."""
    d_ff = cfg.d_ff_expert or d_ff

    def randn(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device)

    scale_in, scale_out = d_model ** -0.5, d_ff ** -0.5
    p = {"gate_w": randn(d_model, num_experts) * scale_in,
         "w_up": (randn(num_experts, d_model, d_ff) * scale_in).to(dtype),
         "w_out": (randn(num_experts, d_ff, d_model) * scale_out).to(dtype)}
    if act in ("swiglu", "geglu"):
        p["w_gate"] = (randn(num_experts, d_model, d_ff) * scale_in).to(dtype)
    return p


def _act(h: torch.Tensor, g: Optional[torch.Tensor], act: str):
    if act == "swiglu":
        return h * torch.nn.functional.silu(g)
    if act == "geglu":
        return h * torch.nn.functional.gelu(g, approximate="tanh")
    if act == "gelu":
        return torch.nn.functional.gelu(h, approximate="tanh")
    return torch.relu(h)


def expert_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor,
               act: str) -> torch.Tensor:
    """(E, C, d) × expert weights → (E, C, d): the sort path's batched
    expert product (an XLA einsum in the reference, not a kernel)."""
    h = torch.bmm(x, params["w_up"])
    g = torch.bmm(x, params["w_gate"]) if act in ("swiglu", "geglu") else None
    return torch.bmm(_act(h, g, act), params["w_out"])


def moe_block_local(cfg: MoEConfig, params: Dict[str, torch.Tensor],
                    x: torch.Tensor, *, num_experts: int, act: str,
                    valid: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None,
                    token_ids: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Dict[str, torch.Tensor]]:
    """x: (T, d) → (y, aux_loss, metrics) on one device.  ``cfg`` must be
    resolved (no ``"auto"``); ``noise`` (T, E) and ``token_ids`` (T,) go
    to the gate (``gating.route``)."""
    T, d = x.shape
    E = num_experts
    if not cfg.use_pallas_gate and x.device.type != "cpu":
        raise ValueError(
            f"MoEConfig.use_pallas_gate=False: the port has no layer without "
            f"its kernels on {x.device} (only a CPU tensor takes their plain "
            f"versions); set it to True")

    logits = gating.router_logits(cfg, x, params["gate_w"])
    gate = gating.route(cfg, logits, noise=noise, token_ids=token_ids)
    if valid is not None:
        # padded tokens → virtual expert E: dropped by the plan, weight 0
        gate = gate._replace(
            expert_index=torch.where(valid[:, None], gate.expert_index, E
                                     ).to(torch.int32),
            combine_weights=torch.where(valid[:, None], gate.combine_weights,
                                        0.0))

    if cfg.dispatch == "grouped":
        gplan = layout.plan_grouped(gate, E, drop_bucket=True)
        aux, metrics = balance.aux_losses(cfg, gate,
                                          expert_counts=gplan.counts,
                                          valid=valid)
        xs = layout.dispatch_grouped(x, gplan)
        ys = gffn.grouped_ffn(params, xs.to(params["w_up"].dtype),
                              gplan.offsets, act)
        y = layout.combine_grouped(ys, gplan, T)
        return y.to(x.dtype), aux, metrics

    if cfg.dispatch != "sort":
        raise NotImplementedError(
            f"dispatch={cfg.dispatch!r} is not ported to repro_torch yet "
            f"(ported: grouped, sort); see ROADMAP.md")
    C = capacity.expert_capacity(cfg, T, E)
    plan = layout.plan_sort(gate, E, C, drop_bucket=True)
    buf = layout.dispatch_scatter(x, plan)
    aux, metrics = balance.aux_losses(cfg, gate, expert_counts=plan.counts,
                                      valid=valid)
    h = expert_ffn(params, buf.reshape(E, C, d).to(params["w_up"].dtype),
                   act).reshape(E * C, d)
    y = layout.combine_gather(h, plan)
    return y.to(x.dtype), aux, metrics


def validate_dispatch_config(cfg: MoEConfig, *,
                             tokens_per_shard: Optional[int] = None) -> None:
    """Raise ``ValueError`` for a configuration the layer cannot run on one
    device (the reference's one-device checks), and
    ``NotImplementedError`` for what later slices bring.  ``"auto"`` knobs
    are resolved first when the token count is known."""
    if tuning.has_auto_knobs(cfg):
        if tokens_per_shard is None:
            return
        cfg = tuning.resolve_moe_config(cfg, model_size=1,
                                        tokens_per_shard=tokens_per_shard)
    if cfg.overlap_chunks > 1 and cfg.dispatch != "grouped":
        raise ValueError(
            f"MoEConfig.overlap_chunks={cfg.overlap_chunks} requires "
            f"dispatch='grouped' (the overlapped pipeline chunks the "
            f"grouped dispatch buffer), got dispatch={cfg.dispatch!r}")
    if cfg.overlap_chunks > 1:
        raise NotImplementedError(
            f"MoEConfig.overlap_chunks={cfg.overlap_chunks}: the overlapped "
            f"pipeline comes with the EP slice (ROADMAP.md)")


def moe_apply(cfg: MoEConfig, params: Dict[str, torch.Tensor],
              x: torch.Tensor, *, num_experts: int, act: str = "swiglu",
              noise: Optional[torch.Tensor] = None,
              token_ids: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """The MoE layer on ``x: (..., d)``: leading dims flatten into one
    token axis.  Expert weights are cast to the compute dtype (a no-op
    when the model already keeps them in it).  ``noise`` ((T, E), T the
    flattened token count) is a noisy gate's draw
    (``gating.draw_noise``); ``token_ids`` (``x``'s leading dims) route
    the ``hash`` gate, which raises ``ValueError`` without them, as the
    reference's ``sharded_moe_apply`` does."""
    lead, d = x.shape[:-1], x.shape[-1]
    toks = x.reshape(-1, d)
    T = toks.shape[0]
    if token_ids is not None:
        token_ids = token_ids.reshape(-1)
    elif cfg.gate == "hash":
        raise ValueError(
            "cfg.gate='hash' routes by token id: pass token_ids to "
            "moe_apply (without them every token would hash to one "
            "expert)")
    valid = torch.ones((T,), dtype=torch.bool, device=x.device)
    params = {k: (v if k == "gate_w" else v.to(x.dtype))
              for k, v in params.items()}
    cfg = tuning.resolve_moe_config(cfg, model_size=1, tokens_per_shard=T)
    validate_dispatch_config(cfg)
    y, aux, metrics = moe_block_local(cfg, params, toks,
                                      num_experts=num_experts, act=act,
                                      valid=valid, noise=noise,
                                      token_ids=token_ids)
    return y.reshape(*lead, d), aux, metrics
