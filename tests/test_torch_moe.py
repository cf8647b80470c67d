"""The port's gate, plans, capacity, tuning and MoE layer against the JAX
package on one device (``mesh1``), with the reference's Pallas kernels in
interpret mode (``use_pallas_gate=True``) and the port's plain versions.
Inputs come from numpy seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import capacity as jcap
from repro.core import config as jconfig
from repro.core import gating as jgating
from repro.core import layout as jlayout
from repro.core import moe as jmoe
from repro.core import tuning as jtuning
from repro_torch import configs
from repro_torch.core import capacity, gating, layout, moe, tuning
from repro_torch.core import config as tconfig
from repro_torch.core.balance import METRIC_KEYS


def _pair(gate="switch", top_k=1, dispatch="grouped", kernels=True, **kw):
    """The same MoEConfig in both packages."""
    fields = dict(num_experts=4, top_k=top_k, gate=gate, dispatch=dispatch,
                  use_pallas_gate=kernels, d_ff_expert=48, **kw)
    return jconfig.MoEConfig(**fields), tconfig.MoEConfig(**fields)


def _logits(S=40, E=4, seed=21, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        return rng.integers(0, 2, (S, E)).astype(np.float32)
    return rng.standard_normal((S, E)).astype(np.float32)


# ---------------------------------------------------------------------------
# gate and plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("gate,top_k,ties", [("switch", 1, False),
                                             ("topk", 2, False),
                                             ("switch", 1, True),
                                             ("topk", 2, True)])
def test_route_matches_reference(gate, top_k, ties, kernels):
    """Exact expert ids; weights and probs at 1e-6."""
    jc, tc = _pair(gate, top_k, kernels=kernels)
    x = _logits(ties=ties)
    j = jgating.route(jc, jnp.asarray(x))
    t = gating.route(tc, torch.from_numpy(x))
    np.testing.assert_array_equal(t.expert_index.numpy(),
                                  np.asarray(j.expert_index))
    np.testing.assert_allclose(t.combine_weights.numpy(),
                               np.asarray(j.combine_weights), atol=1e-6)
    np.testing.assert_allclose(t.router_probs.numpy(),
                               np.asarray(j.router_probs), atol=1e-6)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("drop", [False, True])
def test_plans_match_reference(top_k, drop):
    """plan_grouped / plan_sort integer fields exact, weights at 1e-6; with
    ``drop`` some tokens route to the virtual expert E."""
    jc, tc = _pair("topk", top_k)
    x = _logits(S=48)
    jg = jgating.route(jc, jnp.asarray(x))
    tg = gating.route(tc, torch.from_numpy(x))
    if drop:
        mask = np.arange(48) % 5 == 0
        ei = np.where(mask[:, None], 4, np.asarray(jg.expert_index))
        jg = jg._replace(expert_index=jnp.asarray(ei, jnp.int32))
        tg = tg._replace(expert_index=torch.from_numpy(ei).to(torch.int32))
    jp = jlayout.plan_grouped(jg, 4, drop_bucket=drop)
    tp = layout.plan_grouped(tg, 4, drop_bucket=drop)
    for f in ("sort_order", "token", "counts", "offsets"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    np.testing.assert_allclose(tp.weight.numpy(), np.asarray(jp.weight),
                               atol=1e-6)
    C = jcap.expert_capacity(jc, 48, 4)
    jp = jlayout.plan_sort(jg, 4, C, drop_bucket=drop)
    tp = layout.plan_sort(tg, 4, C, drop_bucket=drop)
    for f in ("slot", "sort_order", "counts", "offsets", "inv"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    np.testing.assert_allclose(tp.weight.numpy(), np.asarray(jp.weight),
                               atol=1e-6)


@pytest.mark.parametrize("T", [1, 4, 8, 37, 512, 4096])
@pytest.mark.parametrize("dispatch", ["grouped", "sort"])
def test_capacity_and_tuning_match_reference(T, dispatch):
    """expert_capacity (align-8 clamp), grouped_tp_gather_bound and the
    one-device "auto" resolution equal the reference's."""
    jcfg = jconfigs.get_config("hetumoe-paper-16e").moe
    jcfg = dataclasses.replace(jcfg, dispatch=dispatch)
    tcfg = dataclasses.replace(configs.get_config("hetumoe-paper-16e").moe,
                               dispatch=dispatch)
    assert capacity.expert_capacity(tcfg, T, 16) == \
        jcap.expert_capacity(jcfg, T, 16)
    assert capacity.grouped_tp_gather_bound(tcfg, T) == \
        jcap.grouped_tp_gather_bound(jcfg, T)
    jr = jtuning.resolve_moe_config(jcfg, model_size=1, tokens_per_shard=T,
                                    d_model=2048, dtype=jnp.bfloat16)
    tr = tuning.resolve_moe_config(tcfg, model_size=1, tokens_per_shard=T)
    for knob in tuning.TUNED_KNOBS + ("a2a_inner",):
        assert getattr(tr, knob) == getattr(jr, knob), knob
    assert not tuning.has_auto_knobs(tr)
    assert tuning.resolve_moe_config(tr, model_size=1,
                                     tokens_per_shard=T) is tr
    with pytest.raises(NotImplementedError, match="EP slice"):
        tuning.resolve_moe_config(tcfg, model_size=2, tokens_per_shard=T)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _params(seed=31, E=4, d=32, f=48):
    rng = np.random.default_rng(seed)
    return {"gate_w": rng.standard_normal((d, E)).astype(np.float32) * d ** -.5,
            "w_up": rng.standard_normal((E, d, f)).astype(np.float32) * d ** -.5,
            "w_out": rng.standard_normal((E, f, d)).astype(np.float32) * f ** -.5}


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("gate,top_k", [("switch", 1), ("topk", 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dispatch", ["grouped", "sort"])
def test_moe_apply_matches_sharded_moe_apply(mesh1, dispatch, dtype, gate,
                                             top_k, kernels):
    """y: f32 atol 1e-5; bf16 atol 2e-2 — both sides round the activations
    to bf16 after each expert matmul, but their f32 sums add in other
    orders, so a rounding can land one bf16 ulp apart (7.8e-3 at |y| ~ 1)
    and the relu and the next product carry it.  aux loss and metrics at
    1e-5 (computed in f32 on both sides)."""
    jc, tc = _pair(gate, top_k, dispatch=dispatch, kernels=kernels,
                   capacity_factor=1.0)
    p = _params()
    x = np.random.default_rng(32).standard_normal((2, 20, 32)).astype(
        np.float32)
    # jitted: the eager shard_map path re-traces every op (10x slower)
    jy, jaux, jmet = jax.jit(lambda pp, xx: jmoe.sharded_moe_apply(
        mesh1, jc, pp, xx, num_experts=4, act="relu"))(
        {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(x).astype(dtype))
    ty, taux, tmet = moe.moe_apply(
        tc, {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(x).to(getattr(torch, dtype)), num_experts=4,
        act="relu")
    assert ty.dtype == getattr(torch, dtype) and ty.shape == (2, 20, 32)
    atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)), atol=atol)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-5)
    assert tuple(tmet) == METRIC_KEYS
    for k in METRIC_KEYS:
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]), atol=1e-5,
                                   err_msg=k)


def test_moe_block_local_valid_masks_padding():
    """Padded rows (valid False) route to the virtual expert: zero output
    and no share of the router statistics — the same as dropping them."""
    _, tc = _pair("switch", dispatch="grouped")
    p = {k: torch.from_numpy(v) for k, v in _params().items()}
    x = torch.randn(10, 32, generator=torch.Generator().manual_seed(3))
    valid = torch.arange(10) < 7
    y, aux, met = moe.moe_block_local(tc, p, x, num_experts=4, act="relu",
                                      valid=valid)
    y7, aux7, met7 = moe.moe_block_local(tc, p, x[:7], num_experts=4,
                                         act="relu")
    assert (y[7:] == 0).all()
    torch.testing.assert_close(y[:7], y7)
    torch.testing.assert_close(aux, aux7)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("dispatch,wrappers", [
    ("grouped", ["fused_topk_gate", "gather_rows", "grouped_matmul",
                 "grouped_matmul"]),
    ("sort", ["fused_topk_gate", "gather_rows", "gather_rows"]),
])
def test_moe_layer_goes_through_every_kernel_wrapper(monkeypatch, dispatch,
                                                     wrappers, kernels):
    """Whatever ``use_pallas_gate`` says, the layer calls each kernel's
    wrapper (which picks the plain version only for a CPU tensor) — there
    is no second, kernel-free path that a CUDA tensor could take."""
    from repro_torch.kernels import build
    seen = []
    real = build.dispatch_device
    monkeypatch.setattr(build, "dispatch_device",
                        lambda name, t: seen.append(name) or real(name, t))
    _, tc = _pair("switch", dispatch=dispatch, kernels=kernels)
    p = {k: torch.from_numpy(v) for k, v in _params().items()}
    moe.moe_apply(tc, p, torch.randn(2, 5, 32), num_experts=4, act="relu")
    assert seen == wrappers


def test_moe_layer_without_kernels_raises_off_the_cpu():
    """``use_pallas_gate=False`` has no kernel-free layer on a device: it
    raises there instead of running plain PyTorch."""
    _, tc = _pair("switch", kernels=False)
    p = {k: torch.from_numpy(v).to("meta") for k, v in _params().items()}
    with pytest.raises(ValueError, match="use_pallas_gate=False"):
        moe.moe_block_local(tc, p, torch.zeros(4, 32, device="meta"),
                            num_experts=4, act="relu")


@pytest.mark.parametrize("kw,exc", [
    (dict(dispatch="dense"), NotImplementedError),
    (dict(overlap_chunks=2, dispatch="sort"), ValueError),
    (dict(overlap_chunks=2, dispatch="grouped"), NotImplementedError),
])
def test_moe_apply_rejects_unported_configs(kw, exc):
    _, tc = _pair("switch", **{"dispatch": "grouped", **kw})
    p = {k: torch.from_numpy(v) for k, v in _params().items()}
    with pytest.raises(exc):
        moe.moe_apply(tc, p, torch.zeros(4, 32), num_experts=4, act="relu")


@pytest.mark.parametrize("bad", [
    dict(gate="nope"), dict(a2a="ring"), dict(dispatch="scatter"),
    dict(a2a_inner=0), dict(grouped_ep_bound_factor=-1.0),
    dict(grouped_block_m=0), dict(overlap_chunks=0),
    dict(payload_dtype="int4")])
def test_moe_config_raises_like_reference(bad):
    """The port's MoEConfig raises the reference's ValueError, message and
    all."""
    with pytest.raises(ValueError) as je:
        jconfig.MoEConfig(num_experts=4, **bad)
    with pytest.raises(ValueError) as te:
        tconfig.MoEConfig(num_experts=4, **bad)
    assert str(te.value) == str(je.value)
