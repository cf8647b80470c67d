"""The MoE presets of slice 8 against the JAX package at smoke size:
``dbrx-132b`` (``topk`` gate, k=4 over 4 experts, SwiGLU experts, GQA) and
``llama4-maverick-400b-a17b`` (a ``("dense", "moe")`` period, ``switch``
over 4 experts, one shared expert, qk-norm), each in both dispatch modes:
f32 prefill logits, greedy tokens, prefill + decode steps and one AdamW
train step (the helpers and tolerances of ``test_torch_presets.py``).
Then the MoE layer at the full presets' routing shapes — k=4 over E=16,
and E=128 at a decode batch of 8 tokens — against ``sharded_moe_apply``
on a 1×1 mesh, and the kernels' wrappers called as ``chip_smoke.py``
expects their kernels to launch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import config as jconfig
from repro.core import moe as jmoe
from repro_torch import configs
from repro_torch.core import config as tconfig
from repro_torch.core import moe
from repro_torch.kernels import flash_attention as F
from repro_torch.kernels import grouped_ffn as G
from repro_torch.kernels import layout_transform as L
from repro_torch.kernels import topk_gate as K
from repro_torch.models.transformer import Transformer
from test_torch_presets import (MOE_ARCHS, check_decode, check_greedy,
                                check_prefill, check_train_step)

DISPATCH = ("grouped", "sort")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs (see
    ``test_torch_presets.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_logits_match_reference_f32(mesh1, arch, dispatch):
    check_prefill(arch, dispatch, mesh1)


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_greedy_generate_matches_reference(mesh1, arch, dispatch):
    check_greedy(arch, dispatch, mesh1)


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_steps_match_reference(mesh1, arch, dispatch):
    check_decode(arch, dispatch, mesh1)


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_step_matches_reference(mesh1, arch, dispatch):
    check_train_step(arch, dispatch, mesh1)


# ---------------------------------------------------------------------------
# the MoE layer at the full presets' routing shapes
# ---------------------------------------------------------------------------

LAYER_CASES = {
    # DBRX: topk gate, k=4 of 16 experts, 40 tokens (160 grouped rows;
    # sort capacity k·T/E·1.25 = 12.5 → 16)
    "dbrx k=4 E=16": (dict(num_experts=16, top_k=4, gate="topk"), 40),
    # Llama 4: switch over 128 experts at a decode batch of 8 tokens — at
    # most 8 of the 128 segments hold rows
    "llama4 E=128 T=8": (dict(num_experts=128, top_k=1, gate="switch"), 8),
}


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_layer_at_preset_routing_matches_reference(mesh1, case,
                                                       dispatch):
    """Value and gradients of sum(y·r) + aux with respect to x, gate_w,
    w_up, w_gate and w_out (SwiGLU experts, d=32, f=48, f32): moe_apply
    against jax.grad of a jitted sharded_moe_apply on the 1×1 mesh — the
    value within rtol 1e-5, every gradient within 1e-5 of its leaf's
    max|grad| (f32 sums in other orders).  At E=128 the grouped dispatch
    sees at most 8 non-empty segments."""
    fields, T = LAYER_CASES[case]
    E = fields["num_experts"]
    fields = dict(fields, dispatch=dispatch, use_pallas_gate=True,
                  d_ff_expert=48, capacity_factor=1.25,
                  router_z_loss_weight=1e-3)
    jc, tc = jconfig.MoEConfig(**fields), tconfig.MoEConfig(**fields)
    rng = np.random.default_rng(61)
    d, f = 32, 48
    p = {"gate_w": rng.standard_normal((d, E)) * 0.3,
         "w_up": rng.standard_normal((E, d, f)) * 0.2,
         "w_gate": rng.standard_normal((E, d, f)) * 0.2,
         "w_out": rng.standard_normal((E, f, d)) * 0.2}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((1, T, d)).astype(np.float32)
    r = rng.standard_normal((1, T, d)).astype(np.float32)

    def jf(pp, xx):
        y, aux, _ = jmoe.sharded_moe_apply(mesh1, jc, pp, xx, num_experts=E,
                                           act="swiglu")
        return jnp.sum(y * r) + aux
    jv, (jgp, jgx) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux, _ = moe.moe_apply(tc, tp, tx, num_experts=E, act="swiglu")
    tv = (y * torch.from_numpy(r)).sum() + aux
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
    for name, t, j in [("x", tx.grad, jgx)] + [(k, tp[k].grad, jgp[k])
                                               for k in p]:
        j = np.asarray(j)
        scale = np.abs(j).max()
        assert scale > 0, name
        err = np.abs(t.numpy() - j).max() / scale
        assert err <= 1e-5, (name, err)


def _combine_case(seed=71, S=37, K=4, E=16, d=24):
    """A grouped plan at top_k=4 (dbrx's routing over 16 experts) with a
    dropped padded token, and an expert-sorted bf16 buffer."""
    from repro_torch.core import gating, layout
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(E)[:K] for _ in range(S)]).astype(
        np.int32)
    idx[5] = E                                 # a padded token: dropped
    w = rng.random((S, K)).astype(np.float32)
    w[5] = 0.0
    gate = gating.GateOutput(torch.from_numpy(idx), torch.from_numpy(w),
                             torch.zeros(S, E), torch.zeros(S, E))
    plan = layout.plan_grouped(gate, E, drop_bucket=True)
    ys = torch.from_numpy(rng.standard_normal((S * K, d)).astype(
        np.float32)).to(torch.bfloat16)
    return plan, ys


def test_grouped_combine_is_ordered_through_the_scatter_add_kernel(
        monkeypatch):
    """The grouped combine at top_k=4 goes through the scatter-add
    kernel's wrapper (its ordered sum: on the card the same bits on every
    run, where ``index_add_``'s atomics added a token's 4 rows in a
    different order from run to run and dbrx-132b's greedy tokens
    differed between two runs) and is bitwise the reference's
    scatter-add order — a sequential loop over the expert-sorted rows into
    f32 zeros — and the reference's own ``combine_grouped`` (f32, exact:
    the same products added in the same order)."""
    from repro.core import layout as jlayout
    from repro_torch.core import layout
    S = 37
    plan, ys = _combine_case(S=S)
    want = torch.zeros(S, ys.shape[1])
    for i in range(ys.shape[0]):
        want[plan.token[i]] += ys[i].float() * plan.weight[i]
    jplan = jlayout.GroupedPlan(*(jnp.asarray(t.numpy()) for t in plan[:5]))
    calls = []
    real = L._scatter_add_rows
    monkeypatch.setattr(L, "_scatter_add_rows",
                        lambda *a: calls.append(a[2]) or real(*a))
    got = layout.combine_grouped(ys, plan, S)
    assert calls == [S]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))          # bitwise
    j = jlayout.combine_grouped(jnp.asarray(ys.float().numpy()), jplan, S)
    np.testing.assert_array_equal(                             # bitwise
        layout.combine_grouped(ys.float(), plan, S).numpy(), np.asarray(j))


def test_grouped_combine_gradients_match_the_reference_vjp(monkeypatch):
    """The combine's backward — the gather kernel's wrapper over the
    scatter-add's token map — against ``jax.vjp`` of the reference's
    ``combine_grouped`` in f32: the buffer's exact (each element one
    product, no sum; tolerance 0), the combine weights' within rtol/atol
    1e-6 (each a sum over d=24 products, which the two libraries may add
    in other orders)."""
    from repro.core import layout as jlayout
    from repro_torch.core import layout
    S = 37
    plan, ys = _combine_case(seed=72, S=S)
    ys = ys.float().requires_grad_()
    w = plan.weight.clone().requires_grad_()
    g = torch.from_numpy(np.random.default_rng(73).standard_normal(
        (S, ys.shape[1])).astype(np.float32))
    calls = []
    real = L._gather_rows
    monkeypatch.setattr(L, "_gather_rows",
                        lambda *a: calls.append(a[1].shape[0]) or real(*a))
    out = layout.combine_grouped(ys, plan._replace(weight=w), S)
    dys, dw = torch.autograd.grad(out, (ys, w), g)
    assert calls == [ys.shape[0]]            # one gather in the backward

    def ref(y, wt):
        jplan = jlayout.GroupedPlan(jnp.asarray(plan.sort_order.numpy()),
                                    jnp.asarray(plan.token.numpy()), wt,
                                    jnp.asarray(plan.counts.numpy()),
                                    jnp.asarray(plan.offsets.numpy()))
        return jlayout.combine_grouped(y, jplan, S)
    _, vjp = jax.vjp(ref, jnp.asarray(ys.detach().numpy()),
                     jnp.asarray(plan.weight.numpy()))
    jys, jw = vjp(jnp.asarray(g.numpy()))
    np.testing.assert_array_equal(dys.numpy(), np.asarray(jys))
    np.testing.assert_allclose(dw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the kernels' wrappers on the presets' paths
# ---------------------------------------------------------------------------

# (module, the function that launches the kernel on a CUDA tensor)
WRAPPERS = ((K, "fused_topk_gate"), (L, "_gather_rows"),
            (G, "_grouped_matmul"), (L, "_scatter_add_rows"),
            (F, "flash_fwd"))


@pytest.mark.parametrize("arch,dispatch,per_moe_layer", [
    ("dbrx-132b", "grouped", {"fused_topk_gate": 1, "_gather_rows": 1,
                              "_grouped_matmul": 3, "_scatter_add_rows": 1}),
    ("dbrx-132b", "sort", {"fused_topk_gate": 1, "_gather_rows": 2}),
    ("llama4-maverick-400b-a17b", "grouped",
     {"fused_topk_gate": 1, "_gather_rows": 1, "_grouped_matmul": 3,
      "_scatter_add_rows": 1}),
    ("llama4-maverick-400b-a17b", "sort",
     {"fused_topk_gate": 1, "_gather_rows": 2}),
    ("yi-6b", None, {}),
    ("starcoder2-3b", None, {})])
def test_forward_calls_the_kernel_wrappers_per_moe_layer(
        monkeypatch, arch, dispatch, per_moe_layer):
    """A forward calls the wrappers as often as chip_smoke.py phase 12
    expects the kernels to launch on the card: per MoE layer the gate once
    (top-4 in one launch for dbrx), the gather once (grouped) or twice
    (sort), the grouped matmul 3 times (up, gate, out: SwiGLU) and the
    scatter-add once (the combine), grouped only; a dense layer none of
    them; the flash forward once per layer
    past q_chunk = 512 tokens only.  Decode steps likewise, never flash."""
    calls = {}
    for mod, name in WRAPPERS:
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)
    cfg = configs.smoke_config(arch)
    if dispatch is not None:
        from repro_torch.serving.engine import serve_config
        cfg = serve_config(cfg, dispatch=dispatch)
    model = Transformer(cfg, device="cpu")
    n_moe = cfg.block_pattern.count("moe") * cfg.num_super_blocks
    for S, flash in ((8, 0), (520, cfg.num_layers)):
        calls.clear()
        with torch.inference_mode():
            caches = model.init_caches(1, S + 1)
            h, _, caches = model.forward(torch.zeros((1, S), dtype=torch.long),
                                         caches=caches)
        want = {k: v * n_moe for k, v in per_moe_layer.items()}
        if flash:
            want["flash_fwd"] = flash
        assert calls == want, (S, calls)
    calls.clear()
    with torch.inference_mode():
        model.decode_step(torch.zeros((1, 1), dtype=torch.long), caches)
    assert calls == {k: v * n_moe for k, v in per_moe_layer.items()}
