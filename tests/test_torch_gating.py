"""The port's eight gates against the JAX package: routes, the MoE layer
that runs them, the hash gate's token ids and the dense-to-sparse anneal.

The noisy gates take their draw as an input in the port.  Each test
builds the draw the reference makes from its rng (``gshard``: the Gumbel
draw ``jax.random.categorical`` adds; ``dense_to_sparse``: the uniform
draw of ``jax.random.uniform``) and hands the same numbers to the port.
Every tolerance is stated at its assertion."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import config as jconfig
from repro.core import gating as jgating
from repro.core import moe as jmoe
from repro.training.anneal import d2s_temperature as j_d2s_temperature
from repro_torch import configs
from repro_torch.core import config as tconfig
from repro_torch.core import gating, moe
from repro_torch.models import transformer as T
from repro_torch.training.anneal import d2s_temperature, with_temperature

RNG = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: at the smoke widths a
    torch op is too small to share out, and the parallel test workers
    would otherwise contend for the cores with 8 threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# the reference's own corners (tests/test_gating.py: ALL_GATES and
# OVERSIZED_GATES)
ALL_GATES = [
    ("topk", dict(top_k=2)),
    ("switch", {}),
    ("gshard", {}),
    ("ktop1", dict(num_prototypes=2)),
    ("sam", dict(num_groups=4, top_k=2)),
    ("base", {}),
    ("hash", {}),
    ("dense_to_sparse", dict(top_k=2)),
]
OVERSIZED_GATES = [
    ("topk", dict(top_k=4)),
    ("switch", dict(top_k=4)),
    ("gshard", dict(top_k=4)),
    ("ktop1", dict(num_prototypes=4, top_k=4)),
    ("sam", dict(num_groups=4, top_k=8)),
    ("base", dict(top_k=4)),
    ("hash", dict(top_k=4)),
    ("dense_to_sparse", dict(top_k=4)),
]


def _pair(gate, **kw):
    return (jconfig.MoEConfig(gate=gate, **kw),
            tconfig.MoEConfig(gate=gate, **kw))


def jax_noise(gate, key, shape):
    """The draw the reference's ``gate`` makes from ``key`` (None for the
    gates that draw nothing)."""
    if gate == "gshard":
        return np.asarray(jax.random.gumbel(key, shape, jnp.float32))
    if gate == "dense_to_sparse":
        return np.asarray(jax.random.uniform(key, shape, jnp.float32, 1e-6,
                                             1.0))
    return None


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def test_gshard_noise_is_categoricals_gumbel_draw():
    """The identity the gshard parity rests on, on JAX's side:
    ``categorical(key, l) == argmax(l + gumbel(key, l.shape))`` bitwise,
    with the first expert's slot at -inf as ``_gate_gshard`` masks it."""
    logits = jax.random.normal(jax.random.PRNGKey(5), (64, 8))
    first = jax.nn.one_hot(jnp.argmax(logits, -1), 8, dtype=bool)
    lp = jnp.where(first, -jnp.inf, jnp.log(jax.nn.softmax(logits) + 1e-9))
    want = jax.random.categorical(RNG, lp, axis=-1)
    got = jnp.argmax(lp + jax.random.gumbel(RNG, lp.shape, lp.dtype), -1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("gate,kw", ALL_GATES + OVERSIZED_GATES)
def test_route_matches_reference(gate, kw, ties):
    """route() given the reference's draws and token ids: expert ids
    exact; combine weights and router probs within atol 1e-6 (the same
    f32 arithmetic; softmax and logsumexp may differ in the last bits).
    Tied logits (integers 0..2) check the lowest-index tie break.  The
    width equals gate_k, the same in both packages."""
    S, E = 64, 8
    jc, tc = _pair(gate, num_experts=E, **kw)
    rng = np.random.default_rng(7)
    x = (rng.integers(0, 3, (S, E)) if ties
         else rng.standard_normal((S, E))).astype(np.float32)
    ids = rng.integers(0, 50304, (S,)).astype(np.int32)
    j = jgating.route(jc, jnp.asarray(x), rng=RNG, token_ids=jnp.asarray(ids))
    t = gating.route(tc, torch.from_numpy(x),
                     noise=_t(jax_noise(gate, RNG, (S, E))),
                     token_ids=torch.from_numpy(ids))
    k = gating.gate_k(tc)
    assert k == jgating.gate_k(jc)
    assert t.expert_index.shape == t.combine_weights.shape == (S, k)
    assert t.expert_index.dtype == torch.int32
    np.testing.assert_array_equal(t.expert_index.numpy(),
                                  np.asarray(j.expert_index))
    np.testing.assert_allclose(t.combine_weights.numpy(),
                               np.asarray(j.combine_weights), atol=1e-6)
    np.testing.assert_allclose(t.router_probs.numpy(),
                               np.asarray(j.router_probs), atol=1e-6)


@pytest.mark.parametrize("gate", ["gshard", "dense_to_sparse"])
def test_noisy_gates_without_noise_match_the_reference_without_rng(gate):
    """No draw: gshard's deterministic second argmax, dense_to_sparse
    without Gumbel noise — as the reference with rng=None.  Ids exact,
    weights atol 1e-6."""
    jc, tc = _pair(gate, num_experts=8, top_k=2)
    x = np.random.default_rng(8).standard_normal((32, 8)).astype(np.float32)
    j = jgating.route(jc, jnp.asarray(x))
    t = gating.route(tc, torch.from_numpy(x))
    np.testing.assert_array_equal(t.expert_index.numpy(),
                                  np.asarray(j.expert_index))
    np.testing.assert_allclose(t.combine_weights.numpy(),
                               np.asarray(j.combine_weights), atol=1e-6)


@pytest.mark.parametrize("gate", ["gshard", "dense_to_sparse"])
def test_draw_noise_follows_the_references_distribution(gate):
    """The port's own draws: the reference's support (dense_to_sparse's
    u in [1e-6, 1), gshard's Gumbel finite) and its mean within 0.01 of
    the distribution's (1/2; the Euler-Mascheroni constant 0.5772) over
    2^16 draws (the standard error is 1.1e-3 and 5.0e-3); a generator
    with the same seed repeats them bitwise."""
    _, tc = _pair(gate, num_experts=8, top_k=2)

    def draw(seed):
        return gating.draw_noise(tc, (8192, 8),
                                 torch.Generator().manual_seed(seed))
    u = draw(3)
    assert u.shape == (8192, 8) and u.dtype == torch.float32
    assert torch.isfinite(u).all()
    if gate == "dense_to_sparse":
        assert u.min() >= 1e-6 and u.max() < 1.0
        assert abs(u.mean().item() - 0.5) < 0.01
    else:
        assert abs(u.mean().item() - 0.5772156649) < 0.01
    assert torch.equal(u, draw(3)) and not torch.equal(u, draw(4))
    assert gating.draw_noise(_pair("base", num_experts=8)[1], (4, 8),
                             torch.Generator()) is None


def test_hash_matches_uint32_arithmetic_at_the_edges():
    """The int64 emulation of the uint32 Knuth hash equals JAX's uint32
    arithmetic on ids whose product overflows 32 and 63 bits (negative
    int32 ids wrap to large uint32), exactly."""
    ids = np.array([0, 1, 65535, 65536, 2 ** 31 - 1, -1, -2 ** 31, 50303,
                    123456789], dtype=np.int32)
    jc, tc = _pair("hash", num_experts=16)
    j = jgating.route(jc, jnp.zeros((9, 16)), token_ids=jnp.asarray(ids))
    t = gating.route(tc, torch.zeros(9, 16), token_ids=torch.from_numpy(ids))
    np.testing.assert_array_equal(t.expert_index.numpy(),
                                  np.asarray(j.expert_index))


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _layer_params(E=8, d=32, f=48):
    rng = np.random.default_rng(41)
    return {"gate_w": rng.standard_normal((d, E)).astype(np.float32) * 0.3,
            "w_up": rng.standard_normal((E, d, f)).astype(np.float32) * 0.2,
            "w_out": rng.standard_normal((E, f, d)).astype(np.float32) * 0.2}


@pytest.mark.parametrize("dispatch", ["grouped", "sort"])
@pytest.mark.parametrize("gate,kw", ALL_GATES)
def test_moe_layer_matches_sharded_moe_apply(mesh1, gate, kw, dispatch):
    """Value and gradients of sum(y·r) + aux with respect to x, gate_w,
    w_up and w_out, f32: moe_apply against jax.grad of a jitted
    sharded_moe_apply on the 1×1 mesh, given the draw the reference makes
    there (its rng folded with the device index 0) and the same token
    ids.  y within atol 1e-5, aux and the metrics within 1e-5, every
    gradient within 1e-5 of its leaf's max|grad| (f32 sums in other
    orders)."""
    E = 8
    fields = dict(num_experts=E, gate=gate, dispatch=dispatch,
                  use_pallas_gate=True, d_ff_expert=48, capacity_factor=1.0,
                  router_z_loss_weight=1e-3, **kw)
    jc, tc = jconfig.MoEConfig(**fields), tconfig.MoEConfig(**fields)
    p = _layer_params(E)
    rng = np.random.default_rng(42)
    x = rng.standard_normal((2, 20, 32)).astype(np.float32)
    r = rng.standard_normal((2, 20, 32)).astype(np.float32)
    ids = rng.integers(0, 512, (2, 20)).astype(np.int32)
    key = jax.random.PRNGKey(9)

    def jf(pp, xx):
        y, aux, met = jmoe.sharded_moe_apply(
            mesh1, jc, pp, xx, num_experts=E, act="relu", rng=key,
            token_ids=jnp.asarray(ids))
        return jnp.sum(y * r) + aux, (y, aux, met)
    (jv, (jy, jaux, jmet)), (jgp, jgx) = jax.jit(
        jax.value_and_grad(jf, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))

    noise = jax_noise(gate, jax.random.fold_in(key, 0), (40, E))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux, met = moe.moe_apply(tc, tp, tx, num_experts=E, act="relu",
                                noise=_t(noise),
                                token_ids=torch.from_numpy(ids))
    ((y * torch.from_numpy(r)).sum() + aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=1e-5)
    for k in met:
        np.testing.assert_allclose(met[k].item(), float(jmet[k]), atol=1e-5,
                                   err_msg=k)
    for name, t, j in [("x", tx.grad, jgx)] + [(k, tp[k].grad, jgp[k])
                                               for k in p]:
        j = np.asarray(j)
        scale = np.abs(j).max()
        if scale == 0:          # hash has no router gradient but the z-loss
            assert np.abs(t.numpy()).max() == 0, name
            continue
        err = np.abs(t.numpy() - j).max() / scale
        assert err <= 1e-5, (name, err)


def test_hash_needs_token_ids():
    """route and moe_apply raise ValueError without token ids, as the
    reference's route and sharded_moe_apply do; so does the model path,
    which passes none (the reference's _apply_attn_mlp)."""
    jc, tc = _pair("hash", num_experts=4)
    with pytest.raises(ValueError, match="token_ids"):
        jgating.route(jc, jnp.zeros((4, 4)))
    with pytest.raises(ValueError, match="token_ids"):
        gating.route(tc, torch.zeros(4, 4))
    p = {k: torch.from_numpy(v) for k, v in _layer_params(4).items()}
    with pytest.raises(ValueError, match="token_ids"):
        moe.moe_apply(tc, p, torch.zeros(2, 3, 32), num_experts=4,
                      act="relu")
    y, _, _ = moe.moe_apply(tc, p, torch.randn(2, 3, 32), num_experts=4,
                            act="relu",
                            token_ids=torch.arange(6).reshape(2, 3))
    assert y.shape == (2, 3, 32) and torch.isfinite(y).all()
    cfg = configs.smoke_config("hetumoe-paper-16e")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, gate="hash"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="token_ids"):
        T.forward(params, torch.zeros(1, 8, dtype=torch.int32), cfg)


@pytest.mark.parametrize("gate,kw", [("gshard", {}),
                                     ("dense_to_sparse", dict(top_k=2))])
def test_model_forward_matches_reference_given_its_draws(mesh1, gate, kw):
    """The smoke model's forward with a noisy gate: the reference's rng
    chain (PRNGKey(0) by default, split per super-block, folded with the
    device index) rebuilt in JAX, its draws handed to the port's forward:
    hidden states within atol 1e-5, aux within 1e-6 (f32)."""
    from repro.models import transformer as JT
    from repro_torch.convert import params_from_numpy
    jc = jconfigs.smoke_config("hetumoe-paper-16e").replace(dtype="float32")
    jc = jc.replace(moe=dataclasses.replace(jc.moe, gate=gate, **kw))
    tc = configs.smoke_config("hetumoe-paper-16e").replace(dtype="float32")
    tc = tc.replace(moe=dataclasses.replace(tc.moe, gate=gate, **kw))
    jp = JT.init_model(jax.random.PRNGKey(1), jc)
    toks = np.random.default_rng(3).integers(0, 512, (2, 16)).astype(
        np.int32)
    jh, jaux, _ = jax.jit(lambda pp, tt: JT.forward(pp, tt, jc, mesh=mesh1))(
        jp, jnp.asarray(toks))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc)
    th, taux, _ = T.forward(tp, torch.from_numpy(toks), tc,
                            noise=layer_draws(gate, jax.random.PRNGKey(0),
                                              tc, 32))
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               atol=1e-5)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-6)


def layer_draws(gate, rng, cfg, tokens):
    """The reference model's per-layer gate draws from ``rng``: split per
    super-block (``transformer.forward``), folded with device 0
    (``sharded_moe_apply``)."""
    out = []
    for _ in range(cfg.num_super_blocks):
        rng, *rks = jax.random.split(rng, len(cfg.block_pattern) + 1)
        for rk in rks:
            out.append(_t(jax_noise(gate, jax.random.fold_in(rk, 0),
                                    (tokens, cfg.moe.num_experts))))
    return out


# ---------------------------------------------------------------------------
# the dense-to-sparse anneal (the reference's tests/test_extensions.py)
# ---------------------------------------------------------------------------

def test_d2s_schedule_equals_reference_monotone_and_quantized():
    ts = [d2s_temperature(s, t_start=2.0, t_min=0.05, decay_steps=100,
                          levels=8) for s in range(0, 120, 5)]
    assert ts == [j_d2s_temperature(s, t_start=2.0, t_min=0.05,
                                    decay_steps=100, levels=8)
                  for s in range(0, 120, 5)]
    assert ts[0] == pytest.approx(2.0, rel=1e-6)
    assert ts[-1] == pytest.approx(0.05, rel=1e-6)
    assert all(a >= b - 1e-9 for a, b in zip(ts, ts[1:]))
    assert len(set(round(t, 6) for t in ts)) <= 8


def test_d2s_annealed_routing_goes_sparse():
    """Route the same logits at the schedule's start and end: the slot-0
    mass grows past 1/2, and each equals the reference's within 1e-6."""
    logits = np.array(jax.random.normal(jax.random.PRNGKey(0), (256, 8)))
    masses = []
    for step in (0, 1000):
        t = d2s_temperature(step, decay_steps=1000)
        jc, tc = _pair("dense_to_sparse", num_experts=8, top_k=4,
                       gumbel_temperature=t)
        out = gating.route(tc, torch.from_numpy(logits))
        jm = float(jnp.mean(jgating.route(jc, jnp.asarray(logits))
                            .combine_weights[:, 0]))
        masses.append(out.combine_weights[:, 0].mean().item())
        assert masses[-1] == pytest.approx(jm, abs=1e-6)
    assert masses[0] < 0.5 < masses[1]


def test_with_temperature_requires_d2s():
    cfg = configs.smoke_config("hetumoe-paper-16e")
    with pytest.raises(AssertionError):
        with_temperature(cfg, 0.5)
    d2s = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                              gate="dense_to_sparse"))
    assert with_temperature(d2s, 0.5).moe.gumbel_temperature == 0.5
