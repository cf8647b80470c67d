"""The Mamba-2 block against the JAX package: ``models/mamba2.py``'s
chunked ``mamba_forward`` (output, final state and gradients) and
``mamba_decode_step`` against the reference's on the same weights (its
``init_mamba_block``, ``norm`` and ``conv_b`` drawn non-zero so that their
formulas show) and inputs made with numpy, f32 on the CPU, with one and
two groups of B and C; the chunked form against the recurrence; and the
repair of the reference's gradient: at its own chunk size of 128 the
reference forms exp(cum_l − cum_m) over the whole (L, L) square, which
overflows above the diagonal, and its gradient is NaN; the port masks the
exponent first, and its gradient at chunk 128 is finite and equals the
reference's at chunk 8 (the chunked form has no clip: the same function).
Every tolerance is stated at its assertion."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import SSMConfig as JSSMConfig
from repro.models import mamba2 as J
from repro_torch.core.config import SSMConfig
from repro_torch.models import mamba2 as M
from repro_torch.models.layers import rms_norm

D = 64
CFG = dict(d_state=16, head_dim=16, chunk_size=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def params(cfg, d=D, seed=0, perturb=True):
    """The reference's block (numpy); with ``perturb`` its zero-initialised
    ``norm`` and ``conv_b`` drawn non-zero."""
    p = jax.tree.map(np.asarray, J.init_mamba_block(
        jax.random.PRNGKey(seed), JSSMConfig(**cfg), d))
    if perturb:
        rng = np.random.default_rng(seed + 100)
        for k in ("norm", "conv_b"):
            p[k] = (0.2 * rng.standard_normal(p[k].shape)).astype(np.float32)
    return p


def torch_params(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def inputs(B, S, d=D, seed=3):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)


def rel(a, b):
    """max|a − b| / max|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


GROUPS = pytest.mark.parametrize("groups", [1, 2])


@GROUPS
@pytest.mark.parametrize("S", [16, 13], ids=["two-chunks", "prime"])
def test_forward_matches_reference(groups, S):
    """Output and final state (s, conv, pos) of a (2, S, 64) input, f32:
    y and s within 1e-5 of their max (C·Bᵀ formed once per group, the
    reference's repeat over heads summed in another order), conv bitwise
    (the last inputs of the conv), pos = S; chunks of 8, and of 1 at the
    prime S."""
    cfg = CFG | dict(n_groups=groups)
    p, x = params(cfg), inputs(2, S)
    jy, jst = J.mamba_forward(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              JSSMConfig(**cfg), D)
    ty, tst = M.mamba_forward(torch_params(p), torch.from_numpy(x),
                              SSMConfig(**cfg), D)
    assert rel(ty.numpy(), jy) <= 1e-5
    assert rel(tst["s"].numpy(), jst["s"]) <= 1e-5
    np.testing.assert_array_equal(tst["conv"].numpy(), np.asarray(
        jst["conv"]))
    assert int(tst["pos"]) == int(jst["pos"]) == S


@GROUPS
def test_forward_gradients_match_reference(groups):
    """Gradients of sum(y · w) for a random w with respect to every leaf
    and the input, (2, 16, 64) at chunks of 8, f32: each within 1e-5 of
    its max."""
    cfg = CFG | dict(n_groups=groups)
    p, x = params(cfg, seed=1), inputs(2, 16, seed=4)
    w = np.random.default_rng(12).standard_normal(x.shape).astype(np.float32)

    def jf(p, x):
        y, _ = J.mamba_forward(p, x, JSSMConfig(**cfg), D)
        return jnp.sum(y * w)
    jg = jax.grad(jf, argnums=(0, 1))(jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in torch_params(p).items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, _ = M.mamba_forward(tp, tx, SSMConfig(**cfg), D)
    (y * torch.from_numpy(w)).sum().backward()
    for k in p:
        assert rel(tp[k].grad.numpy(), jg[0][k]) <= 1e-5, k
    assert rel(tx.grad.numpy(), jg[1]) <= 1e-5


@GROUPS
def test_decode_step_matches_reference(groups):
    """One decode step from a random state (s, conv, pos): the output and
    the new s within 1e-5 of their max, the new conv state bitwise, pos
    + 1; f32."""
    cfg = CFG | dict(n_groups=groups)
    p = params(cfg, seed=2)
    rng = np.random.default_rng(7)
    d_in = 2 * D
    H = d_in // 16
    state = {"s": rng.standard_normal((2, H, 16, 16)).astype(np.float32),
             "conv": rng.standard_normal(
                 (2, 3, d_in + 2 * groups * 16)).astype(np.float32),
             "pos": np.asarray(5, np.int32)}
    x = inputs(2, 1, seed=8)
    jy, jst = J.mamba_decode_step(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x),
                                  jax.tree.map(jnp.asarray, state),
                                  JSSMConfig(**cfg), D)
    ty, tst = M.mamba_decode_step(torch_params(p), torch.from_numpy(x),
                                  torch_params(state), SSMConfig(**cfg), D)
    assert rel(ty.numpy(), jy) <= 1e-5
    assert rel(tst["s"].numpy(), jst["s"]) <= 1e-5
    np.testing.assert_array_equal(tst["conv"].numpy(), np.asarray(
        jst["conv"]))
    assert int(tst["pos"]) == int(jst["pos"]) == 6


def test_chunked_equals_recurrent():
    """The chunked pass over 24 tokens (3 chunks of 8) against 24 decode
    steps from the zero state: every output and the final s within 1e-5
    of their max, the conv state (the last inputs' projections, one
    product of (24, d) against one of (1, d)) within 1e-6 of its max,
    f32."""
    cfg = SSMConfig(**CFG)
    p = torch_params(params(CFG, seed=3))
    x = torch.from_numpy(inputs(1, 24, seed=9))
    y, st = M.mamba_forward(p, x, cfg, D)
    state = M.init_mamba_state(cfg, 1, D)
    outs = []
    for t in range(24):
        o, state = M.mamba_decode_step(p, x[:, t:t + 1], state, cfg, D)
        outs.append(o)
    assert rel(torch.cat(outs, 1).numpy(), y.numpy()) <= 1e-5
    assert rel(state["s"].numpy(), st["s"].numpy()) <= 1e-5
    assert rel(state["conv"].numpy(), st["conv"].numpy()) <= 1e-6
    assert int(state["pos"]) == 24


# the reference's own sizes where its gradient overflows: d = 128, one
# sequence of 256 RMS-normed tokens, chunk 128, A up to 16
REPAIR = dict(d_state=16, head_dim=16)
REPAIR_D, REPAIR_S = 128, 256


def repair_case():
    p = params(REPAIR | dict(chunk_size=128), d=REPAIR_D, seed=5,
               perturb=False)
    x = inputs(1, REPAIR_S, d=REPAIR_D, seed=13)
    x = rms_norm(torch.from_numpy(x), torch.zeros(REPAIR_D)).numpy()
    return p, x


def jax_grads(p, x, chunk):
    def jf(p):
        y, _ = J.mamba_forward(p, jnp.asarray(x),
                               JSSMConfig(**REPAIR, chunk_size=chunk),
                               REPAIR_D)
        return jnp.sum(y)
    return jax.tree.map(np.asarray, jax.jit(jax.grad(jf))(
        jax.tree.map(jnp.asarray, p)))


def test_gradient_is_finite_at_chunk_128():
    """The repair.  With the reference's init and RMS-normed inputs, at
    chunk 128 (the published chunk size): the reference's gradient of
    sum(y) is non-finite (its (L, L) exponent overflows above the
    diagonal before the mask), the port's is finite on every leaf, and
    each leaf is within 1e-5 of its max of the reference's gradient at
    chunk 8, the same function (finite there); the two forwards agree
    within 1e-5 of the max."""
    p, x = repair_case()
    bad = jax_grads(p, x, 128)
    assert not all(np.isfinite(v).all() for v in bad.values())
    want = jax_grads(p, x, 8)
    assert all(np.isfinite(v).all() for v in want.values())
    tp = {k: v.requires_grad_() for k, v in torch_params(p).items()}
    cfg = SSMConfig(**REPAIR, chunk_size=128)
    y, _ = M.mamba_forward(tp, torch.from_numpy(x), cfg, REPAIR_D)
    assert M.chunk_len(REPAIR_S, 128) == 128
    y.sum().backward()
    for k in p:
        g = tp[k].grad.numpy()
        assert np.isfinite(g).all(), k
        assert rel(g, want[k]) <= 1e-5, k
    jy, _ = J.mamba_forward(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            JSSMConfig(**REPAIR, chunk_size=8), REPAIR_D)
    assert rel(y.detach().numpy(), jy) <= 1e-5


def test_leafwise_init_keeps_the_f32_leaves():
    """The port's init draws the reference's leaves and shapes; with a
    bf16 dtype w_in, conv_w, conv_b and w_out are the f32 draw cast, and
    A_log, D, dt_bias and norm stay f32 (the reference uses them in f32);
    A_log spans log 1..log 16 and dt_bias inverts a softplus of 1e-3..1e-1,
    as the reference's."""
    cfg = SSMConfig(**CFG)
    f32 = M.init_mamba_block(torch.Generator().manual_seed(0), cfg, D)
    bf16 = M.init_mamba_block(torch.Generator().manual_seed(0), cfg, D,
                              dtype=torch.bfloat16)
    ref = J.init_mamba_block(jax.random.PRNGKey(0), JSSMConfig(**CFG), D)
    assert {k: tuple(v.shape) for k, v in f32.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    for k, v in f32.items():
        want = v if k in M.F32_LEAVES else v.to(torch.bfloat16)
        assert bf16[k].dtype == want.dtype and torch.equal(bf16[k], want), k
    np.testing.assert_allclose(f32["A_log"].numpy(), ref["A_log"], rtol=1e-6)
    dt = torch.nn.functional.softplus(f32["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JSSMConfig(**CFG))
