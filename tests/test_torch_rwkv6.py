"""The RWKV-6 time mix against the JAX package: ``models/rwkv6.py``'s
chunked ``rwkv_time_mix`` and ``rwkv_decode_step`` against the
reference's on the same weights (its ``init_rwkv_block``, ``ln_x`` drawn
away from 1 so that the group norm's ``ln_x − 1`` shows) and inputs made
with numpy, f32 on the CPU; the chunk rule (the largest divisor of S no
larger than ``chunk_size``: a prime S gives chunks of 1); the chunked form
against the token-by-token recurrence; and a chunk where the e³⁰ clip
acts (``w0`` raised so that the cumulative log-decay passes −30 inside a
chunk), where the result depends on the chunk length as the reference's
does.  Every tolerance is stated at its assertion."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import RWKVConfig as JRWKVConfig
from repro.models import rwkv6 as J
from repro_torch.core.config import RWKVConfig
from repro_torch.models import rwkv6 as R

D = 64
CFG = dict(head_dim=16, chunk_size=8, decay_lora=8, mix_lora=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def params(seed=0, **over):
    """The reference's block (numpy), ``ln_x`` drawn around 1."""
    p = jax.tree.map(np.asarray, J.init_rwkv_block(
        jax.random.PRNGKey(seed), JRWKVConfig(**CFG), D))
    rng = np.random.default_rng(seed + 100)
    p["ln_x"] = (1 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    p.update(over)
    return p


def torch_params(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def inputs(B, S, seed=3):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)


def rel(a, b):
    """max|a − b| / max|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def time_mix_both(p, x, **cfg):
    jy, js = J.rwkv_time_mix(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             JRWKVConfig(**(CFG | cfg)))
    ty, ts = R.rwkv_time_mix(torch_params(p), torch.from_numpy(x),
                             RWKVConfig(**(CFG | cfg)))
    return (np.asarray(jy), np.asarray(js)), (ty.detach().numpy(),
                                              ts.detach().numpy())


@pytest.mark.parametrize("S", [16, 24, 13, 1],
                         ids=["two-chunks", "three-chunks", "prime",
                              "one-token"])
def test_time_mix_matches_reference(S):
    """Output and final state of a (2, S, 64) input, f32, within 1e-5 of
    their max (the same products summed in torch's order): chunks of 8,
    and of 1 at the prime S = 13."""
    (jy, js), (ty, ts) = time_mix_both(params(), inputs(2, S))
    assert R.chunk_len(S, 8) == {16: 8, 24: 8, 13: 1, 1: 1}[S]
    assert rel(ty, jy) <= 1e-5
    assert rel(ts, js) <= 1e-5


def test_chunk_rule_is_the_references():
    """The largest divisor of S no larger than chunk_size, for every S up
    to 300 at chunk sizes 8 and 128."""
    for c in (8, 128):
        for S in range(1, 301):
            L = min(c, S)
            while S % L:
                L -= 1
            assert R.chunk_len(S, c) == L, (S, c)


def test_decode_step_matches_reference():
    """One decode step from a random state (s and x_last): output and the
    new s and x_last within 1e-5 of their max, f32."""
    p = params(1)
    rng = np.random.default_rng(5)
    H = D // 16
    state = {"s": rng.standard_normal((2, H, 16, 16)).astype(np.float32),
             "x_last": rng.standard_normal((2, D)).astype(np.float32)}
    x = inputs(2, 1, seed=6)
    jy, jst = J.rwkv_decode_step(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x),
                                 jax.tree.map(jnp.asarray, state),
                                 JRWKVConfig(**CFG))
    ty, tst = R.rwkv_decode_step(torch_params(p), torch.from_numpy(x),
                                 torch_params(state), RWKVConfig(**CFG))
    assert rel(ty.numpy(), jy) <= 1e-5
    for k in ("s", "x_last"):
        assert rel(tst[k].numpy(), jst[k]) <= 1e-5, k


def test_chunked_equals_recurrent():
    """The chunked pass over 24 tokens (3 chunks of 8, the clip idle at
    the reference's init: log-decay about −e⁻⁶ a token) against 24 decode
    steps from the zero state: every output and the final state within
    1e-5 of their max, f32."""
    p = torch_params(params(2))
    cfg = RWKVConfig(**CFG)
    x = torch.from_numpy(inputs(1, 24, seed=8))
    y, s = R.rwkv_time_mix(p, x, cfg)
    state = R.init_rwkv_state(cfg, 1, D)
    outs = []
    for t in range(24):
        o, state = R.rwkv_decode_step(p, x[:, t:t + 1], state, cfg)
        outs.append(o)
    assert rel(torch.cat(outs, 1).numpy(), y.numpy()) <= 1e-5
    assert rel(state["s"].numpy(), s.numpy()) <= 1e-5


def test_the_clip_acts_as_in_the_reference():
    """``w0`` raised to 2 puts every channel's decay at the clamp's top,
    log w = −e a token, so that the cumulative log-decay passes −30 after
    12 tokens: in chunks of 32 the clip caps exp(−cum), and the result
    depends on the chunk length.  The port matches the reference at
    chunks of 32 and of 8 (output and state within 1e-5 of their max),
    and its two results differ by more than 1e-2 of the max: the clip
    acted."""
    p = params(3, w0=np.full((D,), 2.0, np.float32))
    x = inputs(2, 64, seed=9)
    outs = {}
    for c in (32, 8):
        (jy, js), (ty, ts) = time_mix_both(p, x, chunk_size=c)
        assert rel(ty, jy) <= 1e-5, c
        assert rel(ts, js) <= 1e-5, c
        outs[c] = ty
    assert rel(outs[32], outs[8]) > 1e-2


def test_time_mix_gradients_match_reference():
    """Gradients of sum(y · w) for a random w with respect to every leaf
    and the input, (1, 16, 64) at chunks of 8, f32: each within 1e-5 of
    its max (the backward through the chunks' recomputation)."""
    p = params(4)
    x = inputs(1, 16, seed=10)
    w = np.random.default_rng(11).standard_normal(x.shape).astype(np.float32)

    def jf(p, x):
        y, _ = J.rwkv_time_mix(p, x, JRWKVConfig(**CFG))
        return jnp.sum(y * w)
    jg = jax.grad(jf, argnums=(0, 1))(jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in torch_params(p).items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, _ = R.rwkv_time_mix(tp, tx, RWKVConfig(**CFG))
    (y * torch.from_numpy(w)).sum().backward()
    for k in p:
        assert rel(tp[k].grad.numpy(), jg[0][k]) <= 1e-5, k
    assert rel(tx.grad.numpy(), jg[1]) <= 1e-5


def test_leafwise_init_keeps_the_f32_leaves():
    """The port's init draws the reference's leaves and shapes; with a
    bf16 dtype the projections are the f32 draw cast, and the decay
    LoRA, w0, u and ln_x stay f32 (the reference uses them in f32)."""
    cfg = RWKVConfig(**CFG)
    f32 = R.init_rwkv_block(torch.Generator().manual_seed(0), cfg, D)
    bf16 = R.init_rwkv_block(torch.Generator().manual_seed(0), cfg, D,
                             dtype=torch.bfloat16)
    ref = J.init_rwkv_block(jax.random.PRNGKey(0), JRWKVConfig(**CFG), D)
    assert {k: tuple(v.shape) for k, v in f32.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    for k, v in f32.items():
        want = v if k in R.F32_LEAVES else v.to(torch.bfloat16)
        assert bf16[k].dtype == want.dtype and torch.equal(bf16[k], want), k
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JRWKVConfig(**CFG))
