"""The flash-attention kernels' plain versions against the JAX package's
Pallas kernels (interpret mode, as ``tests/test_flash_attention.py`` runs
them): the forward's o and lse against ``_flash_fwd``, and dq, dk, dv
through ``FlashAttention``'s backward against ``jax.vjp`` of the
reference's ``flash_attention``; then ``full_attention`` on both of its
paths.  The same numpy inputs go to both sides; every tolerance is stated
at its assertion."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import AttentionConfig as JAttentionConfig
from repro.kernels import flash_attention as jfa
from repro.models import attention as jattn
from repro_torch.core.config import AttentionConfig
from repro_torch.kernels import flash_attention as F
from repro_torch.models import attention as tattn


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(v), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


@functools.partial(jax.jit, static_argnums=(5, 6, 7, 8))
def _jax_fwd(q, k, v, q_pos, k_pos, scale, causal, window, cap):
    return jfa._flash_fwd(q, k, v, q_pos, k_pos, scale, causal, window, cap,
                          512, True)


@functools.partial(jax.jit, static_argnums=(6, 7, 8, 9))
def _jax_vjp(q, k, v, do, q_pos, k_pos, scale, causal, window, cap):
    _, pull = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, q_pos, k_pos, scale, causal, window, cap, 512, True),
        q, k, v)
    return pull(do)


# (name, B, H, KV, Sq, Sk, d, causal, window, cap, invalid k slots)
CASES = [
    ("gqa2 causal", 2, 4, 2, 64, 64, 32, True, None, None, False),
    ("gqa4 window16", 1, 8, 2, 96, 96, 16, True, 16, None, False),
    ("noncausal cap5", 2, 4, 2, 64, 64, 32, False, None, 5.0, False),
    ("gqa4 cap50", 1, 8, 2, 96, 96, 32, True, None, 50.0, False),
    ("ragged S=600", 1, 4, 2, 600, 600, 16, True, None, None, False),
    ("k_pos -1 slots, row 0 fully masked", 1, 4, 2, 64, 64, 16, True, None,
     None, True),
    ("Sq=48 Sk=80 noncausal, -1 slots", 1, 4, 4, 48, 80, 16, False, None,
     None, True),
]
IDS = [c[0] for c in CASES]
# head dims 120 (h2o-danube3), 256 (gemma2) and 80 (hubert-xlarge), with
# the masks and the cap those presets serve and train with: hubert's
# attention is non-causal, and its 781 frames leave a last tile of 13 rows
# (77 = 64 + 13 here)
WIDE_CASES = [
    ("d=120 causal", 1, 4, 2, 80, 80, 120, True, None, None, False),
    ("d=120 window16", 1, 8, 2, 96, 96, 120, True, 16, None, False),
    ("d=120 window16, -1 slots, row 0 fully masked", 1, 4, 2, 64, 64, 120,
     True, 16, None, True),
    ("d=256 causal", 1, 4, 2, 80, 80, 256, True, None, None, False),
    ("d=256 window16 cap50", 1, 4, 2, 96, 96, 256, True, 16, 50.0, False),
    ("d=256 cap50", 2, 4, 2, 64, 64, 256, True, None, 50.0, False),
    ("d=80 noncausal, ragged S=77, -1 slots", 2, 4, 4, 77, 77, 80, False,
     None, None, True),
]
FWD_CASES = CASES + WIDE_CASES
FWD_IDS = [c[0] for c in FWD_CASES]


def _inputs(case, dtype, seed=0):
    _, B, H, KV, Sq, Sk, d, causal, window, cap, invalid = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, d)).astype(np.float32)
    k = rng.standard_normal((B, KV, Sk, d)).astype(np.float32)
    v = rng.standard_normal((B, KV, Sk, d)).astype(np.float32)
    do = rng.standard_normal((B, H, Sq, d)).astype(np.float32)
    q_pos = np.arange(Sq, dtype=np.int32)
    k_pos = np.arange(Sk, dtype=np.int32)
    if invalid:
        # slot 0 invalid: under the causal mask, query 0 has no key left
        k_pos[0] = -1
        k_pos[rng.random(Sk) < 0.2] = -1
    jx = [jnp.asarray(a).astype(dtype) for a in (q, k, v, do)]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v, do)]
    pos = (jnp.asarray(q_pos), jnp.asarray(k_pos), torch.from_numpy(q_pos),
           torch.from_numpy(k_pos))
    static = (d ** -0.5, causal, window, cap)
    return jx, tx, pos, static


def _assert_close(t: torch.Tensor, j, dtype: str, what: str,
                  extra=None) -> None:
    t = t.float().numpy()
    j = np.asarray(jnp.asarray(j).astype(jnp.float32))
    if dtype == "float32":
        # the reference's own tolerance for its kernels
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=2e-5, err_msg=what)
    else:
        # both sides compute in f32 and round once to bf16: 1 bf16 ulp,
        # plus ``extra`` where the inputs themselves may differ (below)
        err = np.abs(t - j)
        tol = _bf16_ulp(j) + (0 if extra is None else extra.numpy())
        assert (err <= tol).all(), (what, (err / tol).max())


def _fwd_slack(q, k, v, q_pos, k_pos, scale, causal, window, cap):
    """What a bf16 o may differ by beyond 1 ulp, per element: twice the
    f32 summation-order bound of its sums, as ``chip_smoke.py``'s
    ``flash_order_bounds`` states it — a score sums d products (|ds| <=
    d·2⁻²⁴·SA, SA = scale·|q|·|k|, moving p by that much relatively, and
    the softcap passes it on at most unchanged), o sums Sk of them:
    2·(Sk + 2d·max_k SA)·2⁻²⁴·(p@|v|)/l.  At d = 120 and 256 an o near 0
    (terms of both signs cancelling) is smaller than that, and one bf16
    ulp of it does not cover the two sides' sums."""
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    _, lse = F.flash_fwd_plain(q, k, v, q_pos, k_pos, scale, causal, window,
                               cap)
    s, _, _ = F._scores(q, k, q_pos, k_pos, scale, causal, window, cap)
    p = torch.exp(s - lse.reshape(s.shape[:-1])[..., None])
    sa = torch.einsum("bkgqd,bksd->bkgqs", F._grouped(q, KV).abs(),
                      k.float().abs()) * scale
    pv = torch.einsum("bkgqs,bksd->bkgqd", p, v.float().abs())
    u = 2.0 ** -24
    return (2 * (Sk + 2 * d * sa.amax(-1, keepdim=True)) * u * pv
            ).reshape(q.shape)


def _bwd_slack(q, k, v, do, q_pos, k_pos, scale, causal, window, cap,
               o_extra=None):
    """What bf16 gradients may differ by beyond 1 ulp, per element of dq,
    dk and dv.  Each side computes Δ = rowsum(dO∘o) from its OWN bf16 o,
    and the two o may be 1 bf16 ulp apart (above), plus ``o_extra`` (the
    forward's ``_fwd_slack`` at d = 120 and 256): Δ_q then differs by up
    to δ_q = Σ_c |dO_qc|·(ulp(o_qc) + o_extra_qc), which reaches dq and dk
    through ds = p·(dP - Δ), where dP and Δ cancel (a query with one key
    has ds = 0 exactly, and every rounding shows).  On top of that, twice
    the f32 summation-order bound n·2⁻²⁴·Σ|terms| of sums of n = d + Sk
    (dq), d + G·Sq (dk) and G·Sq (dv) terms, with |ds| ≤ p·(|dO|·|v|ᵀ +
    Σ|dO∘o|) (the softcap factor 1 - t² ≤ 1 dropped)."""
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    u = 2.0 ** -24
    o, lse = F.flash_fwd_plain(q, k, v, q_pos, k_pos, scale, causal, window,
                               cap)
    s, _, _ = F._scores(q, k, q_pos, k_pos, scale, causal, window, cap)
    p = torch.exp(s - lse.reshape(s.shape[:-1])[..., None])
    ado = F._grouped(do, KV).abs()
    ulp_o = torch.from_numpy(_bf16_ulp(o.float().numpy()))
    if o_extra is not None:
        ulp_o = ulp_o + o_extra
    delta_err = (ado * F._grouped(ulp_o, KV)).sum(-1)[..., None]
    terms = p * (torch.einsum("bkgqd,bksd->bkgqs", ado, v.float().abs())
                 + (ado * F._grouped(o, KV).abs()).sum(-1)[..., None])
    G = H // KV
    dq = scale * torch.einsum("bkgqs,bksd->bkgqd",
                              p * delta_err + 2 * (d + Sk) * u * terms,
                              k.float().abs()).reshape(q.shape)
    dk = scale * torch.einsum("bkgqs,bkgqd->bksd",
                              p * delta_err + 2 * (d + G * Sq) * u * terms,
                              F._grouped(q, KV).abs())
    dv = 2 * G * Sq * u * torch.einsum("bkgqs,bkgqd->bksd", p, ado)
    return dq, dk, dv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FWD_CASES, ids=FWD_IDS)
def test_forward_matches_reference(case, dtype):
    """o and lse of ``flash_fwd`` (the plain version on a CPU tensor)
    against the Pallas forward; lse is f32 on both sides (rtol 1e-5 /
    atol 2e-5 for either dtype, as its inputs are the same).  In bf16 the
    head dims 120, 256 and 80 (``WIDE_CASES``) add the f32
    summation-order bound of ``_fwd_slack`` to the 1 ulp."""
    (jq, jk, jv, _), (tq, tk, tv, _), (jqp, jkp, tqp, tkp), st = _inputs(
        case, dtype)
    jo, jlse = _jax_fwd(jq, jk, jv, jqp, jkp, *st)
    to, tlse = F.flash_fwd(tq, tk, tv, tqp, tkp, *st)
    assert to.dtype == tq.dtype and tlse.dtype == torch.float32
    extra = (_fwd_slack(tq, tk, tv, tqp, tkp, *st) if case in WIDE_CASES
             else None)
    _assert_close(to, jo, dtype, "o", extra)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FWD_CASES, ids=FWD_IDS)
def test_backward_matches_reference(case, dtype):
    """dq, dk, dv from ``FlashAttention``'s backward (Δ from the saved o,
    then the dq and dk/dv plain versions) against ``jax.vjp`` of the
    reference's ``flash_attention`` with the same cotangent: f32 at rtol
    1e-5 / atol 2e-5; bf16 within 1 ulp plus ``_bwd_slack``, whose Δ
    term at head dims 120, 256 and 80 (``WIDE_CASES``) also carries the
    forward's ``_fwd_slack`` (the two sides' o differ by that beyond 1
    ulp, as ``test_forward_matches_reference`` holds them)."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo), (jqp, jkp, tqp, tkp), st = \
        _inputs(case, dtype)
    jdq, jdk, jdv = _jax_vjp(jq, jk, jv, jdo, jqp, jkp, *st)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    o = F.flash_attention(*leaves, tqp, tkp, *st)
    o.backward(tdo)
    o_extra = (_fwd_slack(tq, tk, tv, tqp, tkp, *st) if case in WIDE_CASES
               else None)
    slack = _bwd_slack(tq, tk, tv, tdo, tqp, tkp, *st, o_extra=o_extra)
    for t, j, name, extra in zip(leaves, (jdq, jdk, jdv), ("dq", "dk", "dv"),
                                 slack):
        assert t.grad.dtype == t.dtype
        _assert_close(t.grad, j, dtype, name, extra)


def test_fully_masked_row_keeps_the_reference_values():
    """A query with no valid key gets the mean of v and lse = NEG + log Sk
    (= NEG in f32), and in the backward p = exp(0) = 1 for each key, as
    the reference kernels give (held against them above; here the values
    themselves): with dO zero but on that row, dv of every key is the sum
    of that row's dO over the kv head's query heads, and dq, dk are 0 (ds
    is masked).  f32, rtol/atol 1e-6."""
    case = CASES[IDS.index("k_pos -1 slots, row 0 fully masked")]
    _, (tq, tk, tv, tdo), (_, _, tqp, tkp), st = _inputs(case, "float32")
    o, lse = F.flash_fwd(tq, tk, tv, tqp, tkp, *st)
    KV = tk.shape[1]
    G = tq.shape[1] // KV
    torch.testing.assert_close(o[:, :, 0],
                               tv.mean(dim=2).repeat_interleave(G, dim=1),
                               rtol=1e-6, atol=1e-6)
    assert (lse[:, :, 0] == F.NEG).all()
    do = torch.zeros_like(tdo)
    do[:, :, 0] = tdo[:, :, 0]
    delta = (do * o).sum(-1)
    args = (tq, tk, tv, do, lse, delta, tqp, tkp, *st)
    dk, dv = F.flash_dkv(*args)
    want = do[:, :, 0].reshape(tq.shape[0], KV, G, -1).sum(2)
    torch.testing.assert_close(dv, want[:, :, None].expand_as(dv),
                               rtol=1e-6, atol=1e-6)
    assert (dk == 0).all() and (F.flash_dq(*args) == 0).all()


def test_wrappers_validate_their_operands():
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    pos = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of KV"):
        F.flash_fwd(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16),
                    pos, pos, 0.25, True, None, None)
    with pytest.raises(ValueError, match="int32"):
        F.flash_fwd(q, k, k, pos.long(), pos, 0.25, True, None, None)
    with pytest.raises(ValueError, match="share"):
        F.flash_fwd(q, k.bfloat16(), k, pos, pos, 0.25, True, None, None)
    lse = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="lse and delta"):
        F.flash_dq(q, k, k, q, lse.double(), lse, pos, pos, 0.25, True, None,
                   None)



@pytest.mark.parametrize("d", [120, 256])
def test_flash_differentiates_through_dq_and_dkv_at_the_windowed_dims(d):
    """At d = 120 and 256 ``flash_attention`` is differentiable: one
    forward and one backward call the forward, dq and dk/dv wrappers once
    each, and the gradients have the leaves' shapes and dtype."""
    q = torch.randn(1, 2, 8, d)
    k = torch.randn(1, 1, 8, d)
    pos = torch.arange(8, dtype=torch.int32)
    calls = []
    saved = {n: getattr(F, n) for n in ("flash_fwd", "flash_dq",
                                        "flash_dkv")}
    try:
        for n, fn in saved.items():
            setattr(F, n, lambda *a, n=n, fn=fn: calls.append(n) or fn(*a))
        leaves = [t.clone().requires_grad_() for t in (q, k, k)]
        o = F.flash_attention(*leaves, pos, pos, d ** -0.5, True, 4, None)
        o.sum().backward()
    finally:
        for n, fn in saved.items():
            setattr(F, n, fn)
    assert sorted(calls) == ["flash_dkv", "flash_dq", "flash_fwd"]
    for t in leaves:
        assert t.grad.shape == t.shape and t.grad.dtype == t.dtype


# ---------------------------------------------------------------------------
# full_attention: the flash path at S > q_chunk, _attend below it
# ---------------------------------------------------------------------------

def _attn_inputs(S, dtype, seed=1):
    fields = dict(num_heads=4, num_kv_heads=2, head_dim=16)
    d = 64
    rng = np.random.default_rng(seed)
    p = {"wq": rng.standard_normal((d, 64)) * d ** -0.5,
         "wk": rng.standard_normal((d, 32)) * d ** -0.5,
         "wv": rng.standard_normal((d, 32)) * d ** -0.5,
         "wo": rng.standard_normal((64, d)) * 64 ** -0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    return (JAttentionConfig(**fields), AttentionConfig(**fields), jp, tp,
            jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _jax_full(jp, jx, jcfg, S, q_chunk):
    f = jax.jit(lambda p, x: jattn.full_attention(
        p, x, jcfg, positions=jnp.arange(S), q_chunk=q_chunk, mesh=None)[0])
    return np.asarray(f(jp, jx).astype(jnp.float32))


def _port_full(tp, tx, tcfg, S, q_chunk):
    y, _ = tattn.full_attention(tp, tx, tcfg, q_chunk=q_chunk,
                                positions=torch.arange(S, dtype=torch.int32))
    return y.float().numpy()


def test_full_attention_flash_path_matches_reference(monkeypatch):
    """S=128 > q_chunk=32, f32: the port's flash path (through the
    wrappers) against the reference's one-device flash path, at the
    reference's own tolerance for that path (rtol 1e-4 / atol 1e-5)."""
    calls = []
    fwd = F.flash_fwd
    monkeypatch.setattr(F, "flash_fwd",
                        lambda *a: calls.append(1) or fwd(*a))
    jcfg, tcfg, jp, tp, jx, tx = _attn_inputs(128, "float32")
    np.testing.assert_allclose(_port_full(tp, tx, tcfg, 128, 32),
                               _jax_full(jp, jx, jcfg, 128, 32), rtol=1e-4,
                               atol=1e-5)
    assert calls == [1]


def test_short_sequences_keep_the_attend_semantics():
    """S=64 <= q_chunk in bf16: the port's ``_attend`` path (p rounded to
    bf16 before the value product) equals the reference's within 1 bf16
    ulp of y plus 2^-8·max|y| (the two round p and sum the bf16 products
    in other orders), while the flash path on the same input (forced with
    q_chunk=32; p kept in f32) lands measurably further away: its worst
    difference from the reference exceeds twice the worst ``_attend``
    difference.  The two paths must stay apart."""
    jcfg, tcfg, jp, tp, jx, tx = _attn_inputs(64, "bfloat16")
    ref = _jax_full(jp, jx, jcfg, 64, 512)
    attend = _port_full(tp, tx, tcfg, 64, 512)
    flash = _port_full(tp, tx, tcfg, 64, 32)
    tol = _bf16_ulp(ref) + 2.0 ** -8 * np.abs(ref).max()
    err_attend = np.abs(attend - ref)
    assert (err_attend <= tol).all(), (err_attend / tol).max()
    assert np.abs(flash - ref).max() > 2 * err_attend.max()


# ---------------------------------------------------------------------------
# the chunked REPRO_FLASH=0 baseline
# ---------------------------------------------------------------------------

def _full_and_grads(jcfg, tcfg, jp, tp, jx, tx, S, q_chunk):
    """(y, grads of sum(y²)/2 in x and the four projections) of the
    reference's full_attention (jitted value_and_grad) and the port's."""
    def f(p, x):
        y, _ = jattn.full_attention(p, x, jcfg, positions=jnp.arange(S),
                                    q_chunk=q_chunk)
        return 0.5 * jnp.sum(y * y), y
    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jp, jx)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    x = tx.clone().requires_grad_()
    y, _ = tattn.full_attention(leaves, x, tcfg, q_chunk=q_chunk,
                                positions=torch.arange(S, dtype=torch.int32))
    keys = sorted(leaves)
    g = torch.autograd.grad(0.5 * (y * y).sum(), [x] + [leaves[k]
                                                      for k in keys])
    ref = [np.asarray(jy), np.asarray(jgx)] + [np.asarray(jgp[k])
                                               for k in keys]
    return ref, [t.detach().numpy() for t in (y, *g)]


def test_chunked_baseline_matches_reference(monkeypatch):
    """``REPRO_FLASH=0`` on both sides (the reference's
    ``test_model_flash_path_matches_jnp_path`` shapes: GQA 4:2, head dim
    16, d 64, one row of S=128, q_chunk 32): the port's chunked path —
    each chunk of 32 queries through ``_attend`` against every key under
    ``torch.utils.checkpoint`` — against the reference's, forward and
    the gradients of x and the four projections, at the reference's rtol
    1e-4 / atol 1e-5; the flash kernels are not called."""
    jcfg, tcfg, jp, tp, jx, tx = _attn_inputs(128, "float32")
    calls = []
    fwd = F.flash_fwd
    monkeypatch.setattr(F, "flash_fwd", lambda *a: calls.append(1) or fwd(*a))
    monkeypatch.setenv("REPRO_FLASH", "0")
    assert not tattn.use_flash()
    ref, got = _full_and_grads(jcfg, tcfg, jp, tp, jx[:1], tx[:1], 128, 32)
    assert not calls
    for r, g in zip(ref, got, strict=True):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5)


def test_flash_path_matches_the_chunked_path(monkeypatch):
    """In the port, S=128 past q_chunk 32 (f32, two rows): the flash path
    and the ``REPRO_FLASH=0`` chunked path give the same output and
    gradients (rtol 1e-4, atol 1e-5: in f32 ``_attend``'s p rounding to
    v's dtype is none); the chunked path refuses an S that q_chunk does
    not divide, as the reference asserts."""
    _, tcfg, _, tp, _, tx = _attn_inputs(128, "float32")

    def run():
        leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
        x = tx.clone().requires_grad_()
        y, _ = tattn.full_attention(leaves, x, tcfg, q_chunk=32,
                                    positions=torch.arange(
                                        128, dtype=torch.int32))
        keys = sorted(leaves)
        g = torch.autograd.grad(0.5 * (y * y).sum(),
                                [x] + [leaves[k] for k in keys])
        return [t.detach().numpy() for t in (y, *g)]
    flash = run()
    monkeypatch.setenv("REPRO_FLASH", "0")
    chunked = run()
    for a, b in zip(flash, chunked, strict=True):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="q_chunk"):
        tattn.full_attention(tp, tx[:, :120], tcfg, q_chunk=32,
                             positions=torch.arange(120, dtype=torch.int32))
