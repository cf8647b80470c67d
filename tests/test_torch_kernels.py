"""The port's kernel modules against the JAX package's Pallas kernels,
forward and backward.

On the CPU each port wrapper runs its kernel's plain PyTorch version; the
JAX kernels run in Pallas interpret mode.  Inputs come from numpy seeds
and go to both sides.  The CUDA kernels themselves are held against the
same plain versions on the card by ``chip_smoke.py``.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import grouped_ffn as jgffn
from repro.kernels import layout_transform as jlt
from repro.kernels import topk_gate as jtopk
from repro_torch.kernels import build
from repro_torch.kernels import grouped_ffn as G
from repro_torch.kernels import layout_transform as L
from repro_torch.kernels import ops
from repro_torch.kernels import topk_gate as K


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(v), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


# ---------------------------------------------------------------------------
# kernel 1: fused top-k gate
# ---------------------------------------------------------------------------

def _gate_case(name):
    rng = np.random.default_rng(11)
    ties = {"ties": (77, 16, 2), "ties E=16 k=4": (64, 16, 4),
            "ties E=128 k=4": (40, 128, 4)}
    if name in ties:
        S, E, k = ties[name]
        return rng.integers(0, 3, (S, E)).astype(np.float32), k
    S, E, k = {"S=64 k=1": (64, 16, 1), "S=64 k=2": (64, 16, 2),
               "S=37 k=2": (37, 16, 2), "decode S=8": (8, 16, 1),
               "E=40 k=3": (50, 40, 3), "E=16 k=4": (64, 16, 4),
               "E=128 k=1": (40, 128, 1), "E=10 k=3": (33, 10, 3)}[name]
    return rng.standard_normal((S, E)).astype(np.float32), k


@pytest.mark.parametrize("name", ["S=64 k=1", "S=64 k=2", "S=37 k=2", "ties",
                                  "decode S=8", "E=40 k=3", "E=16 k=4",
                                  "E=128 k=1", "ties E=16 k=4",
                                  "ties E=128 k=4", "E=10 k=3"])
def test_topk_gate_matches_pallas(name):
    """idx, vals and rowmax exact (lowest-index ties); sumexp rtol 1e-6
    (the two sums add in other orders).  Beside the paper's E=16 k=1-2:
    the presets' (E, k) — dbrx's (16, 4), llama4's (128, 1) — exact ties
    at k=4 and E not a multiple of 4 (the kernel's scalar path)."""
    x, k = _gate_case(name)
    jv, ji, jm, js = (np.asarray(a) for a in jtopk.fused_topk_gate(
        jnp.asarray(x), k, interpret=True))
    before = K.launches
    tv, ti, tm, ts = (a.numpy() for a in K.fused_topk_gate(
        torch.from_numpy(x), k))
    assert K.launches == before          # CPU tensors take the plain version
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(ts, js, rtol=1e-6)


def test_topk_gate_plain_is_not_torch_topk_on_ties():
    """Exact ties resolve to the lowest index in every round."""
    x = torch.tensor([[1.0, 3.0, 3.0, 3.0], [2.0, 2.0, 2.0, 2.0]])
    _, idx, _, _ = K.fused_topk_gate(x, 3)
    assert idx.tolist() == [[1, 2, 3], [0, 1, 2]]


# ---------------------------------------------------------------------------
# kernel 2: row gather
# ---------------------------------------------------------------------------

def _gather_case(name):
    rng = np.random.default_rng(12)
    if name == "decode M=8":
        src = rng.standard_normal((64, 128)).astype(np.float32)
        return src, np.array([5, -1, 63, 0, 17, 17, -1, 3], np.int32)
    N, M, d = {"M=N=64 d=128": (64, 64, 128), "d=3": (20, 30, 3),
               "M>N": (16, 50, 128)}[name]
    src = rng.standard_normal((N, d)).astype(np.float32)
    idx = rng.integers(-1, N, M).astype(np.int32)
    idx[rng.random(M) < 0.2] = -1
    return src, idx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["M=N=64 d=128", "decode M=8", "d=3", "M>N"])
def test_gather_rows_matches_pallas(name, dtype):
    """Bitwise: a row copy, zero rows where idx < 0."""
    src, idx = _gather_case(name)
    j = np.asarray(jlt._gather_rows_impl(
        jnp.asarray(src).astype(dtype), jnp.asarray(idx), interpret=True)
        .astype(jnp.float32))
    t = L.gather_rows(torch.from_numpy(src).to(getattr(torch, dtype)),
                      torch.from_numpy(idx)).float().numpy()
    np.testing.assert_array_equal(t, j)


def test_layout_dispatch_without_inv_matches_with_inv():
    """ops.layout_dispatch inverts the slot map itself when no plan ``inv``
    is given; both forms give the same buffer."""
    tokens = torch.randn(6, 8)
    slot = torch.tensor([[0], [5], [-1], [1], [4], [3]], dtype=torch.int32)
    inv = torch.tensor([0, 3, -1, 5, 4, 1], dtype=torch.int32)
    a = ops.layout_dispatch(tokens, slot, 3, 2)
    b = ops.layout_dispatch(tokens, slot, 3, 2, inv=inv)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# kernel 3: grouped matmul (forward)
# ---------------------------------------------------------------------------

def _gmm_case(name):
    """(M, K, N, offsets): skewed segments, an empty expert, a tail past
    offsets[E]; the decode size; ragged tiles."""
    return {"skewed, empty expert, tail": (128, 64, 96,
                                           [0, 60, 60, 100, 117]),
            "decode M=8": (8, 64, 32, [0, 1, 1, 3, 7]),
            "ragged K=20 N=12": (50, 20, 12, [0, 25, 45])}[name]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["skewed, empty expert, tail", "decode M=8",
                                  "ragged K=20 N=12"])
def test_grouped_matmul_matches_pallas(name, dtype):
    """f32: rtol/atol 1e-5 (f32 sums in another order).  bf16: within 1
    bf16 ulp of the reference's f32-accumulated result rounded once, plus
    the f32 summation-order bound K·2^-24·Σ|a·b| (both accumulate exact
    bf16 products in f32, in other orders)."""
    M, Kd, N, offs = _gmm_case(name)
    rng = np.random.default_rng(13)
    E = len(offs) - 1
    lhs = rng.standard_normal((M, Kd)).astype(np.float32)
    rhs = (rng.standard_normal((E, Kd, N)) * Kd ** -0.5).astype(np.float32)
    offs = np.asarray(offs, np.int32)
    jl, jr = jnp.asarray(lhs).astype(dtype), jnp.asarray(rhs).astype(dtype)
    j = np.asarray(jgffn._grouped_matmul_impl(
        jl, jr, jnp.asarray(offs), interpret=True).astype(jnp.float32))
    tl = torch.from_numpy(lhs).to(getattr(torch, dtype))
    tr = torch.from_numpy(rhs).to(getattr(torch, dtype))
    t = G.grouped_matmul(tl, tr, torch.from_numpy(offs)).float().numpy()
    assert (t[offs[-1]:] == 0).all()
    if dtype == "float32":
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    else:
        order = Kd * 2.0 ** -24 * G.grouped_matmul_plain(
            tl.float().abs(), tr.float().abs(), torch.from_numpy(offs)).numpy()
        assert (np.abs(t - j) <= _bf16_ulp(j) + order).all()


def test_grouped_ffn_relu_matches_reference():
    """grouped_ffn (relu, the paper's act) through the kernel module equals
    the reference's Pallas grouped_ffn, f32 rtol/atol 1e-5."""
    rng = np.random.default_rng(14)
    E, d, f, M = 3, 32, 48, 40
    p = {"w_up": rng.standard_normal((E, d, f)).astype(np.float32) * 0.2,
         "w_out": rng.standard_normal((E, f, d)).astype(np.float32) * 0.2}
    xs = rng.standard_normal((M, d)).astype(np.float32)
    sizes = np.array([10, 0, 25], np.int32)
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    j = np.asarray(jgffn.grouped_ffn(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(xs),
        jnp.asarray(sizes), "relu", use_pallas=True, interpret=True))
    t = G.grouped_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(xs), torch.from_numpy(offs),
                      "relu").numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# kernel 6: row scatter-add (the gather's VJP)
# ---------------------------------------------------------------------------

def _scatter_case(name):
    """(g (M, d), idx (M,), n, max addends per output row)."""
    rng = np.random.default_rng(18)
    if name == "permutation with -1":
        idx = rng.permutation(64).astype(np.int32)
        idx[rng.random(64) < 0.2] = -1
        return rng.standard_normal((64, 96)).astype(np.float32), idx, 64, 1
    if name == "pairs (top_k=2), M>n":
        idx = np.concatenate([rng.permutation(40), rng.permutation(40)])
        idx = idx.astype(np.int32)
        idx[rng.random(80) < 0.1] = -1
        return rng.standard_normal((80, 33)).astype(np.float32), idx, 40, 2
    if name == "triples (top_k=3), M>n":
        idx = np.concatenate([rng.permutation(30) for _ in range(3)])
        idx = idx.astype(np.int32)
        idx[rng.random(90) < 0.1] = -1
        return rng.standard_normal((90, 40)).astype(np.float32), idx, 30, 3
    if name == "many duplicates":
        idx = rng.integers(-1, 5, 90).astype(np.int32)
        return rng.standard_normal((90, 16)).astype(np.float32), idx, 5, 90
    raise KeyError(name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["permutation with -1",
                                  "pairs (top_k=2), M>n",
                                  "triples (top_k=3), M>n", "many duplicates"])
def test_scatter_add_rows_matches_pallas(name, dtype):
    """Bitwise with at most two addends per output row (f32 sums of two
    bf16/f32 values are order-free and rounded once).  With many
    duplicates the reference adds in g's dtype, rounding after each
    addend, while the port rounds once from f32: f32 within 1e-5 of
    Σ|g|; bf16 within (c-1)·ulp(Σ|g|) + ulp(|out|) for a row of c
    addends — one rounding per extra addend in the reference."""
    g, idx, n, most = _scatter_case(name)
    jg = jnp.asarray(g).astype(dtype)
    j = np.asarray(jlt.scatter_add_rows(jg, jnp.asarray(idx), n,
                                        interpret=True).astype(jnp.float32))
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    before = L.scatter_launches
    t = L.scatter_add_rows(tg, torch.from_numpy(idx), n)
    assert L.scatter_launches == before      # the plain version on the CPU
    assert t.dtype == tg.dtype and t.shape == (n, g.shape[1])
    t = t.float().numpy()
    if most <= 2:
        np.testing.assert_array_equal(t, j)
        return
    absum = L.scatter_add_rows_plain(tg.float().abs(), torch.from_numpy(idx),
                                     n).numpy()
    if dtype == "float32":
        assert (np.abs(t - j) <= 1e-5 * absum + 1e-7).all()
    else:
        c = np.bincount(idx[idx >= 0], minlength=n)[:, None]
        tol = np.maximum(c - 1, 0) * _bf16_ulp(absum) + _bf16_ulp(j)
        assert (np.abs(t - j) <= tol).all()


def _scatter_add_index_add(g, idx, n):
    """The scatter-add's earlier plain form: one f32 ``index_add_`` over
    all rows (duplicates in the order the CPU kernel takes), rounded once."""
    keep = (idx >= 0) & (idx < n)
    acc = torch.zeros((n + 1, g.shape[1]), dtype=torch.float32)
    acc.index_add_(0, torch.where(keep, idx, n).long(), g.float())
    return acc[:n].to(g.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["permutation with -1",
                                  "pairs (top_k=2), M>n",
                                  "triples (top_k=3), M>n", "many duplicates"])
def test_scatter_add_plain_matches_index_add_form(name, dtype):
    """The ordered plain scatter-add (ascending input row, f32, one
    rounding) equals the one-pass ``index_add_`` form bitwise at <= 2
    addends per row (a sum of two is order-free); beyond that both are f32
    sums of the same c terms in other orders: within 2c·2^-24·Σ|g|, plus
    one ulp of the rounding to bf16."""
    g, idx, n, most = _scatter_case(name)
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    ti = torch.from_numpy(idx)
    new = L.scatter_add_rows_plain(tg, ti, n)
    old = _scatter_add_index_add(tg, ti, n)
    assert new.dtype == tg.dtype
    if most <= 2:
        assert torch.equal(new, old)
        return
    c = torch.bincount(ti[ti >= 0].long(), minlength=n).max().item()
    bound = 2 * c * 2.0 ** -24 * _scatter_add_index_add(tg.float().abs(), ti,
                                                        n)
    if dtype == "bfloat16":
        bound = bound + torch.from_numpy(_bf16_ulp(old.float().numpy()))
    assert ((new.float() - old.float()).abs() <= bound).all()


def test_scatter_add_plain_is_its_own_rerun_and_order_free():
    """The plain scatter-add depends on idx and g only: the same bits on a
    rerun, and a row's addends summed in ascending input row — so the
    result equals an explicit left-to-right f32 sum per row."""
    g, idx, n, _ = _scatter_case("many duplicates")
    tg, ti = torch.from_numpy(g), torch.from_numpy(idx)
    out = L.scatter_add_rows_plain(tg, ti, n)
    assert torch.equal(out, L.scatter_add_rows_plain(tg, ti, n))
    for r in range(n):
        acc = torch.zeros(g.shape[1])
        for i in np.flatnonzero(idx == r):
            acc = acc + tg[i]
        assert torch.equal(out[r], acc)


def test_gather_rows_gradient_matches_reference_vjp():
    """d src of gather_rows is the scatter-add: equal to jax.vjp of the
    reference's custom_vjp gather (f32: rows of at most two addends, so
    bitwise; bf16 likewise)."""
    g, idx, n, _ = _scatter_case("pairs (top_k=2), M>n")
    src = np.random.default_rng(19).standard_normal((n, g.shape[1])).astype(
        np.float32)
    for dtype in ("float32", "bfloat16"):
        _, vjp = jax.vjp(lambda s: jlt.gather_rows(s, jnp.asarray(idx), True),
                         jnp.asarray(src).astype(dtype))
        j = np.asarray(vjp(jnp.asarray(g).astype(dtype))[0].astype(
            jnp.float32))
        ts = torch.from_numpy(src).to(getattr(torch, dtype)).requires_grad_()
        out = L.gather_rows(ts, torch.from_numpy(idx))
        out.backward(torch.from_numpy(g).to(getattr(torch, dtype)))
        assert ts.grad.dtype == ts.dtype
        np.testing.assert_array_equal(ts.grad.float().numpy(), j)


# ---------------------------------------------------------------------------
# kernels 4 and 5: grouped matmul backward (dlhs, drhs)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["skewed, empty expert, tail", "decode M=8",
                                  "ragged K=20 N=12"])
def test_grouped_matmul_t_matches_pallas(name, dtype):
    """dlhs[seg_e] = g[seg_e] @ rhs[e]ᵀ against the reference kernel with
    transpose_rhs=True.  f32: rtol/atol 1e-5; bf16: 1 ulp of the
    reference plus the f32 summation-order bound N·2^-24·Σ|g·w| (as for
    the forward)."""
    M, Kd, N, offs = _gmm_case(name)
    rng = np.random.default_rng(20)
    E = len(offs) - 1
    g = rng.standard_normal((M, N)).astype(np.float32)
    rhs = (rng.standard_normal((E, Kd, N)) * N ** -0.5).astype(np.float32)
    offs = np.asarray(offs, np.int32)
    j = np.asarray(jgffn._grouped_matmul_impl(
        jnp.asarray(g).astype(dtype), jnp.asarray(rhs).astype(dtype),
        jnp.asarray(offs), interpret=True, transpose_rhs=True).astype(
        jnp.float32))
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    tr = torch.from_numpy(rhs).to(getattr(torch, dtype))
    before = G.dlhs_launches
    t = G.grouped_matmul_t(tg, tr, torch.from_numpy(offs))
    assert G.dlhs_launches == before
    assert t.dtype == tg.dtype and t.shape == (M, Kd)
    t = t.float().numpy()
    assert (t[offs[-1]:] == 0).all()
    if dtype == "float32":
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    else:
        order = N * 2.0 ** -24 * G.grouped_matmul_t_plain(
            tg.float().abs(), tr.float().abs(), torch.from_numpy(offs)).numpy()
        assert (np.abs(t - j) <= _bf16_ulp(j) + order).all()


def _drhs_case(name):
    """(M, K, N, offsets): empty experts and a tail past offsets[E]; a
    ragged last block (M not a multiple of the reference's block_m=128,
    segments crossing block edges)."""
    return {"empty experts, tail": (96, 40, 24, [0, 0, 30, 30, 81]),
            "ragged last block": (200, 16, 72, [0, 127, 129, 200]),
            "decode M=8": (8, 64, 32, [0, 1, 1, 3, 7])}[name]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["empty experts, tail", "ragged last block",
                                  "decode M=8"])
def test_grouped_drhs_matches_pallas(name, dtype):
    """drhs[e] = lhs[seg_e]ᵀ @ g[seg_e] in f32 against the reference
    kernel: empty experts exactly 0, rows past offsets[E] add nothing;
    within the f32 summation-order bound M·2^-24·Σ|a·b| + 1e-7 (bf16
    inputs: the products are exact in f32 on both sides)."""
    M, Kd, N, offs = _drhs_case(name)
    rng = np.random.default_rng(21)
    lhs = rng.standard_normal((M, Kd)).astype(np.float32)
    g = rng.standard_normal((M, N)).astype(np.float32)
    offs = np.asarray(offs, np.int32)
    j = np.asarray(jgffn._grouped_drhs_impl(
        jnp.asarray(lhs).astype(dtype), jnp.asarray(g).astype(dtype),
        jnp.asarray(offs), interpret=True))
    tl = torch.from_numpy(lhs).to(getattr(torch, dtype))
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    before = G.drhs_launches
    t = G.grouped_drhs(tl, tg, torch.from_numpy(offs))
    assert G.drhs_launches == before
    assert t.dtype == torch.float32 and t.shape == (len(offs) - 1, Kd, N)
    t = t.numpy()
    for e in range(len(offs) - 1):
        if offs[e + 1] <= offs[e]:
            assert (t[e] == 0).all() and (j[e] == 0).all()
    order = M * 2.0 ** -24 * G.grouped_drhs_plain(
        tl.float().abs(), tg.float().abs(), torch.from_numpy(offs)).numpy()
    assert (np.abs(t - j) <= order + 1e-7).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["empty experts, tail", "ragged last block",
                                  "decode M=8"])
def test_grouped_drhs_out_dtype_is_one_rounding(name, dtype):
    """``grouped_drhs(..., out_dtype=lhs.dtype)`` is the f32 result rounded
    once: bitwise ``grouped_drhs_plain(...).to(dtype)`` on the CPU; the
    default stays float32, as the reference's ``_grouped_drhs_impl``."""
    M, Kd, N, offs = _drhs_case(name)
    rng = np.random.default_rng(23)
    tl = torch.from_numpy(rng.standard_normal((M, Kd)).astype(
        np.float32)).to(getattr(torch, dtype))
    tg = torch.from_numpy(rng.standard_normal((M, N)).astype(
        np.float32)).to(getattr(torch, dtype))
    to = torch.tensor(offs, dtype=torch.int32)
    out = G.grouped_drhs(tl, tg, to, out_dtype=tl.dtype)
    assert out.dtype == tl.dtype
    assert torch.equal(out, G.grouped_drhs_plain(tl, tg, to).to(tl.dtype))
    assert G.grouped_drhs(tl, tg, to).dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_gradients_match_reference_vjp(dtype):
    """Autograd through grouped_matmul (dlhs + drhs kernels' plain
    versions) against jax.vjp of the reference's custom_vjp Pallas
    grouped_matmul: dlhs in lhs.dtype, drhs in rhs.dtype.  f32: rtol/atol
    1e-5; bf16: 1 ulp + the f32 order bound (dlhs), and drhs rounded to
    bf16 once on both sides: 1 ulp + the order bound."""
    M, Kd, N, offs = _gmm_case("skewed, empty expert, tail")
    rng = np.random.default_rng(22)
    E = len(offs) - 1
    lhs = rng.standard_normal((M, Kd)).astype(np.float32)
    rhs = (rng.standard_normal((E, Kd, N)) * Kd ** -0.5).astype(np.float32)
    ct = rng.standard_normal((M, N)).astype(np.float32)
    offs = np.asarray(offs, np.int32)
    sizes = np.diff(offs)
    _, vjp = jax.vjp(lambda a, b: jgffn.grouped_matmul(
        a, b, jnp.asarray(sizes), True), jnp.asarray(lhs).astype(dtype),
        jnp.asarray(rhs).astype(dtype))
    jl, jr = (np.asarray(x.astype(jnp.float32)) for x in vjp(
        jnp.asarray(ct).astype(dtype)))
    tl = torch.from_numpy(lhs).to(getattr(torch, dtype)).requires_grad_()
    tr = torch.from_numpy(rhs).to(getattr(torch, dtype)).requires_grad_()
    out = G.grouped_matmul(tl, tr, torch.from_numpy(offs))
    out.backward(torch.from_numpy(ct).to(getattr(torch, dtype)))
    assert tl.grad.dtype == tl.dtype and tr.grad.dtype == tr.dtype
    dl, dr = tl.grad.float().numpy(), tr.grad.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(dl, jl, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dr, jr, rtol=1e-5, atol=1e-5)
        return
    to = torch.from_numpy(offs)
    tc = torch.from_numpy(ct).to(torch.bfloat16).float()
    ol = N * 2.0 ** -24 * G.grouped_matmul_t_plain(
        tc.abs(), tr.detach().float().abs(), to).numpy()
    orr = M * 2.0 ** -24 * G.grouped_drhs_plain(
        tl.detach().float().abs(), tc.abs(), to).numpy()
    assert (np.abs(dl - jl) <= _bf16_ulp(jl) + ol).all()
    assert (np.abs(dr - jr) <= _bf16_ulp(jr) + orr).all()


# ---------------------------------------------------------------------------
# wrapper contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda: K.fused_topk_gate(torch.zeros(4, 8, dtype=torch.float64), 1),
    lambda: K.fused_topk_gate(torch.zeros(4, 8), 9),
    lambda: L.gather_rows(torch.zeros(4, 8), torch.zeros(3, dtype=torch.int64)),
    # the fan-out form's dest: (N, K) int32 on src's device
    lambda: L.gather_rows(torch.zeros(4, 8), torch.zeros(3, dtype=torch.int32),
                          torch.zeros(3, 2, dtype=torch.int32)),
    lambda: L.gather_rows(torch.zeros(4, 8), torch.zeros(3, dtype=torch.int32),
                          torch.zeros(4, dtype=torch.int32)),
    lambda: L.gather_rows(torch.zeros(4, 8), torch.zeros(3, dtype=torch.int32),
                          torch.zeros(4, 2, dtype=torch.int64)),
    lambda: L.gather_rows(torch.zeros(4, 8), torch.zeros(3, dtype=torch.int32),
                          torch.zeros(4, 2, dtype=torch.int32, device="meta")),
    lambda: K.fused_topk_gate(torch.zeros(4, 513), 1),
    lambda: G.grouped_matmul(torch.zeros(4, 8), torch.zeros(2, 8, 3),
                             torch.zeros(2, dtype=torch.int32)),
    lambda: G.grouped_matmul(torch.zeros(4, 8, dtype=torch.bfloat16),
                             torch.zeros(2, 8, 3),
                             torch.zeros(3, dtype=torch.int32)),
    lambda: L.scatter_add_rows(torch.zeros(4, 8, dtype=torch.float16),
                               torch.zeros(4, dtype=torch.int32), 3),
    lambda: L.scatter_add_rows(torch.zeros(4, 8),
                               torch.zeros(3, dtype=torch.int32), 3),
    lambda: G.grouped_matmul_t(torch.zeros(4, 8), torch.zeros(2, 8, 3),
                               torch.zeros(3, dtype=torch.int32)),
    lambda: G.grouped_drhs(torch.zeros(4, 8), torch.zeros(5, 3),
                           torch.zeros(3, dtype=torch.int32)),
    lambda: G.grouped_drhs(torch.zeros(4, 8), torch.zeros(4, 3),
                           torch.zeros(3, dtype=torch.int32),
                           out_dtype=torch.bfloat16),
])
def test_wrappers_reject_bad_inputs(call):
    with pytest.raises(ValueError):
        call()


def test_wrappers_refuse_gradients():
    """The gate's top-k selection has no backward (the reference stops its
    gradient): a call autograd would differentiate raises instead of
    returning a wrong gradient, and a detached call runs."""
    x = torch.randn(4, 8, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        K.fused_topk_gate(x, 1)
    with torch.no_grad():
        K.fused_topk_gate(x, 1)
    K.fused_topk_gate(x.detach(), 1)


def test_gate_weights_train_through_detached_kernel():
    """ops.topk_softmax_weights hands the kernel detached logits, so the
    router's gradient flows through u/Σu only — equal to jax.vjp of the
    reference's weights (f32, rtol/atol 1e-6: the same softmax jacobian,
    summed in other orders)."""
    from repro.kernels import ops as jops
    x = np.random.default_rng(15).standard_normal((24, 16)).astype(
        np.float32)
    r = np.random.default_rng(16).standard_normal((24, 2)).astype(np.float32)
    q = np.random.default_rng(17).standard_normal((24, 16)).astype(
        np.float32)

    def jf(lg):
        _, w, p = jops.topk_softmax_weights(lg, 2)
        return jnp.sum(w * r) + jnp.sum(p * q)
    jg = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_()
    _, w, p = ops.topk_softmax_weights(t, 2)
    ((w * torch.from_numpy(r)).sum() + (p * torch.from_numpy(q)).sum()
     ).backward()
    np.testing.assert_allclose(t.grad.numpy(), jg, rtol=1e-6, atol=1e-6)


def test_wrappers_reject_other_devices():
    """Only CPU tensors take the plain version; any other non-CUDA device
    raises rather than falling back."""
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        L.gather_rows(x, torch.zeros(2, dtype=torch.int32, device="meta"))


def test_build_names_library_by_source_hash(monkeypatch, tmp_path):
    """The library's name follows the sources' hash, so an edited source
    builds anew; without nvcc the build raises instead of guessing."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in build.SOURCES:
        (csrc / name).write_text("// a\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    first = build.library_path()
    assert first == build.library_path()
    assert first.parent == build.BUILD_DIR
    (csrc / build.SOURCES[0]).write_text("// b\n")
    assert build.library_path() != first
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    if pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has a CUDA toolkit at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()
