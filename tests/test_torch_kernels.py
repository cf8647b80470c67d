"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its kernel's plain PyTorch version; the
JAX kernels run in Pallas interpret mode.  Inputs come from numpy seeds
and go to both sides.  The CUDA kernels themselves are held against the
same plain versions on the card by ``chip_smoke.py``.
"""
import pathlib

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
    if name == "ties":
        return rng.integers(0, 3, (77, 16)).astype(np.float32), 2
    S, E, k = {"S=64 k=1": (64, 16, 1), "S=64 k=2": (64, 16, 2),
               "S=37 k=2": (37, 16, 2), "decode S=8": (8, 16, 1),
               "E=40 k=3": (50, 40, 3)}[name]
    return rng.standard_normal((S, E)).astype(np.float32), k


@pytest.mark.parametrize("name", ["S=64 k=1", "S=64 k=2", "S=37 k=2", "ties",
                                  "decode S=8", "E=40 k=3"])
def test_topk_gate_matches_pallas(name):
    """idx, vals and rowmax exact (lowest-index ties); sumexp rtol 1e-6
    (the two sums add in other orders)."""
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
# wrapper contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda: K.fused_topk_gate(torch.zeros(4, 8, dtype=torch.float64), 1),
    lambda: K.fused_topk_gate(torch.zeros(4, 8), 9),
    lambda: L.gather_rows(torch.zeros(4, 8), torch.zeros(3, dtype=torch.int64)),
    lambda: G.grouped_matmul(torch.zeros(4, 8), torch.zeros(2, 8, 3),
                             torch.zeros(2, dtype=torch.int32)),
    lambda: G.grouped_matmul(torch.zeros(4, 8, dtype=torch.bfloat16),
                             torch.zeros(2, 8, 3),
                             torch.zeros(3, dtype=torch.int32)),
])
def test_wrappers_reject_bad_inputs(call):
    with pytest.raises(ValueError):
        call()


def test_wrappers_refuse_gradients():
    """No backward kernels in this slice: a call autograd would
    differentiate raises instead of returning a wrong gradient."""
    x = torch.randn(4, 8, requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        L.gather_rows(x, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="training slice"):
        G.grouped_matmul(x, torch.randn(1, 8, 3),
                         torch.tensor([0, 4], dtype=torch.int32))
    with torch.no_grad():
        L.gather_rows(x, torch.zeros(2, dtype=torch.int32))


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
