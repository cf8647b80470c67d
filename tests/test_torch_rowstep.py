"""The row-per-step gather (the seed's tiling, kept as the blocked gather's
benchmark baseline): the port's plain version against the JAX package's
``gather_rows_rowstep`` in Pallas interpret mode, bitwise, and the
wrapper's contract.  The CUDA kernel itself is held against the same plain
version on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import layout_transform as jlt
from repro_torch.kernels import layout_transform as L


def _case(name):
    """(src (N, d) f32, idx (M,) int32) from a numpy seed."""
    rng = np.random.default_rng(21)
    N, M, d = {"M=N=64, dropped slots": (64, 64, 128),
               "M>N": (16, 50, 128), "M<N": (80, 12, 64),
               "M=1": (32, 1, 128), "all -1": (20, 24, 64),
               "ragged d=100": (40, 30, 100)}[name]
    src = rng.standard_normal((N, d)).astype(np.float32)
    idx = rng.integers(-1, N, M).astype(np.int32)
    idx[rng.random(M) < 0.2] = -1
    if name == "all -1":
        idx[:] = -1
    return src, idx


NAMES = ["M=N=64, dropped slots", "M>N", "M<N", "M=1", "all -1",
         "ragged d=100"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_gather_rows_rowstep_matches_pallas(name, dtype):
    """Bitwise: a row copy, zero rows where idx < 0."""
    src, idx = _case(name)
    j = np.asarray(jlt.gather_rows_rowstep(
        jnp.asarray(src).astype(dtype), jnp.asarray(idx), interpret=True)
        .astype(jnp.float32))
    before = L.rowstep_launches
    t = L.gather_rows_rowstep(torch.from_numpy(src).to(getattr(torch, dtype)),
                              torch.from_numpy(idx))
    assert L.rowstep_launches == before      # CPU tensors: the plain version
    assert t.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(t.float().numpy(), j)
    if name == "all -1":
        assert not t.any()


def test_gather_rows_rowstep_equals_blocked_gather():
    """The baseline computes the blocked gather's function."""
    src, idx = _case("M>N")
    s, i = torch.from_numpy(src), torch.from_numpy(idx)
    assert torch.equal(L.gather_rows_rowstep(s, i), L.gather_rows(s, i))


@pytest.mark.parametrize("call", [
    lambda: L.gather_rows_rowstep(torch.zeros(4, 8),
                                  torch.zeros(3, dtype=torch.int64)),
    lambda: L.gather_rows_rowstep(torch.zeros(4, 8, dtype=torch.float16),
                                  torch.zeros(3, dtype=torch.int32)),
    lambda: L.gather_rows_rowstep(torch.zeros(8),
                                  torch.zeros(3, dtype=torch.int32)),
    lambda: L.gather_rows_rowstep(
        torch.zeros(4, 8, device="meta"),
        torch.zeros(3, dtype=torch.int32, device="meta")),
])
def test_gather_rows_rowstep_rejects_bad_inputs(call):
    with pytest.raises(ValueError):
        call()


def test_gather_rows_rowstep_refuses_gradients():
    """The reference has no VJP for the baseline: a call autograd would
    differentiate raises, and a detached call runs."""
    src = torch.randn(6, 8, requires_grad=True)
    idx = torch.tensor([0, -1, 5], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="no backward"):
        L.gather_rows_rowstep(src, idx)
    with torch.no_grad():
        out = L.gather_rows_rowstep(src, idx)
    assert torch.equal(out[1], torch.zeros(8))
