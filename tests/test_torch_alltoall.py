"""The port's AllToAll forms (``core/alltoall.py``) on gloo CPU ranks
(``launch.mesh.spawn``) against the reference's under ``shard_map`` on
the conftest's fake devices, with the same numpy inputs: flat and
hierarchical at 1x4 (inner 2) and 1x8 (inner 2 and 4), the grouped
exchange, the int8/fp8 payloads; plus the quantizer, the α–β cost model,
``fit_alpha_beta`` and the reference's ValueErrors."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_ranks
from repro.core import alltoall as jalltoall
from repro.core import tuning as jtuning
from repro.core.compat import shard_map
from repro.launch.mesh import make_smoke_mesh
from repro_torch.core import alltoall, tuning
from repro_torch.launch.mesh import spawn

C, DM, E_LOCAL = 3, 8, 2
SHAPES = {(1, 4): (2,), (1, 8): (2, 4)}
QDTS = ("int8", "float8_e4m3fn", "float8_e5m2")
# |dequant(quantize(x)) - x| <= tol · chunk amax: the reference's
# QUANT_TOLS (tests/test_alltoall.py) — int8's half step of a 1/127 grid,
# e4m3's 3 and e5m2's 2 mantissa bits
QUANT_TOLS = {"int8": 0.005, "float8_e4m3fn": 0.07, "float8_e5m2": 0.15}


def _inputs(M, seed=3):
    rng = np.random.default_rng(seed)
    mag = np.array([0.1, 1.0, 10.0, 100.0] * M, np.float32)[:M]
    x = (rng.standard_normal((M, M, C, DM)) * mag[None, :, None, None]
         ).astype(np.float32)
    g = rng.standard_normal((M, M, C, DM)).astype(np.float32)
    counts = rng.integers(0, 9, (M, M, E_LOCAL)).astype(np.int32)
    return x, g, counts


def _shmap(mesh, fn, n_in=1):
    spec = P("model")
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,) * n_in,
                             out_specs=spec, check_vma=False))


def _reference(shape, inners, x, g, counts):
    M = shape[1]
    mesh = make_smoke_mesh(shape)
    X = jnp.asarray(x.reshape(M * M, C, DM))
    G = jnp.asarray(g.reshape(M * M, C, DM))
    cnt = jnp.asarray(counts.reshape(M * M, E_LOCAL))
    out = {"flat": _shmap(mesh, lambda v: jalltoall.flat_all_to_all(
        v, "model"))(X)}
    out["flat/dx"] = _shmap(mesh, lambda v: jalltoall.flat_all_to_all(
        v, "model"))(G)
    for mode, inner in [("flat", 1)] + [("hierarchical", i) for i in inners]:
        key = f"{mode}{inner}"
        spec = P("model")
        fn = jax.jit(shard_map(
            lambda v, c, mode=mode, inner=inner: jalltoall.grouped_all_to_all(
                v, c, "model", mode=mode, inner=inner), mesh=mesh,
            in_specs=(spec, spec), out_specs=(spec, spec), check_vma=False))
        out[f"grouped/{key}"], out[f"grouped/{key}/counts"] = fn(X, cnt)
        for q in QDTS:
            def qx(v, c, q=q, mode=mode, inner=inner):
                return jalltoall.quantized_exchange(
                    v, c, "model", mode=mode, inner=inner, payload_dtype=q)
            fn = jax.jit(shard_map(qx, mesh=mesh, in_specs=(spec, spec),
                                   out_specs=(spec, spec), check_vma=False))
            out[f"q/{q}/{key}"], out[f"q/{q}/{key}/counts"] = fn(X, cnt)
            out[f"q/{q}/{key}/dx"] = jax.jit(jax.grad(
                lambda v: jnp.sum(fn(v, cnt)[0] * G)))(X)
            out[f"q/{q}/{key}/combine"] = _shmap(
                mesh, lambda v, q=q, mode=mode, inner=inner:
                jalltoall.quantized_exchange(
                    v, None, "model", mode=mode, inner=inner,
                    payload_dtype=q, out_dtype=jnp.float32)[0])(
                X.astype(jnp.bfloat16))
    return {k: np.asarray(v, np.float32 if "counts" not in k else np.int32)
            .reshape(M, M, *np.shape(v)[1:]) for k, v in out.items()}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for shape, inners in SHAPES.items():
        M = shape[1]
        x, g, counts = _inputs(M)
        ranks = spawn(torch_ranks.exchange_rank, M, backend="gloo",
                      threads=1, args=(shape, x, g, inners, counts, QDTS))
        port = {k: np.stack([r[k] for r in ranks]) for k in ranks[0]}
        out[shape] = (port, _reference(shape, inners, x, g, counts), x, g)
    return out


CELLS = [(s, i) for s, inners in SHAPES.items() for i in inners]
IDS = [f"{s[0]}x{s[1]}-inner{i}" for s, i in CELLS]


@pytest.mark.parametrize("shape", list(SHAPES), ids=["1x4", "1x8"])
def test_flat_equals_lax_all_to_all_and_its_backward(runs, shape):
    """flat_all_to_all ≡ lax.all_to_all(tiled) bitwise; its backward is
    the inverse exchange (the same permutation, an involution), bitwise;
    one collective."""
    port, ref, _, _ = runs[shape]
    np.testing.assert_array_equal(port["flat"], ref["flat"])
    np.testing.assert_array_equal(port["flat/dx"], ref["flat/dx"])
    assert set(port["flat/n"].tolist()) == {1}


@pytest.mark.parametrize("shape,inner", CELLS, ids=IDS)
def test_hierarchical_equals_flat_bitwise(runs, shape, inner):
    """The two-stage form (through all_to_all and hierarchical_all_to_all)
    equals the flat one bitwise, forward and backward (its stages
    reversed), in two collectives."""
    port = runs[shape][0]
    for name in (f"hier{inner}", f"direct{inner}"):
        np.testing.assert_array_equal(port[name], port["flat"])
        np.testing.assert_array_equal(port[name + "/dx"], port["flat/dx"])
        assert set(port[name + "/n"].tolist()) == {2}


@pytest.mark.parametrize("shape,key", [
    (s, k) for s, inners in SHAPES.items()
    for k in ["flat1"] + [f"hierarchical{i}" for i in inners]])
def test_grouped_exchange_matches_reference(runs, shape, key):
    """grouped_all_to_all: the payload bitwise, the counts exact."""
    port, ref, _, _ = runs[shape]
    np.testing.assert_array_equal(port[f"grouped/{key}"],
                                  ref[f"grouped/{key}"])
    np.testing.assert_array_equal(port[f"grouped/{key}/counts"],
                                  ref[f"grouped/{key}/counts"])


@pytest.mark.parametrize("qdt", QDTS)
@pytest.mark.parametrize("shape,key", [((1, 4), "flat1"),
                                       ((1, 4), "hierarchical2"),
                                       ((1, 8), "hierarchical4")])
def test_quantized_exchange_matches_reference(runs, shape, key, qdt):
    """The quantized exchange (scales riding the counts): counts exact;
    payload, the bf16 combine direction (into f32) and the gradient (the
    cotangent on the same wire) within the reference's QUANT_TOLS of each
    chunk's amax (the gradient: two steps)."""
    port, ref, x, g = runs[shape]
    k = f"q/{qdt}/{key}"
    np.testing.assert_array_equal(port[k + "/counts"], ref[k + "/counts"])
    tol = QUANT_TOLS[qdt]
    for name, src, steps in (("", ref[k], 1), ("/combine", ref[k + "/combine"],
                                                1), ("/dx", ref[k + "/dx"],
                                                     2)):
        amax = np.abs(src).max(axis=(-2, -1), keepdims=True)
        assert np.all(np.abs(port[k + name] - src)
                      <= steps * tol * amax + 1e-30), name


@pytest.mark.parametrize("qdt", QDTS)
def test_quantize_payload_matches_reference(qdt):
    """Codes and scales equal the reference's; an all-zero chunk's scale
    is 1; the round trip stays within a grid step of the chunk amax."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4, 16, 32))
         * np.array([0.1, 1.0, 10.0, 0.0])[:, None, None]).astype(np.float32)
    jq, js = jalltoall.quantize_payload(jnp.asarray(x), qdt)
    q, s = alltoall.quantize_payload(torch.from_numpy(x), qdt)
    assert q.dtype == getattr(torch, qdt) and s.dtype == torch.float32
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.float().numpy(),
                                  np.asarray(jq, np.float32))
    assert float(s[3]) == 1.0
    y = alltoall.dequantize_payload(q, s, torch.float32).numpy()
    amax = np.abs(x).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(y - x) <= QUANT_TOLS[qdt] * amax)
    with pytest.raises(ValueError, match="payload"):
        alltoall.quantize_payload(torch.zeros(2, 4), "int4")


@pytest.mark.parametrize("N,G", [(1, 8), (2, 4), (4, 2), (16, 8)])
@pytest.mark.parametrize("nbytes", [1e3, 1e6, 2.5e8])
def test_cost_model_equals_reference(N, G, nbytes):
    """cost_flat, cost_hierarchical and cost_pipelined equal the
    reference's on the paper's pair and on a fitted pair."""
    for fast, slow in ((jalltoall.PCIE, jalltoall.ETH100),
                       (jalltoall.LinkSpec(3e-6, 1e-10),
                        jalltoall.LinkSpec(3e-6, 1e-10))):
        tf = alltoall.LinkSpec(fast.alpha, fast.beta)
        ts = alltoall.LinkSpec(slow.alpha, slow.beta)
        for jf, tfn in ((jalltoall.cost_flat, alltoall.cost_flat),
                        (jalltoall.cost_hierarchical,
                         alltoall.cost_hierarchical)):
            assert tfn(nbytes, N, G, tf, ts) == jf(nbytes, N, G, fast, slow)
        for P_ in (2, 4):
            assert alltoall.cost_pipelined(
                nbytes, N, G, tf, ts, n_chunks=P_, compute_s=1e-4) == \
                jalltoall.cost_pipelined(nbytes, N, G, fast, slow,
                                         n_chunks=P_, compute_s=1e-4)
    assert alltoall.PCIE == alltoall.LinkSpec(jalltoall.PCIE.alpha,
                                              jalltoall.PCIE.beta)
    assert alltoall.ETH100 == alltoall.LinkSpec(jalltoall.ETH100.alpha,
                                                jalltoall.ETH100.beta)


@pytest.mark.parametrize("points", [
    [(1e3, 2e-5), (1e6, 1e-4)], [(8e3, 4e-5), (6.4e4, 9e-5), (5e5, 7e-4)],
    [(1e3, 5e-4), (1e6, 1e-4)]])
def test_fit_alpha_beta_equals_reference(points):
    """The least-squares α–β fit (clamped positive) equals the
    reference's; fewer than two points raise."""
    t, j = tuning.fit_alpha_beta(points), jtuning.fit_alpha_beta(points)
    assert (t.alpha, t.beta) == (j.alpha, j.beta)
    with pytest.raises(ValueError, match=">= 2"):
        tuning.fit_alpha_beta(points[:1])


@pytest.mark.parametrize("kw", [dict(mode="ring"), dict(
    mode="hierarchical", inner=0), dict(mode="hierarchical", inner=3),
    dict(mode="hierarchical", inner=2, outer=3)])
def test_all_to_all_raises_the_reference_errors(kw):
    """all_to_all's ValueErrors, word for word the reference's (a model
    axis of 4; the checks run before any exchange)."""
    mesh = types.SimpleNamespace(shape={"model": 4}, model_group=None,
                                 hierarchical_groups=lambda i: (None, None))
    with pytest.raises(ValueError) as want:
        jalltoall.all_to_all(jnp.zeros((4, 2)), "model", **kw)
    with pytest.raises(ValueError) as got:
        alltoall.all_to_all(torch.zeros(4, 2), mesh, **kw)
    assert str(got.value) == str(want.value)
