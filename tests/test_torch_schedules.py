"""The plain twins of the CUDA kernels' work schedules, against the masks
and offsets they serve: the flash forward's and dq's k-tile skip
(``flash_attention.visited_k_tiles``, mirroring ``plan_k_tiles``), dk/dv's
q-tile skip (``flash_attention.visited_q_tiles``, mirroring
``plan_q_tiles``), the grouped matmul's row-tile schedule
(``grouped_ffn.tile_schedule``, mirroring ``find_tile``) and the
scatter-add's inverse of its index (``layout_transform.scatter_plan``,
mirroring ``scatter_plan_kernel`` and the ascending walk of
``scatter_sum_kernel``).  A schedule that
leaves out an allowed (q, k) pair, or a row, or covers a row twice, would
make a kernel wrong without any plain version noticing, so these hold the
rules themselves."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as F
from repro_torch.kernels import grouped_ffn as G
from repro_torch.kernels import layout_transform as L


# ---------------------------------------------------------------------------
# the flash forward's k-tile skip
# ---------------------------------------------------------------------------

def _positions(name):
    """(q_pos, k_pos, causal, window) of a case."""
    rng = np.random.default_rng(31)
    ar = lambda a, b: torch.arange(a, b, dtype=torch.int32)  # noqa: E731
    if name == "causal S=1024":
        return ar(0, 1024), ar(0, 1024), True, None
    if name == "q offset: q_pos 512..1023 against 1024 keys":
        return ar(512, 1024), ar(0, 1024), True, None
    if name == "first 100 key slots invalid":
        k = ar(0, 1024)
        k[:100] = -1
        return ar(0, 1024), k, True, None
    if name == "window 100, S=256":
        return ar(0, 256), ar(0, 256), True, 100
    if name == "S=600, -1 slots, row 0 fully masked":
        k = ar(0, 600)
        k[0] = -1
        k[torch.from_numpy(rng.random(600) < 0.1)] = -1
        return ar(0, 600), k, True, None
    if name == "Sq=100 Sk=200 non-causal, -1 slots":
        k = ar(0, 200)
        k[torch.from_numpy(rng.random(200) < 0.2)] = -1
        return ar(0, 100), k, False, None
    if name == "shuffled key positions, window 50":
        k = torch.from_numpy(rng.permutation(300).astype(np.int32))
        return ar(0, 300), k, True, 50
    raise KeyError(name)


FLASH_NAMES = ["causal S=1024", "q offset: q_pos 512..1023 against 1024 keys",
               "first 100 key slots invalid", "window 100, S=256",
               "S=600, -1 slots, row 0 fully masked",
               "Sq=100 Sk=200 non-causal, -1 slots",
               "shuffled key positions, window 50"]


@pytest.mark.parametrize("rows", [16, 64])
@pytest.mark.parametrize("name", FLASH_NAMES)
def test_visited_tiles_cover_every_allowed_pair(name, rows):
    """Every allowed (q, k) pair lies in a visited tile, and a group of
    rows (16 in the bf16 kernel, 64 in the f32 one) with a row that has no
    allowed key visits every tile."""
    q_pos, k_pos, causal, window = _positions(name)
    visit = F.visited_k_tiles(q_pos, k_pos, causal, window, rows)
    Sq, Sk = len(q_pos), len(k_pos)
    allowed = F._mask(q_pos, k_pos, causal, window).expand(Sq, Sk)
    T = F.TILE
    assert visit.shape == (math.ceil(Sq / rows), math.ceil(Sk / T))
    pair_tiles = torch.zeros_like(visit)
    for i in range(visit.shape[0]):
        for j in range(visit.shape[1]):
            pair_tiles[i, j] = allowed[i * rows:(i + 1) * rows,
                                       j * T:(j + 1) * T].any()
    assert not (pair_tiles & ~visit).any()
    for i in range(visit.shape[0]):
        if not allowed[i * rows:(i + 1) * rows].any(dim=1).all():
            assert visit[i].all()


def test_visited_tiles_at_the_training_shape():
    """Causal S=1024: each 64-row group visits its diagonal tile and those
    before it, 136 of 256 pairs; 16-row groups (the bf16 kernel's warps)
    visit the same 64x64 area, 544 of 1024 (16 x 64) pairs; q offset by
    512 visits all the k tiles up to its diagonal; the first 100 invalid
    slots take tile 0 out of every list but those of rows 0..99, which
    have no key and so visit everything."""
    visit = F.visited_k_tiles(*_positions("causal S=1024"), rows=64)
    assert int(visit.sum()) == 136
    assert torch.equal(visit, torch.ones(16, 16, dtype=torch.bool).tril())
    warps = F.visited_k_tiles(*_positions("causal S=1024"))
    assert int(warps.sum()) == 544
    assert torch.equal(warps, visit.repeat_interleave(4, dim=0))
    off = F.visited_k_tiles(*_positions(
        "q offset: q_pos 512..1023 against 1024 keys"), rows=64)
    assert torch.equal(off, torch.ones(16, 16, dtype=torch.bool).tril()[8:])
    inv = F.visited_k_tiles(*_positions("first 100 key slots invalid"))
    assert inv[:7].all()                      # rows 0..111: 0..99 see no key
    assert inv[7].tolist() == [False, True] + [False] * 14   # rows 112..127
    assert inv[8].tolist() == [False, True, True] + [False] * 13


def _tiled_forward(q, k, v, q_pos, k_pos, causal, window, visit):
    """The kernels' online softmax in float64 over 64-key tiles, visiting
    the tiles ``visit`` names per 16-row group (masked scores NEG, keys
    past Sk absent)."""
    R, T, NEG = F.GROUP, F.TILE, F.NEG
    Sq, Sk = q.shape[0], k.shape[0]
    allowed = F._mask(q_pos, k_pos, causal, window).expand(Sq, Sk).numpy()
    s_all = q @ k.T / math.sqrt(q.shape[1])
    o = np.zeros_like(q)
    lse = np.zeros(Sq)
    for i in range(visit.shape[0]):
        rows = slice(i * R, min(Sq, (i + 1) * R))
        m = np.full(rows.stop - rows.start, NEG)
        l = np.zeros_like(m)
        acc = np.zeros((rows.stop - rows.start, q.shape[1]))
        for j in np.nonzero(visit[i].numpy())[0]:
            cols = slice(j * T, min(Sk, (j + 1) * T))
            s = np.where(allowed[rows, cols], s_all[rows, cols], NEG)
            m_new = np.maximum(m, s.max(axis=1))
            alpha = np.exp(m - m_new)
            p = np.exp(s - m_new[:, None])
            l = l * alpha + p.sum(axis=1)
            acc = acc * alpha[:, None] + p @ v[cols]
            m = m_new
        o[rows] = acc / l[:, None]
        lse[rows] = m + np.log(l)
    return o, lse


@pytest.mark.parametrize("name", FLASH_NAMES[1:])
def test_skipping_tiles_changes_nothing(name):
    """The online softmax over the visited tiles only equals the one over
    every tile (float64, rtol/atol 1e-12: a skipped tile adds exp(NEG - m)
    = 0 to a row that met an allowed key, or is wiped by exp(NEG - m) = 0
    when it meets one), and both equal the plain forward (f32, 1e-5)."""
    q_pos, k_pos, causal, window = _positions(name)
    rng = np.random.default_rng(32)
    Sq, Sk, d = len(q_pos), len(k_pos), 16
    q, k, v = (rng.standard_normal((n, d)) for n in (Sq, Sk, Sk))
    visit = F.visited_k_tiles(q_pos, k_pos, causal, window)
    o_skip, lse_skip = _tiled_forward(q, k, v, q_pos, k_pos, causal, window,
                                      visit)
    o_all, lse_all = _tiled_forward(q, k, v, q_pos, k_pos, causal, window,
                                    torch.ones_like(visit))
    np.testing.assert_allclose(o_skip, o_all, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(lse_skip, lse_all, rtol=1e-12, atol=1e-12)
    t = lambda a: torch.from_numpy(a).float()[None, None]  # noqa: E731
    o_p, lse_p = F.flash_fwd_plain(t(q), t(k), t(v), q_pos, k_pos,
                                   d ** -0.5, causal, window, None)
    np.testing.assert_allclose(o_skip, o_p[0, 0].numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lse_skip, lse_p[0, 0].numpy(), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# dk/dv's q-tile skip, and the backward over the visited tiles
# ---------------------------------------------------------------------------

def _tile_pairs(allowed, T=F.TILE):
    """(nk, nq, T, T) views of an (Sq, Sk) bool matrix padded with False to
    whole tiles: [j, i] is q tile i against k tile j."""
    Sq, Sk = allowed.shape
    nq, nk = -(-Sq // T), -(-Sk // T)
    pad = torch.zeros(nq * T, nk * T, dtype=torch.bool)
    pad[:Sq, :Sk] = allowed
    return pad.reshape(nq, T, nk, T).permute(2, 0, 1, 3)


@pytest.mark.parametrize("name", FLASH_NAMES)
def test_visited_q_tiles_cover_every_needed_pair(name):
    """Every allowed (q, k) pair lies in a tile that dk/dv computes in full
    (VISIT or NO_MASK); every pair of a row with no allowed key lies in a
    visited tile (it adds p = 1 to dv); a NO_MASK tile has every pair
    allowed and 64 valid keys; DV_ONLY and SKIP tiles hold no allowed
    pair, and SKIP tiles no row without a key."""
    q_pos, k_pos, causal, window = _positions(name)
    codes = F.visited_q_tiles(q_pos, k_pos, causal, window)
    Sq, Sk = len(q_pos), len(k_pos)
    T = F.TILE
    assert codes.shape == (math.ceil(Sk / T), math.ceil(Sq / T))
    allowed = F._mask(q_pos, k_pos, causal, window).expand(Sq, Sk)
    nokey = ~allowed.any(dim=1)
    tiles = _tile_pairs(allowed)
    any_pair = tiles.any(dim=(2, 3))
    full = (codes == F.VISIT) | (codes == F.NO_MASK)
    assert not (any_pair & ~full).any()
    for i in range(codes.shape[1]):
        if nokey[i * T:(i + 1) * T].any():
            assert (codes[:, i] != F.SKIP).all()
        else:
            assert (codes[:, i] != F.DV_ONLY).all()
    for j, i in (codes == F.NO_MASK).nonzero().tolist():
        rows = min(Sq, (i + 1) * T) - i * T
        assert j * T + T <= Sk
        assert tiles[j, i, :rows].all()
    assert not (any_pair & ((codes == F.DV_ONLY) | (codes == F.SKIP))).any()


def test_visited_q_tiles_at_the_training_shape():
    """Causal S=1024: k tile j visits q tiles j..15, 136 of 256 pairs, the
    diagonal with the mask and the rest without; the first 100 invalid key
    slots leave rows 0..99 without a key, so q tiles 0 and 1 are visited
    for dv by every k tile (DV_ONLY where no pair is allowed), and k tile 0
    (keys 0..63, all invalid) visits nothing else."""
    codes = F.visited_q_tiles(*_positions("causal S=1024"))
    assert int((codes > 0).sum()) == 136
    tril = torch.ones(16, 16, dtype=torch.bool).tril()
    assert torch.equal(codes > 0, tril.T)
    assert torch.equal(codes == F.VISIT, torch.eye(16, dtype=torch.bool))
    inv = F.visited_q_tiles(*_positions("first 100 key slots invalid"))
    assert inv[0].tolist() == [F.DV_ONLY] * 2 + [F.SKIP] * 14
    assert inv[1].tolist() == [F.DV_ONLY] + [F.VISIT] * 15
    assert inv[2, :3].tolist() == [F.DV_ONLY, F.DV_ONLY, F.VISIT]
    assert (inv[:, :2] != F.SKIP).all()


def _tiled_backward(q, k, v, do, q_pos, k_pos, causal, window, dq_visit,
                    dkv_codes, rows):
    """dq, dk and dv in float64 over the tiles the kernels visit: dq per
    group of ``rows`` queries over the k tiles ``dq_visit`` names, dk over
    the q tiles ``dkv_codes`` computes in full and dv over every visited
    one, with the reference's p = exp(s - lse) unmasked (NEG where
    masked) and dS = p (dP - Δ) masked to 0; o, lse and Δ from the
    float64 forward over all keys."""
    T, NEG = F.TILE, F.NEG
    Sq, Sk, d = q.shape[0], k.shape[0], q.shape[1]
    scale = d ** -0.5
    allowed = F._mask(q_pos, k_pos, causal, window).expand(Sq, Sk).numpy()
    s = np.where(allowed, q @ k.T * scale, NEG)
    m = s.max(axis=1, keepdims=True)
    lse = m + np.log(np.exp(s - m).sum(axis=1, keepdims=True))
    p = np.exp(s - lse)
    delta = (do * (p @ v)).sum(axis=1, keepdims=True)
    ds = np.where(allowed, p * (do @ v.T - delta), 0.0)
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    for i in range(dq_visit.shape[0]):
        r = slice(i * rows, (i + 1) * rows)
        for j in np.nonzero(dq_visit[i].numpy())[0]:
            c = slice(j * T, (j + 1) * T)
            dq[r] += ds[r, c] @ k[c] * scale
    for j in range(dkv_codes.shape[0]):
        c = slice(j * T, (j + 1) * T)
        for i in np.nonzero(dkv_codes[j].numpy())[0]:
            r = slice(i * T, (i + 1) * T)
            dv[c] += p[r, c].T @ do[r]
            if dkv_codes[j, i] != F.DV_ONLY:
                dk[c] += ds[r, c].T @ q[r] * scale
    return dq, dk, dv, lse[:, 0], delta[:, 0]


@pytest.mark.parametrize("rows", [16, 64])
@pytest.mark.parametrize("name", FLASH_NAMES[1:])
def test_skipping_tiles_changes_nothing_in_the_backward(name, rows):
    """dq, dk and dv over the visited tiles only equal those over every
    tile (float64, rtol/atol 1e-12: a skipped tile holds p = 0 and dS = 0,
    and a DV_ONLY tile dS = 0), and both equal the plain dq and dk/dv (f32,
    rtol/atol 1e-5, given the float64 run's lse and Δ), dq for groups of 16
    rows (the bf16 kernel's warps) and of 64 (the f32 kernel's blocks).
    "first 100 key slots invalid" has 100 rows with no key, over two q
    tiles."""
    q_pos, k_pos, causal, window = _positions(name)
    rng = np.random.default_rng(34)
    Sq, Sk, d = len(q_pos), len(k_pos), 16
    q, k, v, do = (rng.standard_normal((n, d)) for n in (Sq, Sk, Sk, Sq))
    args = (q, k, v, do, q_pos, k_pos, causal, window)
    dq_visit = F.visited_k_tiles(q_pos, k_pos, causal, window, rows)
    codes = F.visited_q_tiles(q_pos, k_pos, causal, window)
    *skip, lse, delta = _tiled_backward(*args, dq_visit, codes, rows)
    *every, _, _ = _tiled_backward(*args, torch.ones_like(dq_visit),
                                   torch.full_like(codes, F.VISIT), rows)
    for a, b in zip(skip, every):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    t = lambda a: torch.from_numpy(a).float()[None, None]  # noqa: E731
    bwd = (t(q), t(k), t(v), t(do), t(lse), t(delta), q_pos,
           k_pos, d ** -0.5, causal, window, None)
    dq_p = F.flash_dq_plain(*bwd)
    dk_p, dv_p = F.flash_dkv_plain(*bwd)
    for a, b in zip(skip, (dq_p, dk_p, dv_p)):
        np.testing.assert_allclose(a, b[0, 0].numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the grouped matmul's row-tile schedule
# ---------------------------------------------------------------------------

def _offsets(name):
    """(M, offsets (E+1,)) of a case."""
    if name == "skewed, expert 9 empty, tail 96":
        w = np.array([0.8 ** e for e in range(16)])
        w[9] = 0
        sizes = np.floor(w / w.sum() * (4096 - 96)).astype(int)
        return 4096, np.concatenate([[0], np.cumsum(sizes)])
    return {"decode M=8, 8 distinct experts":
            (8, [0, 1, 1, 2, 3, 3, 4, 5, 5, 6, 6, 7, 8, 8, 8, 8, 8]),
            "M=1": (1, [0, 0, 0, 1, 1]),
            "all rows in one expert": (4096, [0, 0, 0, 4096, 4096]),
            "M=1000 (off the tile), single-row segments":
            (1000, [0, 1, 2, 3, 500, 999, 1000]),
            "rows past offsets[E]": (300, [0, 100, 100, 250]),
            "every expert empty": (40, [0, 0, 0, 0])}[name]


GMM_NAMES = ["skewed, expert 9 empty, tail 96",
             "decode M=8, 8 distinct experts", "M=1", "all rows in one expert",
             "M=1000 (off the tile), single-row segments",
             "rows past offsets[E]", "every expert empty"]


@pytest.mark.parametrize("bm", [16, 64, 128])
@pytest.mark.parametrize("name", GMM_NAMES)
def test_tile_schedule_covers_every_row_once(name, bm):
    """Every row lies in exactly one tile; a tile holds at most bm rows of
    one segment; expert e's rows lie in e's tiles and the rows past
    offsets[E] in zero tiles; the tiles fit the kernels' fixed grid of
    ceil(M/bm) + E + 1 row slots."""
    M, offs = _offsets(name)
    E = len(offs) - 1
    tiles = G.tile_schedule(torch.tensor(offs, dtype=torch.int32), M, bm)
    assert len(tiles) <= math.ceil(M / bm) + E + 1
    owner = np.full(M, -2)
    for e, r0, r1 in tiles:
        assert 0 <= r0 < r1 <= min(M, r0 + bm)
        assert (owner[r0:r1] == -2).all()
        owner[r0:r1] = e
    want = np.full(M, -1)
    for e in range(E):
        want[offs[e]:offs[e + 1]] = e
    np.testing.assert_array_equal(owner, want)


@pytest.mark.parametrize("name", GMM_NAMES)
def test_tile_schedule_computes_the_grouped_matmul(name):
    """Products tile by tile over the schedule (zero tiles zero) give the
    plain grouped matmul, f32 at rtol/atol 1e-5 (another summation
    order)."""
    M, offs = _offsets(name)
    o = torch.tensor(offs, dtype=torch.int32)
    E = len(offs) - 1
    g = torch.Generator().manual_seed(33)
    lhs = torch.randn(M, 24, generator=g)
    rhs = torch.randn(E, 24, 40, generator=g)
    out = torch.full((M, 40), float("nan"))
    for e, r0, r1 in G.tile_schedule(o, M, G.block_m(M, torch.bfloat16)):
        out[r0:r1] = 0 if e < 0 else lhs[r0:r1] @ rhs[e]
    torch.testing.assert_close(out, G.grouped_matmul_plain(lhs, rhs, o),
                               rtol=1e-5, atol=1e-5)


def test_block_m_follows_m():
    """Decode-sized M takes the 16-row tile, prefill the 128-row one; f32
    keeps 64."""
    assert G.block_m(8, torch.bfloat16) == 16
    assert G.block_m(G.SMALL_M, torch.bfloat16) == 16
    assert G.block_m(4096, torch.bfloat16) == 128
    assert G.block_m(4096, torch.float32) == 64


# ---------------------------------------------------------------------------
# the scatter-add's plan: the inverse of idx as compressed rows
# ---------------------------------------------------------------------------

def _scatter_idx(name):
    """(idx (M,) int32, n)."""
    rng = np.random.default_rng(34)
    if name == "permutation":
        return rng.permutation(64).astype(np.int32), 64
    if name == "pairs (top_k=2)":
        idx = np.concatenate([rng.permutation(40), rng.permutation(40)])
        idx[rng.random(80) < 0.1] = -1
        return idx.astype(np.int32), 40
    if name == "triples (top_k=3)":
        idx = np.concatenate([rng.permutation(40) for _ in range(3)])
        idx[rng.random(120) < 0.1] = -1
        return idx.astype(np.int32), 40
    if name == "many duplicates":
        return rng.integers(-1, 5, 300).astype(np.int32), 5
    if name == "all -1":
        return np.full(50, -1, np.int32), 20
    if name == "indices at or past n, and below -1":
        return rng.integers(-7, 30, 200).astype(np.int32), 20
    raise KeyError(name)


SCATTER_NAMES = ["permutation", "pairs (top_k=2)", "triples (top_k=3)",
                 "many duplicates", "all -1",
                 "indices at or past n, and below -1"]


@pytest.mark.parametrize("name", SCATTER_NAMES)
def test_scatter_plan_is_the_inverse_of_idx(name):
    """starts is non-decreasing from 0; row r's list is exactly the i with
    idx[i] == r, ascending (a brute-force inverse); every valid i appears
    once and no i with idx < 0 or >= n appears."""
    idx, n = _scatter_idx(name)
    starts, rows = L.scatter_plan(torch.from_numpy(idx), n)
    assert starts.dtype == rows.dtype == torch.int32
    starts, rows = starts.numpy(), rows.numpy()
    assert starts.shape == (n + 1,) and starts[0] == 0
    assert (np.diff(starts) >= 0).all() and starts[n] == len(rows)
    for r in range(n):
        np.testing.assert_array_equal(rows[starts[r]:starts[r + 1]],
                                      np.flatnonzero(idx == r))
    valid = np.flatnonzero((idx >= 0) & (idx < n))
    np.testing.assert_array_equal(np.sort(rows), valid)
