#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit:

1. Setup: the card's name and power limit, TF32 off, the kernel build.
2. Each hand-written kernel against its plain PyTorch version on the card,
   at the main paths' shapes and at edge cases, with stated tolerances:
   the gate, the gather, the seed's row-per-step gather (2b', bitwise)
   and the grouped matmul (2a-2c: decode with 8 distinct experts, M=1,
   one expert holding every row, M off the tile, rows past offsets[E],
   skewed and empty segments), the grouped matmul's backward dlhs and
   drhs (2d, 2e; drhs's bf16 output bitwise its f32 output rounded), the
   scatter-add (2f: bitwise against the plain version on the CPU for any
   number of addends per row, top_k=3 included, and against its own
   reruns), and the flash forward, dq and
   dk/dv (2g-2i: the seq-1024 training shape, GQA with a window and a
   softcap, ragged S=600 with invalid key slots and a fully masked row,
   S=1, Sq != Sk, q positions offset against k, the first 100 key slots
   invalid).
3. Serving at full width: ``hetumoe-paper-16e`` (bf16, seeded random
   weights) through ``repro_torch.launch.serve.run`` → ``generate``, batch 8,
   32 new tokens: prompt 512 with ``grouped`` and with ``sort`` dispatch,
   and prompt 1024 (the flash forward) with ``grouped``; the kernels'
   launch counters must rise by what the path implies (the flash forward
   once per layer in a prefill past 512 tokens, never in a decode step).
4. Card against CPU at full width: the same f32 weights, batch 1, prompts
   of 64 and 600 tokens (the flash path), prefill last-token logits from
   the card (kernels) and the CPU (plain versions), both dispatch modes.
5. Per-kernel timings at the main paths' shapes (CUDA events, median of
   batches after warm-up; device-only from CUDA-graph replays, for the
   kernel and for the library call) beside the bound, the plain version
   and the nearest single PyTorch call (SDPA for the flash kernels); for
   the flash kernels the bound of their own arithmetic over the tiles they
   visit; the row-per-step gather beside the blocked one, with their
   ratio; an empty kernel's device time (the launch floor) beside the
   gate; the grouped drhs at M=4096 and 8192, uniform, skewed and (4096)
   one-expert segments, in both output dtypes, with its skewed/uniform
   ratio.
6. Where the time goes: a profiled prefill and decode steps per serving
   cell (wall time, kernel time, the device's idle share, top kernels),
   and the host's waits for the device in a forward, which must be none;
   then one profiled train step per training cell, with its host waits
   reported.
7. Training at full width: ``hetumoe-paper-16e`` through
   ``repro_torch.launch.train.run`` (f32 masters, bf16 compute, batch 8,
   seeded weights and data, 2 warm-up + 8 timed AdamW steps) at seq 512
   per dispatch mode and at seq 1024 (the paper's length) with
   ``grouped``; every metric finite, no step skipped, and every kernel's
   launch counter risen by exactly the per-step count times the steps
   (the flash kernels 2/2/2 per step at seq 1024, 0 at 512).
8. Card against CPU at full width, f32: one attention layer's output and
   gradients at seq 1024 (the flash path), then one train step's loss and
   gradients from the same weights, batch 1, seq 64 in both dispatch modes
   and seq 1024 with ``grouped`` (there replayed on the card with the
   CPU's ReLU masks, since a few pre-activations lie within rounding of 0).

The last lines are the card's name and power limit, one JSON object of
per-kernel numbers (all ten kernels; the row-per-step gather, on no
serving or training path, with the launches of its phase-5 run), and
``{"ok": true, "device": {...}}``.  ``--phases kernels`` runs phases 1, 2
and 5 only, for work on a kernel, and ends with ``"ok": false``.  The script
imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
ARCH = "hetumoe-paper-16e"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
BF16_FLOPS = 989e12                # dense tensor-core bf16
F32_FLOPS = 67e12                  # f32 outside the tensor cores
SERVE = dict(batch=8, prompt_len=512, gen=32)
Q_CHUNK = 512                      # longer sequences take the flash kernels
# (dispatch, prompt length) of the serving cells
SERVE_CELLS = (("grouped", 512), ("sort", 512), ("grouped", 1024))


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else (
        f"nvidia-smi failed: {out.stderr.strip()}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, *, batches: int = 25, per_batch: int = 10,
            warmup: int = 5) -> float:
    """Median over ``batches`` of the per-call time of ``per_batch``
    back-to-back calls between two CUDA events (host launch cost
    included, as the caller pays it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(per_batch):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / per_batch)
    return statistics.median(times)


def graph_ms(torch, fn, *, reps: int = 25, per_graph: int = 10,
             stream=None):
    """Device time per call from CUDA-graph replays (no host launch cost),
    or None when the call cannot be captured.  ``stream``: the stream to
    capture on (a backward runs on its forward's stream, so a backward is
    captured on the stream its forward ran on)."""
    try:
        side = stream or torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream):
            for _ in range(per_graph):
                fn()
    except RuntimeError as e:
        print(f"    (graph capture failed: {str(e).splitlines()[0]})")
        return None
    return time_ms(torch, g.replay, batches=reps, per_batch=1,
                   warmup=3) / per_graph


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def bf16_ulp(torch, v):
    """One bf16 ulp at the magnitude of each element of ``v`` (f32)."""
    a = v.abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


# Relative Frobenius distance ||drhs - plain|| / ||plain|| of the WMMA drhs
# kernel that the cp.async + mma.sync one replaced, per phase-2e case with
# bf16 inputs (the same shapes and offsets, drhs_ab.py's draws), from
# drhs_ab.py on an H100 80GB HBM3 at 700 W; phase 2e holds the kernel
# to at most 4x these.  (Its outputs and the new kernel's were bitwise
# equal in every case: both add each 16 rows' products into the
# accumulator by one tensor-core step, in row order.)
WMMA_DRHS_FRO = {
    "M=4096 K=N=2048 E=16 skewed, expert 9 empty, tail 96": 5.520e-07,
    "decode M=8 K=N=2048 E=16": 3.717e-09,
    "decode M=8, 8 distinct experts": 0.0,
    "M=1 K=N=2048": 0.0,
    "M=4096 all rows in one expert": 4.424e-06,
    "M=1000 K=N=256 (off the 128-row tile), single-row segments": 4.635e-07,
    "M=300 K=N=512, rows 250.. past offsets[E]": 1.451e-07,
    "ragged M=100 K=72 N=40 E=3 (partial tiles)": 6.938e-08,
    "M=50 K=20 N=12 E=2 (unvectorised loads)": 4.414e-08,
    "M=200 K=16 N=72 E=3, segment ends off the tiles, expert 1 empty":
    1.225e-07}


def skewed_offsets(torch, M: int, E: int, tail: int, empty: int):
    """Offsets with geometrically skewed segments, expert ``empty`` empty
    and ``tail`` rows past offsets[E]."""
    w = torch.tensor([0.8 ** e for e in range(E)], dtype=torch.float64)
    w[empty] = 0
    sizes = torch.floor(w / w.sum() * (M - tail)).to(torch.int64)
    offs = torch.zeros(E + 1, dtype=torch.int32)
    offs[1:] = torch.cumsum(sizes, 0).to(torch.int32)
    return offs


def grouped_cases(torch):
    """(name, M, K, N, E, offsets) of phases 2c-2e."""
    E = 16
    return [("M=4096 K=N=2048 E=16 skewed, expert 9 empty, tail 96",
            4096, 2048, 2048, E, skewed_offsets(torch, 4096, E, 96, 9)),
           ("decode M=8 K=N=2048 E=16", 8, 2048, 2048, E,
            torch.tensor([0, 1, 1, 3, 3, 3, 4, 4, 4, 4, 5, 6, 6, 6, 7, 7,
                          8], dtype=torch.int32)),
           ("decode M=8, 8 distinct experts", 8, 2048, 2048, E,
            torch.tensor([0, 1, 1, 2, 3, 3, 4, 5, 5, 6, 6, 7, 8, 8, 8, 8,
                          8], dtype=torch.int32)),
           ("M=1 K=N=2048", 1, 2048, 2048, E,
            torch.tensor([0] * 5 + [1] * 12, dtype=torch.int32)),
           ("M=4096 all rows in one expert", 4096, 2048, 2048, E,
            torch.tensor([0] * 4 + [4096] * 13, dtype=torch.int32)),
           ("M=1000 K=N=256 (off the 128-row tile), single-row segments",
            1000, 256, 256, 6,
            torch.tensor([0, 1, 2, 3, 500, 999, 1000], dtype=torch.int32)),
           ("M=300 K=N=512, rows 250.. past offsets[E]", 300, 512, 512, 3,
            torch.tensor([0, 100, 100, 250], dtype=torch.int32)),
           ("ragged M=100 K=72 N=40 E=3 (partial tiles)", 100, 72, 40, 3,
            torch.tensor([0, 30, 31, 90], dtype=torch.int32)),
           ("M=50 K=20 N=12 E=2 (unvectorised loads)", 50, 20, 12, 2,
            torch.tensor([0, 25, 45], dtype=torch.int32))]


def drhs_cases(torch):
    """Phase 2e's cases: 2c's and a segment ending off the tiles."""
    return grouped_cases(torch) + [
        ("M=200 K=16 N=72 E=3, segment ends off the tiles, expert 1 empty",
         200, 16, 72, 3, torch.tensor([0, 127, 127, 190], dtype=torch.int32))]


def phase_kernels(torch, dev):
    from repro_torch.kernels import grouped_ffn as G
    from repro_torch.kernels import layout_transform as L
    from repro_torch.kernels import topk_gate as K
    g = torch.Generator(device="cpu").manual_seed(1234)
    errs = {"topk_gate": 0.0, "gather_rows": 0.0, "grouped_matmul": 0.0}

    print("phase 2a: topk_gate (idx, vals, rowmax exact; sumexp rtol 1e-6)")
    ties = torch.randint(0, 3, (777, 16), generator=g).float()
    cases = [("S=4096 E=16 k=1", torch.randn(4096, 16, generator=g), 1),
             ("S=4096 E=16 k=2", torch.randn(4096, 16, generator=g), 2),
             ("S=1000 (not a multiple of 32) k=2",
              torch.randn(1000, 16, generator=g), 2),
             ("exact ties S=777 k=2", ties, 2),
             ("decode S=8 k=1", torch.randn(8, 16, generator=g), 1),
             ("E=40 (two columns per lane) k=3",
              torch.randn(300, 40, generator=g), 3)]
    for name, x, k in cases:
        xd = x.to(dev)
        kv, ki, km, ks = K.fused_topk_gate(xd, k)
        pv, pi, pm, ps = K.topk_gate_plain(xd, k)
        torch.cuda.synchronize()
        rel = ((ks - ps).abs() / ps.abs()).max().item()
        errs["topk_gate"] = max(errs["topk_gate"],
                                (kv - pv).abs().max().item(),
                                (ks - ps).abs().max().item())
        ok = (torch.equal(ki, pi) and torch.equal(kv, pv)
              and torch.equal(km, pm) and rel <= 1e-6)
        print(f"  {name}: idx/vals/rowmax equal={ok and True}, sumexp max "
              f"rel err {rel:.3e} (tol 1e-6)")
        check(ok, f"topk_gate {name} disagrees with its plain version")

    print("phase 2b: gather_rows (tolerance: bitwise)")
    gcases = []
    for dt in (torch.bfloat16, torch.float32):
        src = torch.randn(4096, 2048, generator=g).to(dt)
        idx = torch.randint(-1, 4096, (4096,), generator=g, dtype=torch.int32)
        idx[torch.rand(4096, generator=g) < 0.1] = -1
        gcases.append((f"M=N=4096 d=2048 {dt} with -1 rows", src, idx))
    src = torch.randn(4096, 2048, generator=g).to(torch.bfloat16)
    gcases.append(("decode M=8 bf16", src,
                   torch.tensor([5, -1, 4095, 0, 17, 17, -1, 3],
                                dtype=torch.int32)))
    gcases.append(("d=1001 bf16 (byte path)",
                   torch.randn(300, 1001, generator=g).to(torch.bfloat16),
                   torch.randint(-1, 300, (500,), generator=g,
                                 dtype=torch.int32)))
    gcases.append(("d=3 f32 (word path)", torch.randn(50, 3, generator=g),
                   torch.randint(-1, 50, (70,), generator=g,
                                 dtype=torch.int32)))
    for name, src, idx in gcases:
        s, i = src.to(dev), idx.to(dev)
        out = L.gather_rows(s, i)
        ref = L.gather_rows_plain(s, i)
        torch.cuda.synchronize()
        same = torch.equal(out, ref)
        err = (out.float() - ref.float()).abs().max().item()
        errs["gather_rows"] = max(errs["gather_rows"], err)
        print(f"  {name}: bitwise equal={same}, max abs err {err:.3e}")
        check(same, f"gather_rows {name} disagrees with its plain version")

    errs["gather_rows_rowstep"] = 0.0
    print("phase 2b': gather_rows_rowstep, the seed's row-per-step baseline "
          "(tolerance: bitwise)")
    rcases = []
    for dt in (torch.bfloat16, torch.float32):
        src = torch.randn(4096, 2048, generator=g).to(dt)
        idx = torch.randint(-1, 4096, (4096,), generator=g, dtype=torch.int32)
        idx[torch.rand(4096, generator=g) < 0.1] = -1
        rcases.append((f"M=N=4096 d=2048 {dt} with -1 rows", src, idx))
    src = torch.randn(4096, 2048, generator=g).to(torch.bfloat16)
    rcases += [("M=8 bf16", src, torch.tensor([5, -1, 4095, 0, 17, 17, -1, 3],
                                              dtype=torch.int32)),
               ("M=1 bf16", src, torch.tensor([4000], dtype=torch.int32)),
               ("all -1 bf16", src, torch.full((300,), -1,
                                               dtype=torch.int32)),
               ("d=100 bf16 (ragged: element loads)",
                torch.randn(300, 100, generator=g).to(torch.bfloat16),
                torch.randint(-1, 300, (500,), generator=g,
                              dtype=torch.int32))]
    for name, src, idx in rcases:
        s, i = src.to(dev), idx.to(dev)
        out = L.gather_rows_rowstep(s, i)
        ref = L.gather_rows_rowstep_plain(s, i)
        torch.cuda.synchronize()
        same = torch.equal(out, ref)
        err = (out.float() - ref.float()).abs().max().item()
        errs["gather_rows_rowstep"] = max(errs["gather_rows_rowstep"], err)
        print(f"  {name}: bitwise equal={same}, max abs err {err:.3e}")
        check(same, f"gather_rows_rowstep {name} disagrees with its plain "
                    f"version")
    del rcases, src, s, out, ref

    print("phase 2c: grouped_matmul (f32 rtol/atol 1e-4; bf16 within 1 ulp "
          "of the f32-accumulated plain result rounded once, plus the f32 "
          "summation-order bound)")
    mcases = grouped_cases(torch)
    for name, M, Kd, N, E_, offs in mcases:
        lhs32 = torch.randn(M, Kd, generator=g)
        rhs32 = torch.randn(E_, Kd, N, generator=g) * Kd ** -0.5
        o = offs.to(dev)
        for dt in (torch.float32, torch.bfloat16):
            lhs, rhs = lhs32.to(dt).to(dev), rhs32.to(dt).to(dev)
            out = G.grouped_matmul(lhs, rhs, o)
            ref = G.grouped_matmul_plain(lhs, rhs, o)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            errs["grouped_matmul"] = max(errs["grouped_matmul"],
                                         err.max().item())
            if dt == torch.float32:
                ok = bool(torch.allclose(out, ref, rtol=1e-4, atol=1e-4))
                tol = "rtol/atol 1e-4"
            else:
                # 1 ulp of the plain result, plus the f32 summation-order
                # bound K·2^-24·Σ|a·b| (the two sums add in other orders;
                # it only matters where the products cancel to near 0)
                order = Kd * 2.0 ** -24 * G.grouped_matmul_plain(
                    lhs.float().abs(), rhs.float().abs(), o)
                ulp = bf16_ulp(torch, ref.float())
                ok = bool((err <= ulp + order).all())
                tol = (f"{(err / ulp).max().item():.2f} ulp max, "
                       f"{int((err > ulp).sum())} elements past 1 ulp, all "
                       f"within 1 ulp + the f32 order bound: {ok}")
            tail = out[int(offs[-1]):]
            ok = ok and bool((tail == 0).all())
            print(f"  {name} {dt}: max abs err {err.max().item():.3e} "
                  f"({tol}), tail rows zero={bool((tail == 0).all())}")
            check(ok, f"grouped_matmul {name} {dt} disagrees with its plain "
                      f"version")

    errs.update(grouped_matmul_t=0.0, grouped_drhs=0.0, scatter_add_rows=0.0)
    print("phase 2d: grouped_matmul_t, dlhs = g @ w[e]^T (f32 rtol/atol 1e-4; "
          "bf16 within 1 ulp of the f32-accumulated plain result rounded "
          "once, plus the f32 summation-order bound)")
    for name, M, Kd, N, E_, offs in mcases:
        g32 = torch.randn(M, N, generator=g)
        rhs32 = torch.randn(E_, Kd, N, generator=g) * N ** -0.5
        o = offs.to(dev)
        for dt in (torch.float32, torch.bfloat16):
            gd, rhs = g32.to(dt).to(dev), rhs32.to(dt).to(dev)
            out = G.grouped_matmul_t(gd, rhs, o)
            ref = G.grouped_matmul_t_plain(gd, rhs, o)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            errs["grouped_matmul_t"] = max(errs["grouped_matmul_t"],
                                           err.max().item())
            if dt == torch.float32:
                ok = bool(torch.allclose(out, ref, rtol=1e-4, atol=1e-4))
                tol = "rtol/atol 1e-4"
            else:
                order = N * 2.0 ** -24 * G.grouped_matmul_t_plain(
                    gd.float().abs(), rhs.float().abs(), o)
                ulp = bf16_ulp(torch, ref.float())
                ok = bool((err <= ulp + order).all())
                tol = (f"{(err / ulp).max().item():.2f} ulp max, within 1 "
                       f"ulp + the f32 order bound: {ok}")
            tail = out[int(offs[-1]):]
            ok = ok and bool((tail == 0).all())
            print(f"  {name} {dt}: max abs err {err.max().item():.3e} "
                  f"({tol}), tail rows zero={bool((tail == 0).all())}")
            check(ok, f"grouped_matmul_t {name} {dt} disagrees with its "
                      f"plain version")

    print("phase 2e: grouped_drhs, drhs[e] = lhs[seg_e]^T @ g[seg_e] in f32 "
          "(f32 FMA variant: rtol 1e-4 plus the f32 summation-order bound "
          "M*2^-24*sum|a*b|; bf16 inputs: within that order bound, and the "
          "bf16-out form bitwise the f32 form rounded to bf16; empty "
          "experts exactly 0; relative Frobenius distance from the plain "
          "version beside the WMMA kernel this one replaced, at most 4x it)")
    for name, M, Kd, N, E_, offs in drhs_cases(torch):
        lhs32 = torch.randn(M, Kd, generator=g)
        g32 = torch.randn(M, N, generator=g)
        o = offs.to(dev)
        empty = [e for e in range(E_) if offs[e + 1] <= offs[e]]
        for dt in (torch.float32, torch.bfloat16):
            lhs, gd = lhs32.to(dt).to(dev), g32.to(dt).to(dev)
            out = G.grouped_drhs(lhs, gd, o)
            ref = G.grouped_drhs_plain(lhs, gd, o)
            torch.cuda.synchronize()
            err = (out - ref).abs()
            errs["grouped_drhs"] = max(errs["grouped_drhs"], err.max().item())
            order = M * 2.0 ** -24 * G.grouped_drhs_plain(
                lhs.float().abs(), gd.float().abs(), o)
            bound = order + (1e-4 * ref.abs() if dt == torch.float32 else 0)
            ok = bool((err <= bound + 1e-7).all())
            zero = all(bool((out[e] == 0).all()) for e in empty)
            extra = ""
            if dt == torch.bfloat16:
                out16 = G.grouped_drhs(lhs, gd, o, out_dtype=torch.bfloat16)
                rounded = torch.equal(out16, out.to(torch.bfloat16))
                fro = (err.norm() / ref.norm().clamp(min=1e-30)).item()
                was = WMMA_DRHS_FRO.get(name)
                near = was is None or fro <= 4 * max(was, 1e-12)
                ok = ok and rounded and near
                extra = (f"; bf16 out == f32 out rounded: {rounded}; "
                         f"Frobenius {fro:.3e} (WMMA kernel "
                         f"{'not recorded' if was is None else f'{was:.3e}'})")
                del out16
            print(f"  {name} {dt}: max abs err {err.max().item():.3e} "
                  f"(max err/bound {(err / (bound + 1e-7)).max().item():.3f}),"
                  f" empty experts {empty} zero={zero}{extra}")
            check(ok and zero, f"grouped_drhs {name} {dt} disagrees with its "
                               f"plain version")
        del out, ref, order, bound

    print("phase 2f: scatter_add_rows (bitwise against the plain version "
          "computed on the CPU, for any number c of addends per row; the "
          "kernel's output bitwise equal over 3 reruns)")
    d = 2048
    perm = torch.randperm(4096, generator=g).to(torch.int32)
    inv = torch.full((5120,), -1, dtype=torch.int32)
    inv[torch.randperm(5120, generator=g)[:4096]] = perm
    slot = torch.randperm(5120, generator=g)[:4096].to(torch.int32)
    slot[torch.rand(4096, generator=g) < 0.05] = -1
    pair = torch.cat([torch.randperm(4096, generator=g),
                      torch.randperm(4096, generator=g)]).to(torch.int32)
    pair[torch.rand(8192, generator=g) < 0.1] = -1
    triple = torch.cat([torch.randperm(4096, generator=g)
                        for _ in range(3)]).to(torch.int32)
    triple[torch.rand(12288, generator=g) < 0.05] = -1
    scases = [("grouped dispatch VJP (4096 -> 4096, a permutation)", 4096,
               perm, 4096),
              ("sort dispatch VJP (5120 -> 4096, -1 for empty slots)", 5120,
               inv, 4096),
              ("sort combine VJP (4096 -> 5120, -1 for dropped)", 4096, slot,
               5120),
              ("top_k=2 pairs (8192 -> 4096)", 8192, pair, 4096),
              ("top_k=3 triples (12288 -> 4096)", 12288, triple, 4096),
              ("many duplicates (4096 -> 50)", 4096,
               torch.randint(-1, 50, (4096,), generator=g, dtype=torch.int32),
               50),
              ("indices past n and n > the plan's shared memory (3000 -> "
               "20000)", 3000,
               torch.randint(-5, 20100, (3000,), generator=g,
                             dtype=torch.int32), 20000),
              ("d=1001 (odd width) pairs", 600,
               torch.cat([torch.randperm(300, generator=g)] * 2).to(
                   torch.int32), 300)]
    for name, M, idx, n in scases:
        width = 1001 if "1001" in name else d
        g32 = torch.randn(M, width, generator=g)
        i = idx.to(dev)
        valid = idx[(idx >= 0) & (idx < n)]
        c = int(torch.bincount(valid.long(), minlength=n).max()) if len(
            valid) else 0
        for dt in (torch.bfloat16, torch.float32):
            gd = g32.to(dt)
            ref = L.scatter_add_rows_plain(gd, idx, n)      # on the CPU
            gd = gd.to(dev)
            out = L.scatter_add_rows(gd, i, n)
            reruns = [L.scatter_add_rows(gd, i, n) for _ in range(3)]
            torch.cuda.synchronize()
            out_cpu = out.cpu()
            err = (out_cpu.float() - ref.float()).abs()
            errs["scatter_add_rows"] = max(errs["scatter_add_rows"],
                                           err.max().item())
            same = torch.equal(out_cpu, ref)
            stable = all(torch.equal(r, out) for r in reruns)
            print(f"  {name} {dt}: c={c}, max abs err {err.max().item():.3e}"
                  f", bitwise equal to the CPU's plain version: {same}, to "
                  f"its own 3 reruns: {stable}")
            check(same and stable, f"scatter_add_rows {name} {dt} disagrees "
                                   f"with its plain version or its reruns")
        del reruns, out
    return errs


# (name, B, H, KV, Sq, Sk, d, causal, window, cap, share of k_pos set to -1,
#  first q position, leading k slots set to -1)
FLASH_CASES = [
    ("main B=8 H=KV=16 S=1024 d=128 causal", 8, 16, 16, 1024, 1024, 128,
     True, None, None, 0.0, 0, 0),
    ("GQA G=2, window 100, softcap 30 (B=2 H=8 KV=4 S=256 d=64)", 2, 8, 4,
     256, 256, 64, True, 100, 30.0, 0.0, 0, 0),
    ("S=600 (ragged), k_pos -1 slots, row 0 fully masked (d=128)", 1, 4, 2,
     600, 600, 128, True, None, None, 0.1, 0, 0),
    ("S=1 (d=32)", 2, 4, 2, 1, 1, 32, True, None, None, 0.0, 0, 0),
    ("Sq=100 Sk=200 non-causal d=16, k_pos -1 slots", 1, 2, 1, 100, 200, 16,
     False, None, None, 0.2, 0, 0),
    ("q offset: q_pos 512..1023 against 1024 keys (B=2 H=KV=4 d=128)", 2, 4,
     4, 512, 1024, 128, True, None, None, 0.0, 512, 0),
    ("first 100 key slots invalid (B=2 H=KV=4 S=1024 d=128)", 2, 4, 4, 1024,
     1024, 128, True, None, None, 0.0, 0, 100),
]


def flash_order_bounds(torch, F, q, k, v, do, lse, delta, q_pos, k_pos, st):
    """Per-element bounds of o, dq, dk and dv between the bf16 kernels and
    their plain versions on the same inputs (the same o, lse and delta for
    the backward).  First the f32 summation order: a score adds d products
    in another order (|ds| <= d*2^-24*SA, SA = scale*|q|.|k|), which moves
    p by that much relatively; dP likewise (d*2^-24*A, A = |dO|.|v|), so dS
    moves by p*(A + D)*d*2^-24*(1 + SA) with |dS| <= p*(A + D), D =
    sum|dO*o|; then the sums over Sk keys (o, dq) or G*Sq queries (dk, dv)
    add their own length times 2^-24 of the sum of |terms|.  Twice the
    first-order terms:
      o   2*(Sk + 2d*max_k SA)*2^-24 * (p@|v|)/l
      dq  2*2^-24*scale * (p*(A + D)*(d*(1 + SA) + Sk)) @ |k|
      dk  2*2^-24*scale * sum_g (p*(A + D)*(d*(1 + SA) + G*Sq))^T @ |q|
      dv  2*2^-24 * sum_g (p*(G*Sq + d*SA))^T @ |dO|
    Then the split x = hi + lo of the f32 factor of each tensor-core
    product (hi = bf16(x), lo = bf16(x - hi)), which leaves out at most
    2^-16*|x| of each x: P v in the forward, dS k in dq, dS^T q and P^T dO
    in dk/dv:
      o   2^-16 * (p@|v|)/l
      dq  2^-16*scale * |dS| @ |k|
      dk  2^-16*scale * sum_g |dS|^T @ |q|
      dv  2^-16 * sum_g p^T @ |dO|"""
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G, scale, u, r = H // KV, st[0], 2.0 ** -24, 2.0 ** -16
    gq, gdo = F._grouped(q, KV), F._grouped(do, KV)
    ak = k.float().abs()
    s, _, _ = F._scores(q, k, q_pos, k_pos, *st)
    sa = torch.einsum("bkgqd,bksd->bkgqs", gq.abs(), ak) * scale
    p = torch.exp(s - lse.reshape(B, KV, G, Sq)[..., None])
    del s
    pv = torch.einsum("bkgqs,bksd->bkgqd", p, v.float().abs())
    o_b = ((2 * (Sk + 2 * d * sa.amax(-1, keepdim=True)) * u + r) * pv
           ).reshape(q.shape)
    del pv
    o_plain, _ = F.flash_fwd_plain(q, k, v, q_pos, k_pos, *st)
    a = torch.einsum("bkgqd,bksd->bkgqs", gdo.abs(), v.float().abs())
    dsum = (gdo.abs() * F._grouped(o_plain, KV).abs()).sum(-1)[..., None]
    w = p * (a + dsum)
    wd = d * (1 + sa)
    del a
    ads = F._probs_and_ds(q, k, v, do, lse, delta, q_pos, k_pos, *st)[1].abs()
    dq_b = scale * torch.einsum("bkgqs,bksd->bkgqd",
                                2 * u * w * (wd + Sk) + r * ads, ak
                                ).reshape(q.shape)
    dk_b = scale * torch.einsum("bkgqs,bkgqd->bksd",
                                2 * u * w * (wd + G * Sq) + r * ads, gq.abs())
    del w, wd, ads
    dv_b = torch.einsum("bkgqs,bkgqd->bksd",
                        p * (2 * u * (G * Sq + d * sa) + r), gdo.abs())
    return o_b, dq_b, dk_b, dv_b


def flash_bf16p_plain(torch, F, q, k, v, do, lse, delta, q_pos, k_pos, st):
    """o, dq, dk, dv of the plain versions with p and dS rounded to bf16
    before their products (the chunked ``_attend``'s rounding of p): what
    a kernel computes that rounds them.  The bf16 kernels must stay
    measurably nearer the f32-p plain versions than this."""
    KV, scale = k.shape[1], st[0]

    def r(t):
        return t.to(torch.bfloat16).float()
    s, _, _ = F._scores(q, k, q_pos, k_pos, *st)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bkgqs,bksd->bkgqd", r(p), v.float()) / p.sum(
        -1, keepdim=True)
    del s, p
    p, ds = F._probs_and_ds(q, k, v, do, lse, delta, q_pos, k_pos, *st)
    dq = torch.einsum("bkgqs,bksd->bkgqd", r(ds), k.float()) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", r(ds), F._grouped(q, KV)) * scale
    dv = torch.einsum("bkgqs,bkgqd->bksd", r(p), F._grouped(do, KV))
    return (o.reshape(q.shape).to(q.dtype), dq.reshape(q.shape).to(q.dtype),
            dk.to(k.dtype), dv.to(v.dtype))


def phase_flash_kernels(torch, dev):
    """Phases 2g-2i: the flash forward, dq and dk/dv kernels against their
    plain versions on the card, on the same inputs."""
    from repro_torch.kernels import flash_attention as F
    g = torch.Generator(device="cpu").manual_seed(4321)
    errs = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    print("phase 2g-2i: flash forward (o, lse), dq, dk/dv against their plain "
          "versions on the same inputs (the backward's o, lse and delta "
          "from the plain forward). f32: rtol/atol 1e-4; bf16: within 1 ulp "
          "of the plain result plus the f32 summation-order bound and what "
          "the split x = hi + lo of p and dS leaves out (flash_order_bounds:"
          " 2^-16*(p@|v|)/l for o, 2^-16*scale*|dS|@|k| for dq, "
          "2^-16*scale*|dS|^T@|q| for dk, 2^-16*p^T@|dO| for dv), and where "
          "Sk > 1 a Frobenius distance "
          "from the plain result at most 1/4 of that of the plain versions "
          "with p and dS rounded to bf16 (flash_bf16p_plain); lse (f32 in "
          "both) rtol/atol 1e-4")
    for (name, B, H, KV, Sq, Sk, d, causal, window, cap, invalid, q_first,
         dead) in FLASH_CASES:
        shapes = ((B, H, Sq, d), (B, KV, Sk, d), (B, KV, Sk, d), (B, H, Sq, d))
        x32 = [torch.randn(s, generator=g) for s in shapes]
        q_pos = torch.arange(q_first, q_first + Sq, dtype=torch.int32)
        k_pos = torch.arange(Sk, dtype=torch.int32)
        k_pos[:dead] = -1
        if invalid:
            k_pos[0] = -1
            k_pos[torch.rand(Sk, generator=g) < invalid] = -1
        qp, kp = q_pos.to(dev), k_pos.to(dev)
        st = (d ** -0.5, causal, window, cap)
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do = (t.to(dt).to(dev) for t in x32)
            o_k, lse_k = F.flash_fwd(q, k, v, qp, kp, *st)
            o_p, lse_p = F.flash_fwd_plain(q, k, v, qp, kp, *st)
            delta = (do.float() * o_p.float()).sum(-1)
            bwd = (q, k, v, do, lse_p, delta, qp, kp, *st)
            dq_k = F.flash_dq(*bwd)
            dk_k, dv_k = F.flash_dkv(*bwd)
            dq_p = F.flash_dq_plain(*bwd)
            dk_p, dv_p = F.flash_dkv_plain(*bwd)
            torch.cuda.synchronize()
            bf16 = dt == torch.bfloat16
            bounds = (flash_order_bounds(torch, F, q, k, v, do, lse_p, delta,
                                         qp, kp, st) if bf16 else (None,) * 4)
            rounded = (flash_bf16p_plain(torch, F, q, k, v, do, lse_p, delta,
                                         qp, kp, st) if bf16 and Sk > 1
                       else (None,) * 4)
            lse_ok = bool(torch.allclose(lse_k, lse_p, rtol=1e-4, atol=1e-4))
            results = []
            for what, key, out, ref, bound, rnd in (
                    ("o", "flash_fwd", o_k, o_p, bounds[0], rounded[0]),
                    ("dq", "flash_dq", dq_k, dq_p, bounds[1], rounded[1]),
                    ("dk", "flash_dkv", dk_k, dk_p, bounds[2], rounded[2]),
                    ("dv", "flash_dkv", dv_k, dv_p, bounds[3], rounded[3])):
                err = (out.float() - ref.float()).abs()
                errs[key] = max(errs[key], err.max().item())
                if dt == torch.float32:
                    ok = bool(torch.allclose(out, ref, rtol=1e-4, atol=1e-4))
                    note = ""
                else:
                    ulp = bf16_ulp(torch, ref.float())
                    ok = bool((err <= ulp + bound).all())
                    note = (f", {(err / ulp).max().item():.2f} ulp max, "
                            f"{int((err > ulp).sum())} past 1 ulp, max "
                            f"err/(ulp + bound) "
                            f"{(err / (ulp + bound)).max().item():.3f}")
                    if rnd is not None:
                        far = (rnd.float() - ref.float()).norm().item()
                        near = err.norm().item()
                        ok = ok and near <= far / 4
                        note += (f", |kernel - plain|_F {near:.3e} vs "
                                 f"|bf16-p plain - plain|_F {far:.3e}")
                results.append(ok)
                print(f"  {name} {dt} {what}: max abs err "
                      f"{err.max().item():.3e}{note}: {ok}")
            print(f"  {name} {dt} lse: max abs err "
                  f"{(lse_k - lse_p).abs().max().item():.3e}: {lse_ok}")
            check(all(results) and lse_ok,
                  f"flash kernels {name} {dt} disagree with their plain "
                  f"versions")
            del q, k, v, do, o_k, o_p, dq_k, dk_k, dv_k, dq_p, dk_p, dv_p
            del bounds, rounded, bwd
        torch.cuda.empty_cache()
    return errs


# ---------------------------------------------------------------------------
# phase 3: serving at full width
# ---------------------------------------------------------------------------

COUNTERS = (("topk_gate", "topk_gate", "launches"),
            ("gather_rows", "layout_transform", "launches"),
            ("grouped_matmul", "grouped_ffn", "launches"),
            ("grouped_matmul_t", "grouped_ffn", "dlhs_launches"),
            ("grouped_drhs", "grouped_ffn", "drhs_launches"),
            ("scatter_add_rows", "layout_transform", "scatter_launches"),
            ("flash_fwd", "flash_attention", "fwd_launches"),
            ("flash_dq", "flash_attention", "dq_launches"),
            ("flash_dkv", "flash_attention", "dkv_launches"))
SERVE_KERNELS = ("topk_gate", "gather_rows", "grouped_matmul", "flash_fwd")


def _kernel_module(name):
    import importlib
    return importlib.import_module(f"repro_torch.kernels.{name}")


def reset_counts():
    for _, mod, attr in COUNTERS:
        setattr(_kernel_module(mod), attr, 0)


def read_counts(names=None):
    """Launch counters of the kernels ``names`` (default: the four the
    serving path runs)."""
    names = names or SERVE_KERNELS
    return {k: getattr(_kernel_module(mod), attr)
            for k, mod, attr in COUNTERS if k in names}


def phase_serve(torch, smi):
    """Serving at batch 8 and 32 new tokens: prompt 512 in both dispatch
    modes (the chunk-free ``_attend`` path, no flash launch) and prompt
    1024 grouped (the flash forward, 2 launches in the prefill, none in a
    decode step)."""
    from repro_torch import configs
    from repro_torch.launch import serve
    cfg = configs.get_config(ARCH)
    L = cfg.num_layers
    forwards = SERVE["gen"]                  # 1 prefill + gen-1 decode steps
    print("phase 3: warm-up (grouped, 2 new tokens)")
    serve.run(ARCH, smoke=False, batch=SERVE["batch"],
              prompt_len=SERVE["prompt_len"], gen=2, dispatch="grouped",
              device="cuda")
    totals = dict.fromkeys(SERVE_KERNELS, 0)
    results = {}
    for mode, prompt_len in SERVE_CELLS:
        expect = {"topk_gate": L * forwards,
                  "gather_rows": (1 if mode == "grouped" else 2) * L * forwards,
                  "grouped_matmul": (2 * L * forwards if mode == "grouped"
                                     else 0),
                  "flash_fwd": L if prompt_len > Q_CHUNK else 0}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        reset_counts()
        out = serve.run(ARCH, smoke=False, dispatch=mode, device="cuda",
                        stats=stats, batch=SERVE["batch"],
                        prompt_len=prompt_len, gen=SERVE["gen"])
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        for k, v in counts.items():
            totals[k] += v
        B, gen = SERVE["batch"], SERVE["gen"]
        decode_ms = 1e3 * stats["decode_s"] / stats["decode_steps"]
        tok_s = B * gen / (stats["prefill_s"] + stats["decode_s"])
        cell = f"{mode} prompt {prompt_len}"
        print(f"  [{smi}] {cell}: prefill {1e3 * stats['prefill_s']:.3f} ms, "
              f"decode {decode_ms:.3f} ms/step, {tok_s:.1f} tokens/s "
              f"(batch {B} x {gen} new), peak memory "
              f"{peak / 2 ** 30:.3f} GiB, launches {counts}")
        check(counts == expect,
              f"{cell}: launch counts {counts} != expected {expect}")
        check(tuple(out.shape) == (B, prompt_len + gen),
              f"{cell}: output shape {tuple(out.shape)}")
        new = out[:, prompt_len:]
        check(bool(((new >= 0) & (new < cfg.vocab_size)).all()),
              f"{cell}: generated ids out of range")
        check(stats["logits_finite"], f"{cell}: non-finite logits")
        results[cell] = dict(prefill_ms=1e3 * stats["prefill_s"],
                             decode_ms_per_step=decode_ms, tokens_per_s=tok_s,
                             peak_gib=peak / 2 ** 30)
    return totals, results


# ---------------------------------------------------------------------------
# phase 4: card against CPU at full width, f32
# ---------------------------------------------------------------------------

def phase_card_vs_cpu(torch):
    from repro_torch import configs
    from repro_torch.models.transformer import Transformer, init_params
    from repro_torch.serving.engine import serve_config
    cfg = configs.get_config(ARCH).replace(dtype="float32")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    cpu = Transformer(cfg, device="cpu", params=params)
    gpu = Transformer(cfg, device="cuda", params=params)
    print(f"phase 4: f32 weights on both devices in "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(8)
    for S, mode in ((64, "grouped"), (64, "sort"), (600, "grouped"),
                    (600, "sort")):
        prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=gen)
        c = serve_config(cfg, dispatch=mode)
        with torch.inference_mode():
            logits = []
            for model in (cpu, gpu):
                reset_counts()
                h, _, _ = model.forward(prompt.to(model.device), cfg=c)
                logits.append(model.logits_from_hidden(h[:, -1:]).cpu())
        # the card's forward went through the kernels (2 layers), and
        # through the flash forward past q_chunk
        want = {"topk_gate": 2, "gather_rows": 2 if mode == "grouped" else 4,
                "grouped_matmul": 4 if mode == "grouped" else 0,
                "flash_fwd": 2 if S > Q_CHUNK else 0}
        check(read_counts() == want,
              f"{mode}: card forward launches {read_counts()} != {want}")
        diff = (logits[0] - logits[1]).abs().max().item()
        scale = logits[0].abs().max().item()
        print(f"  {mode} prompt {S}: max |card - cpu| = {diff:.3e}, tol "
              f"1e-3 * max|logit| = {1e-3 * scale:.3e}")
        check(math.isfinite(diff) and diff <= 1e-3 * scale,
              f"{mode} prompt {S}: card and CPU logits disagree")
    del cpu, gpu, params


# ---------------------------------------------------------------------------
# phase 5: per-kernel timings
# ---------------------------------------------------------------------------

def phase_timings(torch, dev, smi):
    from repro_torch.kernels import grouped_ffn as G
    from repro_torch.kernels import layout_transform as L
    from repro_torch.kernels import build
    from repro_torch.kernels import topk_gate as K
    g = torch.Generator(device="cpu").manual_seed(99)
    T, E, d = SERVE["batch"] * SERVE["prompt_len"], 16, 2048
    rows = []

    def bound(nbytes, flops, peak):
        tb, tf = nbytes / HBM_BYTES_PER_S, flops / peak
        return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")

    def row(name, source, replaces, kernel, plain, library, nbytes, flops,
            peak, shape, slow=False, library_graph=None, **extra):
        # a call of several ms: fewer batches of fewer calls
        kw = dict(batches=10, per_batch=3, warmup=2) if slow else {}
        gkw = dict(reps=10, per_graph=3) if slow else {}
        ms = time_ms(torch, kernel, **kw)
        dev_ms = graph_ms(torch, kernel, **gkw)
        plain_ms = time_ms(torch, plain, **kw)
        lib_ms = lib_dev_ms = None
        if library is not None:
            try:
                lib_ms = time_ms(torch, library, **kw)
            except RuntimeError as e:
                print(f"    library call does not run on this build: "
                      f"{str(e).splitlines()[0]}")
            else:
                # (callable, capture stream) for the device-only time
                fn, stream = library_graph or (library, None)
                lib_dev_ms = graph_ms(torch, fn, stream=stream, **gkw)
        bound_ms, by = bound(nbytes, flops, peak)

        def fmt(x):
            return "not measured" if x is None else f"{x:.4f}"
        print(f"  [{smi}] {name} {shape}: kernel_ms {ms:.4f} (device-only "
              f"{fmt(dev_ms)}), plain_ms {plain_ms:.4f}, library_ms "
              f"{fmt(lib_ms)} (device-only {fmt(lib_dev_ms)}), bound_us "
              f"{1e3 * bound_ms:.2f} ({by}) {extra or ''}")
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=by, library_ms=lib_ms,
                         device_ms=dev_ms, library_device_ms=lib_dev_ms,
                         shape=shape, **extra))

    print("phase 5: timings (CUDA events; median of 25 batches of 10 calls "
          "after warm-up; device-only: CUDA-graph replays, for the kernel "
          "and for the library call, 'not measured' where a call cannot be "
          "captured)")
    # gate at prefill: logits (T, E) f32, k=1
    for S in (T, SERVE["batch"]):
        x = torch.randn(S, E, generator=g).to(dev)
        nbytes = S * E * 4 + S * (4 + 4 + 4 + 4)
        row("topk_gate", "src/repro_torch/csrc/topk_gate.cu",
            "src/repro/kernels/topk_gate.py:24",
            lambda: K.fused_topk_gate(x, 1), lambda: K.topk_gate_plain(x, 1),
            lambda: torch.topk(x, 1, dim=-1), nbytes, 4 * S * E, F32_FLOPS,
            f"S={S} E={E} k=1")
    # the launch floor beside the gate: an empty kernel's device time
    lib = build.load()

    def empty():
        build.check(lib.launch_empty(build.stream(x)), "launch_empty")
    floor_ms = graph_ms(torch, empty)
    rows[0]["launch_floor_device_ms"] = floor_ms
    print(f"  [{smi}] launch floor (an empty kernel, device-only): "
          f"{'not measured' if floor_ms is None else f'{floor_ms:.4f}'} ms")
    # gather: the grouped dispatch's token map (a permutation) over (T, d)
    for M in (T, SERVE["batch"]):
        src = torch.randn(M, d, generator=g).to(torch.bfloat16).to(dev)
        idx = torch.randperm(M, generator=g).to(torch.int32).to(dev)
        nbytes = M * d * 2 + M * 4 + M * d * 2
        row("gather_rows", "src/repro_torch/csrc/layout_transform.cu",
            "src/repro/kernels/layout_transform.py:42",
            lambda: L.gather_rows(src, idx),
            lambda: L.gather_rows_plain(src, idx),
            lambda: torch.index_select(src, 0, idx.clamp(min=0)), nbytes, 0,
            BF16_FLOPS, f"M=N={M} d={d} bf16")
    # kernel 10, the seed's row-per-step gather, at kernel 2's main shape
    # beside it: its own entry point is its path (bench_layout's baseline),
    # so its launches are counted over this timing run
    src = torch.randn(T, d, generator=g).to(torch.bfloat16).to(dev)
    idx = torch.randperm(T, generator=g).to(torch.int32).to(dev)
    blocked = next(r for r in rows if r["name"] == "gather_rows")
    L.rowstep_launches = 0
    row("gather_rows_rowstep", "src/repro_torch/csrc/layout_transform.cu",
        "src/repro/kernels/layout_transform.py:150",
        lambda: L.gather_rows_rowstep(src, idx),
        lambda: L.gather_rows_rowstep_plain(src, idx),
        lambda: torch.index_select(src, 0, idx.clamp(min=0)),
        T * d * 2 + T * 4 + T * d * 2, 0, BF16_FLOPS, f"M=N={T} d={d} bf16")
    rows[-1]["launches"] = L.rowstep_launches
    rows[-1]["rowstep_over_blocked"] = rows[-1]["ms"] / blocked["ms"]
    rows[-1]["rowstep_over_blocked_device"] = (
        None if None in (rows[-1]["device_ms"], blocked["device_ms"])
        else rows[-1]["device_ms"] / blocked["device_ms"])
    print(f"    rowstep / blocked gather (bench_layout's speedup_vs_rowstep "
          f"on the card): {rows[-1]['rowstep_over_blocked']:.3f} eager, "
          f"{rows[-1]['rowstep_over_blocked_device']} device-only; "
          f"{L.rowstep_launches} launches of the rowstep kernel")
    # grouped matmul: routed segments of a uniform random assignment
    for M in (T, SERVE["batch"]):
        assign = torch.randint(0, E, (M,), generator=g)
        counts = torch.bincount(assign, minlength=E)
        offs = torch.zeros(E + 1, dtype=torch.int32)
        offs[1:] = torch.cumsum(counts, 0)
        lhs = torch.randn(M, d, generator=g).to(torch.bfloat16).to(dev)
        rhs = (torch.randn(E, d, d, generator=g) * d ** -0.5).to(
            torch.bfloat16).to(dev)
        o = offs.to(dev)
        active = int((counts > 0).sum())
        nbytes = M * d * 2 + active * d * d * 2 + (E + 1) * 4 + M * d * 2
        flops = 2 * M * d * d

        def lib(lhs=lhs, rhs=rhs, o=o):
            return torch._grouped_mm(lhs, rhs, offs=o[1:])
        row("grouped_matmul", "src/repro_torch/csrc/grouped_ffn.cu",
            "src/repro/kernels/grouped_ffn.py:60",
            lambda: G.grouped_matmul(lhs, rhs, o),
            lambda: G.grouped_matmul_plain(lhs, rhs, o),
            lib if hasattr(torch, "_grouped_mm") else None, nbytes, flops,
            BF16_FLOPS, f"M={M} K=N={d} E={E} ({active} experts active)")
        del rhs

    # the training backward at the phase-7 shapes (T = 8 x 512 tokens, k=1);
    # segments of a multiple of 8 rows: torch._grouped_mm's grouped-K form
    # (the drhs yardstick) needs each group's rows to span 16 bytes
    M = T
    assign = torch.randint(0, E, (M // 8,), generator=g)
    counts = torch.bincount(assign, minlength=E) * 8
    offs = torch.zeros(E + 1, dtype=torch.int32)
    offs[1:] = torch.cumsum(counts, 0)
    o = offs.to(dev)
    active = int((counts > 0).sum())
    gd = torch.randn(M, d, generator=g).to(torch.bfloat16).to(dev)
    lhs = torch.randn(M, d, generator=g).to(torch.bfloat16).to(dev)
    rhs = (torch.randn(E, d, d, generator=g) * d ** -0.5).to(
        torch.bfloat16).to(dev)
    flops = 2 * M * d * d
    gmm = hasattr(torch, "_grouped_mm")
    row("grouped_matmul_t", "src/repro_torch/csrc/grouped_ffn.cu",
        "src/repro/kernels/grouped_ffn.py:206",
        lambda: G.grouped_matmul_t(gd, rhs, o),
        lambda: G.grouped_matmul_t_plain(gd, rhs, o),
        (lambda: torch._grouped_mm(gd, rhs.transpose(-2, -1), offs=o[1:]))
        if gmm else None,
        M * d * 2 + active * d * d * 2 + (E + 1) * 4 + M * d * 2, flops,
        BF16_FLOPS, f"dlhs M={M} K=N={d} E={E} ({active} experts active)")
    del rhs
    # drhs at seq 512's M = 4096 and seq 1024's M = 8192: uniform segments
    # (the first row, bf16 out, is the train step's call), geometrically
    # skewed ones (expert 9 empty) and, at 4096, one expert holding every
    # row; each in both output dtypes.  Bytes: lhs and g read once, the
    # (E, K, N) gradient written once.
    drhs_rows = {}
    for Md, kind in ((T, "uniform"), (T, "skewed"), (T, "one expert"),
                     (2 * T, "uniform"), (2 * T, "skewed")):
        if kind == "uniform":
            od = offs if Md == T else torch.cat(
                [offs[:1], 2 * offs[1:]])
        elif kind == "skewed":
            od = skewed_offsets(torch, Md // 8, E, 0, 9) * 8
        else:
            od = torch.tensor([0] * 4 + [Md] * 13, dtype=torch.int32)
        od_dev = od.to(dev)
        sizes = (od[1:] - od[:-1]).tolist()
        xl = torch.randn(Md, d, generator=g).to(torch.bfloat16).to(dev)
        xg = torch.randn(Md, d, generator=g).to(torch.bfloat16).to(dev)
        xl_t = xl.t().contiguous()     # the library call's (K, M) layout
        for out_dt in (torch.bfloat16, torch.float32):
            lib = None
            if gmm:
                def lib(xl_t=xl_t, xg=xg, od_dev=od_dev, out_dt=out_dt):
                    if out_dt == torch.bfloat16:
                        return torch._grouped_mm(xl_t, xg, offs=od_dev[1:])
                    return torch._grouped_mm(xl_t, xg, offs=od_dev[1:],
                                             out_dtype=out_dt)
                try:
                    lib()
                except (RuntimeError, TypeError) as e:
                    print(f"    torch._grouped_mm refuses out_dtype="
                          f"{out_dt}: {str(e).splitlines()[0]}")
                    lib = None
            size = 2 if out_dt == torch.bfloat16 else 4
            row("grouped_drhs", "src/repro_torch/csrc/grouped_ffn.cu",
                "src/repro/kernels/grouped_ffn.py:120",
                lambda xl=xl, xg=xg, od_dev=od_dev, out_dt=out_dt:
                G.grouped_drhs(xl, xg, od_dev, out_dtype=out_dt),
                lambda xl=xl, xg=xg, od_dev=od_dev, out_dt=out_dt:
                G.grouped_drhs_plain(xl, xg, od_dev).to(out_dt),
                lib, 2 * Md * d * 2 + (E + 1) * 4 + E * d * d * size,
                2 * Md * d * d, BF16_FLOPS,
                f"drhs M={Md} K=N={d} E={E} {kind} (rows per expert "
                f"{min(sizes)}..{max(sizes)}) -> "
                f"{str(out_dt).removeprefix('torch.')}")
            drhs_rows[(Md, kind, out_dt)] = rows[-1]
        del xl, xg, xl_t
    for (Md, kind, out_dt), r in drhs_rows.items():
        base = drhs_rows[(Md, "uniform", out_dt)]
        if kind != "uniform" and None not in (r["device_ms"],
                                              base["device_ms"]):
            r["over_uniform_device"] = r["device_ms"] / base["device_ms"]
            print(f"    drhs M={Md} {kind} {out_dt} / uniform, device-only: "
                  f"{r['over_uniform_device']:.3f} (rows are split over "
                  f"blocks only past 2)")
    zeros = torch.zeros(M, d, dtype=torch.bfloat16, device=dev)
    for src_rows, n, what in ((M, M, "grouped dispatch VJP"),
                              (5120, M, "sort dispatch VJP")):
        gs = torch.randn(src_rows, d, generator=g).to(torch.bfloat16).to(dev)
        idx = torch.full((src_rows,), -1, dtype=torch.int32)
        idx[torch.randperm(src_rows, generator=g)[:n]] = torch.randperm(
            n, generator=g).to(torch.int32)
        idx = idx.to(dev)
        row("scatter_add_rows", "src/repro_torch/csrc/layout_transform.cu",
            "src/repro/kernels/layout_transform.py:104",
            lambda gs=gs, idx=idx, n=n: L.scatter_add_rows(gs, idx, n),
            lambda gs=gs, idx=idx, n=n: L.scatter_add_rows_plain(gs, idx, n),
            # index_add_ cannot skip -1 rows: a yardstick only for the
            # permutation
            (lambda gs=gs, idx=idx: torch.index_add(zeros, 0, idx, gs))
            if src_rows == n else None,
            src_rows * d * 2 + src_rows * 4 + n * d * 2, 0, BF16_FLOPS,
            f"{what} {src_rows} -> {n} rows, d={d} bf16")
    del zeros, gs
    flash_timings(torch, dev, g, row)
    return rows


def flash_timings(torch, dev, g, row):
    """Kernels 7-9 at the seq-1024 training shapes (B=8, H=KV=16, S=1024,
    d=128, bf16, causal).  ``bound_ms`` counts the work the causal function
    needs: the (q, k) pairs its mask keeps on this run's positions
    (S(S+1)/2 per (b, h)), 2*d operations per pair and product; the
    forward does 2 products, dq 3, dk/dv 4.  ``visited_bound_ms`` is the
    bound of each kernel's own arithmetic over the 64x64 tiles it visits,
    all on the bf16 tensor cores (the products of p and dS twice, as hi
    and lo): the forward q k^T once and P v twice, dq q k^T, dO v^T once
    and dS k twice, over the tiles of ``visited_k_tiles`` (its 16-row
    warps); dk/dv K Q^T and V dO^T once and P^T dO, dS^T q twice each over
    the tiles of ``visited_q_tiles`` (P^T dO only, twice, on a DV_ONLY
    tile).  Yardsticks: SDPA's forward, and one backward of SDPA for dq
    and dk/dv together (the same number in both rows), its device-only
    time captured on the stream its forward ran on."""
    from repro_torch.kernels import flash_attention as F
    B, H, S, d = 8, 16, 1024, 128
    q, k, v, do = (torch.randn(B, H, S, d, generator=g).to(torch.bfloat16)
                   .to(dev) for _ in range(4))
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    st = (d ** -0.5, True, None, None)
    o, lse = F.flash_fwd(q, k, v, pos, pos, *st)
    delta = (do.float() * o.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, pos, pos, *st)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = sdpa(*leaves, is_causal=True)

    def sdpa_bwd():
        return torch.autograd.grad(out, leaves, do, retain_graph=True)
    # for the graph: leaves and a forward of their own on the capture
    # stream (autograd runs a backward on its forward's stream, and a
    # leaf's gradient accumulator on the stream of the leaf's first use)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        side_leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out_side = sdpa(*side_leaves, is_causal=True)

    def sdpa_bwd_side():
        return torch.autograd.grad(out_side, side_leaves, do,
                                   retain_graph=True)
    bwd_graph = (sdpa_bwd_side, side)
    t_in, t_rows = B * H * S * d * 2, B * H * S * 4    # a (B,H,S,d) bf16 tensor
    pairs = int(F._mask(pos, pos, True, None).sum())   # causal: S(S+1)/2
    need = 2 * B * H * pairs * d                       # one product, needed
    tile = 2 * B * H * F.TILE ** 2 * d                 # one 64x64 tile product
    k_tiles = int(F.visited_k_tiles(pos.cpu(), pos.cpu(), True, None).sum()
                  ) * F.GROUP / F.TILE                 # in 64x64 tiles
    codes = F.visited_q_tiles(pos.cpu(), pos.cpu(), True, None)
    dv_only = int((codes == F.DV_ONLY).sum())
    q_tiles = int((codes > 0).sum())
    shape = f"B={B} H=KV={H} S={S} d={d} bf16 causal"
    src, ref = ("src/repro_torch/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention.py")
    all_tiles = (S // F.TILE) ** 2
    for (name, line, kern, plain, lib, lib_graph, n_in, n_rows, n_prod,
         tiles, own) in (
            ("flash_fwd", 49, lambda: F.flash_fwd(q, k, v, pos, pos, *st),
             lambda: F.flash_fwd_plain(q, k, v, pos, pos, *st),
             lambda: sdpa(q, k, v, is_causal=True), None, 4, 1, 2, k_tiles,
             3 * k_tiles),
            ("flash_dq", 81, lambda: F.flash_dq(*bwd),
             lambda: F.flash_dq_plain(*bwd), sdpa_bwd, bwd_graph, 5, 2, 3,
             k_tiles, 4 * k_tiles),
            ("flash_dkv", 115, lambda: F.flash_dkv(*bwd),
             lambda: F.flash_dkv_plain(*bwd), sdpa_bwd, bwd_graph, 6, 2, 4,
             q_tiles, 6 * (q_tiles - dv_only) + 2 * dv_only)):
        nbytes = n_in * t_in + n_rows * t_rows + 2 * S * 4
        row(name, src, f"{ref}:{line}", kern, plain, lib, nbytes,
            n_prod * need, BF16_FLOPS, shape, slow=True,
            library_graph=lib_graph,
            visited_tiles=f"{tiles:g} of {all_tiles}",
            visited_bound_ms=1e3 * own * tile / BF16_FLOPS)


# ---------------------------------------------------------------------------
# phase 6: where the time goes
# ---------------------------------------------------------------------------

def _device_ms(prof, DeviceType) -> float:
    """Sum of the device time of every kernel the profiler saw, in ms."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def host_waits(torch, fn) -> list:
    """Where ``fn()`` makes the host wait for the device, as ``file:line``
    (``torch.cuda.set_sync_debug_mode`` warns at each such operation)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def phase_profile(torch, smi):
    """One profiled prefill and 8 profiled decode steps per serving cell
    (``SERVE_CELLS``): wall time (host clock to a synchronise), the device
    time of all kernels, the device's idle share, the top kernels and the
    host's waits for the device (none may remain in a forward)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving.engine import resolve_decode_config, serve_config
    cfg = configs.get_config(ARCH)
    B = SERVE["batch"]
    model = Transformer(cfg, device="cuda", seed=0)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    print("phase 6: profile (torch.profiler; device ms = sum of kernel "
          "times, idle = 1 - device/wall)")
    out = {}
    for mode, S in SERVE_CELLS:
        prompt = torch.randint(0, cfg.vocab_size, (B, S),
                               generator=torch.Generator().manual_seed(3)
                               ).cuda()
        c = serve_config(cfg, dispatch=mode)
        dc = resolve_decode_config(c, B)
        with torch.inference_mode():
            caches = model.init_caches(B, S + 16)
            model.forward(prompt, caches=model.init_caches(B, S + 16), cfg=c)
            waits = {"prefill": host_waits(torch, lambda: model.forward(
                prompt, caches=model.init_caches(B, S + 16), cfg=c))}
            torch.cuda.synchronize()
            with profile(activities=acts) as pp:
                t0 = time.perf_counter()
                h, _, caches = model.forward(prompt, caches=caches, cfg=c)
                tok = model.logits_from_hidden(h[:, -1:])[:, -1].argmax(
                    -1, keepdim=True)
                torch.cuda.synchronize()
                prefill_wall = 1e3 * (time.perf_counter() - t0)
            model.decode_step(tok, caches, cfg=dc)          # warm decode
            waits["decode step"] = host_waits(
                torch, lambda: model.decode_step(tok, caches, cfg=dc))
            torch.cuda.synchronize()
            with profile(activities=acts) as pd:
                t0 = time.perf_counter()
                for _ in range(8):
                    lg, caches = model.decode_step(tok, caches, cfg=dc)
                    tok = lg[:, -1].argmax(-1, keepdim=True)
                torch.cuda.synchronize()
                decode_wall = 1e3 * (time.perf_counter() - t0) / 8
        for label, prof, wall in (("prefill", pp, prefill_wall),
                                  ("decode step", pd, decode_wall)):
            n = 1 if label == "prefill" else 8
            dev_ms = _device_ms(prof, DeviceType) / n
            print(f"  [{smi}] {mode} prompt {S} {label}: wall {wall:.3f} ms, device "
                  f"{dev_ms:.3f} ms, idle {1 - dev_ms / wall:.3f}")
            kernels = sorted((e for e in prof.key_averages()
                              if e.device_type == DeviceType.CUDA),
                             key=lambda e: -e.self_device_time_total)
            for e in kernels[:6]:
                print(f"      {e.self_device_time_total / 1e3 / n:8.3f} ms "
                      f"x{e.count // n:<3d} {e.key[:90]}")
            host = sorted((e for e in prof.key_averages()
                           if e.device_type == DeviceType.CPU),
                          key=lambda e: -e.self_cpu_time_total)
            calls = sum(e.count for e in host) // n
            syncs = {e.key: e.count / n for e in host
                     if "Synchronize" in e.key}
            print(f"      host: {calls} profiled calls per {label}; "
                  f"synchronise calls {syncs} (the profiled region ends in "
                  f"one cudaDeviceSynchronize); waits found by the sync "
                  f"debug mode in one more {label}: {len(waits[label])} "
                  f"{sorted(set(waits[label]))}")
            check(not waits[label],
                  f"{mode} prompt {S} {label}: the host waits for the device "
                  f"{len(waits[label])} times")
            print("      top by self CPU time:")
            for e in host[:6]:
                print(f"      {e.self_cpu_time_total / 1e3 / n:8.3f} ms "
                      f"x{e.count // n:<3d} {e.key[:90]}")
            out[f"{mode} prompt {S} {label}"] = dict(wall_ms=wall, device_ms=dev_ms,
                                          host_waits=len(waits[label]))
    return out


# the names of the kernels of csrc/*.cu, as the profiler shows them
PORT_KERNEL_NAMES = ("topk_gate_kernel", "gather_rows_kernel",
                     "gather_rowstep_kernel", "scatter_plan_kernel",
                     "scatter_sum_kernel", "grouped_mm_", "grouped_drhs_",
                     "flash_")


def phase_profile_train(torch, smi):
    """One profiled train step per phase-7 cell (``TRAIN_CELLS``, after a
    warm-up step): wall time (host clock to a synchronise), the
    device time of all kernels, the device's idle share, the top kernels
    and the port's own kernels, and the host's waits for the device inside
    one more step (reported; the aim is none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.core.config import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.serving.engine import serve_config
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    B = TRAIN["batch"]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    print("phase 6b: train step profile (torch.profiler; device ms = sum of "
          "kernel times, idle = 1 - device/wall)")
    out = {}
    for mode, S in TRAIN_CELLS:
        cfg = serve_config(configs.get_config(ARCH), dispatch=mode)
        tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=1,
                           total_steps=10)
        step = make_train_step(cfg, tcfg)
        state = init_train_state(cfg, tcfg, device="cuda")
        ds = SyntheticLM(cfg, B, S, seed=0, device="cuda")
        state, _ = step(state, ds.next_batch(0))
        batch = ds.next_batch(1)
        waits = host_waits(torch, lambda: step(state, batch))
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        dev_ms = _device_ms(prof, DeviceType)
        print(f"  [{smi}] {mode} seq {S} train step: wall {wall:.3f} ms, device "
              f"{dev_ms:.3f} ms, idle {1 - dev_ms / wall:.3f}, loss "
              f"{float(m['loss']):.4f}")
        kernels = sorted((e for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA),
                         key=lambda e: -e.self_device_time_total)
        for e in kernels[:10]:
            print(f"      {e.self_device_time_total / 1e3:8.3f} ms "
                  f"x{e.count:<4d} {e.key[:90]}")
        # the port's own kernels (csrc/*.cu), wherever they rank
        own = {}
        for e in kernels:
            name = e.key.removeprefix("void ").replace(
                "(anonymous namespace)::", "").split("(")[0]
            if name.startswith(PORT_KERNEL_NAMES):
                own[name] = (e.self_device_time_total / 1e3, e.count)
        print("      port kernels: " + ", ".join(
            f"{k} {t:.3f} ms x{n}" for k, (t, n) in own.items()))
        host = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CPU]
        launches = sum(e.count for e in host if e.key == "cudaLaunchKernel")
        print(f"      host: {sum(e.count for e in host)} profiled calls, "
              f"{launches} cudaLaunchKernel; waits found by the sync debug "
              f"mode in one more step: {len(waits)} {sorted(set(waits))}")
        out[f"{mode} seq {S} train step"] = dict(
            wall_ms=wall, device_ms=dev_ms, host_waits=len(waits),
            wait_sites=sorted(set(waits)),
            port_kernels_ms={k: t for k, (t, _) in own.items()})
        del state, step, batch
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 7: training at full width
# ---------------------------------------------------------------------------

TRAIN = dict(batch=8, warmup=2, timed=8)
# (dispatch, sequence length) of the training cells
TRAIN_CELLS = (("grouped", 512), ("sort", 512), ("grouped", 1024))
# launches per train step (2 layers, relu, k=1), forward + backward
TRAIN_PER_STEP = {
    "grouped": {"topk_gate": 2, "gather_rows": 2, "grouped_matmul": 4,
                "grouped_matmul_t": 4, "grouped_drhs": 4,
                "scatter_add_rows": 2},
    "sort": {"topk_gate": 2, "gather_rows": 4, "grouped_matmul": 0,
             "grouped_matmul_t": 0, "grouped_drhs": 0,
             "scatter_add_rows": 4}}


def train_per_step(mode: str, seq: int) -> dict:
    """Launches per train step of each kernel; the flash kernels run once
    per layer in the forward and once each in the backward past q_chunk."""
    flash = 2 if seq > Q_CHUNK else 0
    return TRAIN_PER_STEP[mode] | {"flash_fwd": flash, "flash_dq": flash,
                                   "flash_dkv": flash}


def phase_train(torch, smi):
    from repro_torch.launch import train
    steps = TRAIN["warmup"] + TRAIN["timed"]
    B = TRAIN["batch"]
    names = [k for k, _, _ in COUNTERS]
    totals = dict.fromkeys(names, 0)
    results = {}
    print(f"phase 7: training at full width, f32 masters + bf16 compute, "
          f"batch {B}, {TRAIN['warmup']} warm-up + {TRAIN['timed']} timed "
          f"AdamW steps per cell {TRAIN_CELLS}")
    for mode, S in TRAIN_CELLS:
        cell = f"{mode} seq {S}"
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        reset_counts()
        state, history = train.run(ARCH, steps=steps, batch=B, seq=S,
                                   smoke=False, seed=0, log_every=1,
                                   dispatch=mode, device="cuda", stats=stats)
        counts = read_counts(names)
        peak = torch.cuda.max_memory_allocated()
        want = {k: v * steps for k, v in train_per_step(mode, S).items()}
        timed = stats["step_s"][TRAIN["warmup"]:]
        med = statistics.median(timed)
        losses = [h["loss"] for h in history]
        print(f"  [{smi}] {cell}: median step {1e3 * med:.3f} ms (of "
              f"{len(timed)} timed; min {1e3 * min(timed):.3f}, max "
              f"{1e3 * max(timed):.3f}), {B * S / med:.1f} tokens/s, peak "
              f"memory {peak / 2 ** 30:.3f} GiB, launches {counts}")
        print(f"    loss trajectory {[round(v, 4) for v in losses]}")
        for k in counts:
            totals[k] += counts[k]
        check(counts == want, f"{cell}: training launch counts {counts} != "
                              f"{want} ({steps} steps)")
        bad = [(h["step"], k) for h in history for k, v in h.items()
               if not math.isfinite(v)]
        check(not bad, f"{cell}: non-finite metrics {bad}")
        check(all(h["skipped"] == 0 for h in history),
              f"{cell}: a step was skipped")
        results[cell] = dict(step_ms_median=1e3 * med,
                             step_ms=[1e3 * t for t in stats["step_s"]],
                             tokens_per_s=B * S / med,
                             peak_gib=peak / 2 ** 30, losses=losses)
        del state
    return totals, results


# ---------------------------------------------------------------------------
# phase 8: card against CPU, one f32 train step's gradients at full width
# ---------------------------------------------------------------------------

def phase_attention_card_vs_cpu(torch, params, cfg, S: int = 1024):
    """One full-width attention layer (block 0's f32 weights, batch 1, seq
    ``S`` > q_chunk, so the flash path) forward and backward, card against
    CPU: y and the gradients of sum(y * r) with respect to x and the four
    projections, each within 1e-4 of its max (f32 sums over S keys and
    2048-wide projections in other orders).  Returns the worst ratio."""
    from repro_torch.models import attention as A
    g = torch.Generator().manual_seed(13)
    x = torch.randn(1, S, cfg.d_model, generator=g)
    r = torch.randn(1, S, cfg.d_model, generator=g)
    pos = torch.arange(S, dtype=torch.int32)
    res = []
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev, copy=True).requires_grad_(True)
             for k, v in params["blocks"][0]["attn"].items()}
        xx = x.to(dev, copy=True).requires_grad_(True)
        reset_counts()
        y, _ = A.full_attention(p, xx, cfg.attention, positions=pos.to(dev))
        (y * r.to(dev)).sum().backward()
        res.append([t.detach().cpu() for t in
                    (y, xx.grad, *(p[k].grad for k in sorted(p)))])
    counts = read_counts(("flash_fwd", "flash_dq", "flash_dkv"))
    check(counts == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1},
          f"attention layer at seq {S}: card launches {counts}")
    worst = max((a - b).abs().max().item() / a.abs().max().item()
                for a, b in zip(*res))
    print(f"  attention layer, seq {S}, full width: y and gradients "
          f"(x, wk, wo, wq, wv) worst max|d|/max {worst:.2e} (tol 1e-4); "
          f"card launches {counts}")
    check(worst <= 1e-4, f"attention layer at seq {S}: card and CPU disagree")
    return worst


def forced_relu_ffn(torch, G, masks):
    """``grouped_ffn`` for relu experts with each layer's ReLU replaced by
    the given mask (its value and its derivative), the masks taken in call
    order: a train step that makes the ReLU decisions of another run."""
    left = list(masks)

    def fn(params, xs, offsets, act):
        h = G.grouped_matmul(xs, params["w_up"], offsets)
        h = torch.where(left.pop(0).to(h.device), h,
                        torch.zeros((), dtype=h.dtype, device=h.device))
        return G.grouped_matmul(h, params["w_out"], offsets)
    return fn


def phase_train_card_vs_cpu(torch):
    """One f32 train step's loss and gradients, card against CPU, at seq 64
    (both dispatch modes) and seq 1024 (grouped, the flash path).

    Tolerances: loss and grad norm rtol 1e-4; every leaf max|dgrad|/max|grad|
    <= 1e-3 (f32 sums of up to 50304 terms in other orders).  At 1024
    tokens a few ReLU pre-activations lie within f32 rounding of 0 and
    fall on the positive side on one device only (2 units of layer 0 and 1
    of layer 1 on an H100 at seed 11/12, |pre| <= 2.3e-6); each moves a
    whole column of that expert's w_up gradient and what flows back from
    that token.  So the card's step at seq 1024 is replayed with the CPU's
    ReLU masks forced (``forced_relu_ffn``) and every leaf of that replay
    is held to the 1e-3 above; the unforced step's leaves are printed.
    The attention layer this seq exercises is held on its own first
    (``phase_attention_card_vs_cpu``)."""
    from repro_torch import configs, tree
    from repro_torch.kernels import grouped_ffn as G
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import clip_by_global_norm
    from repro_torch.serving.engine import serve_config
    from repro_torch.training.train_step import loss_and_grads
    cfg = configs.get_config(ARCH).replace(dtype="float32")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator().manual_seed(11), device="cpu")
    gen = torch.Generator().manual_seed(12)
    grouped_matmul, grouped_ffn = G.grouped_matmul, G.grouped_ffn

    def recording(store):
        """grouped_matmul that keeps its outputs: with relu experts, every
        other one is a layer's ReLU pre-activations (rows in the stable
        expert order, the same on both devices)."""
        def fn(lhs, rhs, offsets):
            out = grouped_matmul(lhs, rhs, offsets)
            store.append(out.detach().cpu())
            return out
        return fn

    def step(dev, toks, c, S, ffn=None):
        """(loss, grad norm, gradient leaves on the CPU, pre-activations)."""
        masters = tree.map_(lambda p: p.to(dev, copy=True)
                            .requires_grad_(True), params)
        batch = {"inputs": toks[:, :-1].to(dev),
                 "targets": toks[:, 1:].to(dev),
                 "loss_mask": torch.ones((1, S), device=dev)}
        pre = []
        G.grouped_matmul = recording(pre)
        G.grouped_ffn = ffn or grouped_ffn
        try:
            loss, _, _, grads = loss_and_grads(masters, batch, c)
        finally:
            G.grouped_matmul, G.grouped_ffn = grouped_matmul, grouped_ffn
        _, gn = clip_by_global_norm(grads, 1.0)
        return (loss.item(), gn.item(), [g.cpu() for g in tree.leaves(grads)],
                pre[::2])

    def leaf_rel(ga, gb):
        worst = max((a - b).abs().max().item() / max(
            a.abs().max().item(), 1e-30) for a, b in zip(ga, gb))
        fro = max(((a - b).norm() / a.norm().clamp(min=1e-30)).item()
                  for a, b in zip(ga, gb))
        return worst, fro
    print(f"phase 8: f32 train-step gradients, card against CPU, batch 1, "
          f"seq 64 and 1024 (weights in {time.perf_counter() - t0:.1f} s); "
          f"tolerances: loss and grad norm rtol 1e-4; every leaf "
          f"max|dgrad|/max|grad| <= 1e-3 (f32 sums of up to 50304 terms in "
          f"other orders), at seq 1024 in the card's replay with the CPU's "
          f"ReLU masks (see the docstring)")
    out = {"attention layer seq 1024 worst_rel":
           phase_attention_card_vs_cpu(torch, params, cfg)}
    names = ("grouped_matmul_t", "grouped_drhs", "scatter_add_rows",
             "flash_fwd", "flash_dq", "flash_dkv")
    for mode, S in (("grouped", 64), ("sort", 64), ("grouped", 1024)):
        want = {k: v for k, v in train_per_step(mode, S).items()
                if k in names}
        toks = torch.randint(0, cfg.vocab_size, (1, S + 1),
                             generator=gen).to(torch.int32)
        c = serve_config(cfg, dispatch=mode)
        lc, nc, gc, pre_c = step("cpu", toks, c, S)
        reset_counts()
        lg, ng, gg, pre_g = step("cuda", toks, c, S)
        counts = read_counts(names)
        check(counts == want,
              f"{mode} seq {S}: card launches {counts} != {want}")
        worst, fro = leaf_rel(gc, gg)
        rl, rn = abs(lc - lg) / abs(lc), abs(nc - ng) / abs(nc)
        print(f"  {mode} seq {S}: loss cpu {lc:.6f} card {lg:.6f} (rel "
              f"{rl:.2e}); grad norm cpu {nc:.6f} card {ng:.6f} (rel "
              f"{rn:.2e}); worst leaf max|dgrad|/max|grad| {worst:.2e}, "
              f"relative Frobenius {fro:.2e} over {len(gc)} leaves; card "
              f"launches {counts}")
        res = dict(loss_rel=rl, grad_norm_rel=rn, worst_leaf_rel=worst,
                   worst_leaf_frobenius_rel=fro)
        check(rl <= 1e-4 and rn <= 1e-4,
              f"{mode} seq {S}: card and CPU loss or grad norm disagree")
        if mode == "grouped":
            flips = [(a > 0) != (b > 0) for a, b in zip(pre_c, pre_g)]
            near = max((a.abs()[f].max().item() for a, f in
                        zip(pre_c, flips) if f.any()), default=0.0)
            res["relu_flips_per_layer"] = [int(f.sum()) for f in flips]
            print(f"  {mode} seq {S}: ReLU units active on one device and "
                  f"not the other, per layer: {res['relu_flips_per_layer']}"
                  f" (largest |pre-activation| among them {near:.2e}, of "
                  f"max {max(a.abs().max().item() for a in pre_c):.2e})")
        if S > Q_CHUNK:
            ffn = forced_relu_ffn(torch, G, [a > 0 for a in pre_c])
            _, _, gf, _ = step("cuda", toks, c, S, ffn)
            worst, fro = leaf_rel(gc, gf)
            res.update(forced_worst_leaf_rel=worst,
                       forced_worst_leaf_frobenius_rel=fro)
            print(f"  {mode} seq {S}, the card's step with the CPU's ReLU "
                  f"masks: worst leaf max|dgrad|/max|grad| {worst:.2e}, "
                  f"relative Frobenius {fro:.2e} (tol 1e-3)")
        check(worst <= 1e-3,
              f"{mode} seq {S}: card and CPU gradients disagree")
        out[f"{mode} seq {S}"] = res
    del params
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one "
                                 "NVIDIA GPU (see the module docstring).")
    ap.add_argument("--phases", choices=("all", "kernels"), default="all",
                    help="'kernels': only the build, the kernel checks and "
                         "the kernel timings (phases 1, 2 and 5), for "
                         "working on a kernel; the last line then says "
                         "ok: false")
    phases = ap.parse_args(argv).phases
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this script "
              "needs a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    smi = smi_line()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"phase 1: {smi} | torch.cuda.get_device_name: {name} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("  TF32 off for matmuls and cuDNN (f32 products run in full f32)")
    t0 = time.perf_counter()
    build.load()
    print(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({build.build_info.get('library', 'already built')})")
    for line in build.build_info.get("ptxas", "").splitlines():
        if "Compiling entry" in line:
            print(f"    {line.split(chr(39))[1][:100]}")
        elif "Used" in line or "spill" in line or line.startswith("=="):
            print(f"      {line.strip()}")

    errs = phase_kernels(torch, dev)
    errs.update(phase_flash_kernels(torch, dev))
    if phases == "kernels":
        phase_timings(torch, dev, smi)
        print(smi)
        print(json.dumps({"ok": False, "partial": "phases 1, 2 and 5 only"}))
        return 0
    serve_counts, serving = phase_serve(torch, smi)
    phase_card_vs_cpu(torch)
    counts, training = phase_train(torch, smi)
    grads = phase_train_card_vs_cpu(torch)
    rows = phase_timings(torch, dev, smi)
    profile = phase_profile(torch, smi)
    profile.update(phase_profile_train(torch, smi))

    # launches: the counts of the main paths, the phase-7 training runs
    # (each driven with the counts set to 0 just before it and read just
    # after; all nine path kernels run there); kernel 10, on no serving or
    # training path, counts the phase-5 run of its own entry point
    kernels = []
    for r in rows:
        if any(k["name"] == r["name"] for k in kernels):
            continue          # the first row of each kernel is the main shape
        kernels.append({k: r[k] for k in (
            "name", "route", "source", "replaces", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")}
            | {"launches": r.get("launches", counts.get(r["name"])),
               "max_abs_err": errs[r["name"]]})
        if r["name"] == "gather_rows_rowstep":
            kernels[-1]["path"] = ("benchmark baseline (bench_layout), not "
                                   "on a serving or training path")
    check(len(kernels) == len(COUNTERS) + 1 and all(k["launches"]
                                                    for k in kernels),
          f"a kernel was not launched on its path: "
          f"{[(k['name'], k['launches']) for k in kernels]}")
    print(json.dumps({"serving": serving, "serving_launches": serve_counts,
                      "training": training, "train_grads_card_vs_cpu": grads,
                      "timings": rows, "profile": profile}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
