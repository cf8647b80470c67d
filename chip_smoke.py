#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit:

1. Setup: the card's name and power limit, TF32 off, the kernel build.
2. Each hand-written kernel against its plain PyTorch version on the card,
   at the main path's shapes and at edge cases, with stated tolerances.
3. Serving at full width: ``hetumoe-paper-16e`` (bf16, seeded random
   weights) through ``repro_torch.launch.serve.run`` → ``generate``, batch 8,
   prompt 512, 32 new tokens, once with ``grouped`` and once with ``sort``
   dispatch; the kernels' launch counters must rise by what the path
   implies.
4. Card against CPU at full width: the same f32 weights, batch 1, prompt
   64, prefill last-token logits from the card (kernels) and the CPU (plain
   versions), both dispatch modes.
5. Per-kernel timings at the main path's shapes (CUDA events, median of
   batches after warm-up) beside the bound, the plain version and the
   nearest single PyTorch call.
6. Where the time goes: a profiled prefill and decode steps per dispatch
   mode (wall time, kernel time, the device's idle share, top kernels), and
   the host's waits for the device in a forward, which must be none.

The last lines are the card's name and power limit, one JSON object of
per-kernel numbers, and ``{"ok": true, "device": {...}}``.  The script
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


def graph_ms(torch, fn, *, reps: int = 25, per_graph: int = 10):
    """Device time per call from CUDA-graph replays (no host launch cost),
    or None when the call cannot be captured."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
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


def skewed_offsets(torch, M: int, E: int, tail: int, empty: int):
    """Offsets with geometrically skewed segments, expert ``empty`` empty
    and ``tail`` rows past offsets[E]."""
    w = torch.tensor([0.8 ** e for e in range(E)], dtype=torch.float64)
    w[empty] = 0
    sizes = torch.floor(w / w.sum() * (M - tail)).to(torch.int64)
    offs = torch.zeros(E + 1, dtype=torch.int32)
    offs[1:] = torch.cumsum(sizes, 0).to(torch.int32)
    return offs


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

    print("phase 2c: grouped_matmul (f32 rtol/atol 1e-4; bf16 within 1 ulp "
          "of the f32-accumulated plain result rounded once, plus the f32 "
          "summation-order bound)")
    E = 16
    mcases = [("M=4096 K=N=2048 E=16 skewed, expert 9 empty, tail 96",
               4096, 2048, 2048, E, skewed_offsets(torch, 4096, E, 96, 9)),
              ("decode M=8 K=N=2048 E=16", 8, 2048, 2048, E,
               torch.tensor([0, 1, 1, 3, 3, 3, 4, 4, 4, 4, 5, 6, 6, 6, 7, 7,
                             8], dtype=torch.int32)),
              ("ragged M=100 K=72 N=40 E=3 (partial tiles)", 100, 72, 40, 3,
               torch.tensor([0, 30, 31, 90], dtype=torch.int32)),
              ("M=50 K=20 N=12 E=2 (unvectorised loads)", 50, 20, 12, 2,
               torch.tensor([0, 25, 45], dtype=torch.int32))]
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
    return errs


# ---------------------------------------------------------------------------
# phase 3: serving at full width
# ---------------------------------------------------------------------------

def reset_counts():
    from repro_torch.kernels import grouped_ffn, layout_transform, topk_gate
    topk_gate.launches = layout_transform.launches = grouped_ffn.launches = 0


def read_counts():
    from repro_torch.kernels import grouped_ffn, layout_transform, topk_gate
    return {"topk_gate": topk_gate.launches,
            "gather_rows": layout_transform.launches,
            "grouped_matmul": grouped_ffn.launches}


def phase_serve(torch, smi):
    from repro_torch import configs
    from repro_torch.launch import serve
    cfg = configs.get_config(ARCH)
    L = cfg.num_layers
    forwards = SERVE["gen"]                  # 1 prefill + gen-1 decode steps
    expect = {"grouped": {"topk_gate": L * forwards,
                          "gather_rows": L * forwards,
                          "grouped_matmul": 2 * L * forwards},
              "sort": {"topk_gate": L * forwards,
                       "gather_rows": 2 * L * forwards,
                       "grouped_matmul": 0}}
    print("phase 3: warm-up (grouped, 2 new tokens)")
    serve.run(ARCH, smoke=False, batch=SERVE["batch"],
              prompt_len=SERVE["prompt_len"], gen=2, dispatch="grouped",
              device="cuda")
    totals = dict.fromkeys(expect["grouped"], 0)
    results = {}
    for mode in ("grouped", "sort"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        reset_counts()
        out = serve.run(ARCH, smoke=False, dispatch=mode, device="cuda",
                        stats=stats, **SERVE)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        for k, v in counts.items():
            totals[k] += v
        B, gen = SERVE["batch"], SERVE["gen"]
        decode_ms = 1e3 * stats["decode_s"] / stats["decode_steps"]
        tok_s = B * gen / (stats["prefill_s"] + stats["decode_s"])
        print(f"  [{smi}] {mode}: prefill {1e3 * stats['prefill_s']:.3f} ms, "
              f"decode {decode_ms:.3f} ms/step, {tok_s:.1f} tokens/s "
              f"(batch {B} x {gen} new), peak memory "
              f"{peak / 2 ** 30:.3f} GiB, launches {counts}")
        check(counts == expect[mode],
              f"{mode}: launch counts {counts} != expected {expect[mode]}")
        check(tuple(out.shape) == (B, SERVE["prompt_len"] + gen),
              f"{mode}: output shape {tuple(out.shape)}")
        new = out[:, SERVE["prompt_len"]:]
        check(bool(((new >= 0) & (new < cfg.vocab_size)).all()),
              f"{mode}: generated ids out of range")
        check(stats["logits_finite"], f"{mode}: non-finite logits")
        results[mode] = dict(prefill_ms=1e3 * stats["prefill_s"],
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
    prompt = torch.randint(0, cfg.vocab_size, (1, 64),
                           generator=torch.Generator().manual_seed(8))
    for mode in ("grouped", "sort"):
        c = serve_config(cfg, dispatch=mode)
        with torch.inference_mode():
            logits = []
            for model in (cpu, gpu):
                reset_counts()
                h, _, _ = model.forward(prompt.to(model.device), cfg=c)
                logits.append(model.logits_from_hidden(h[:, -1:]).cpu())
        # the card's forward went through the kernels (2 layers)
        want = {"grouped": {"topk_gate": 2, "gather_rows": 2,
                            "grouped_matmul": 4},
                "sort": {"topk_gate": 2, "gather_rows": 4,
                         "grouped_matmul": 0}}[mode]
        check(read_counts() == want,
              f"{mode}: card forward launches {read_counts()} != {want}")
        diff = (logits[0] - logits[1]).abs().max().item()
        scale = logits[0].abs().max().item()
        print(f"  {mode}: max |card - cpu| = {diff:.3e}, tol "
              f"1e-3 * max|logit| = {1e-3 * scale:.3e}")
        check(math.isfinite(diff) and diff <= 1e-3 * scale,
              f"{mode}: card and CPU logits disagree")
    del cpu, gpu, params


# ---------------------------------------------------------------------------
# phase 5: per-kernel timings
# ---------------------------------------------------------------------------

def phase_timings(torch, dev, smi):
    from repro_torch.kernels import grouped_ffn as G
    from repro_torch.kernels import layout_transform as L
    from repro_torch.kernels import topk_gate as K
    g = torch.Generator(device="cpu").manual_seed(99)
    T, E, d = SERVE["batch"] * SERVE["prompt_len"], 16, 2048
    rows = []

    def bound(nbytes, flops, peak):
        tb, tf = nbytes / HBM_BYTES_PER_S, flops / peak
        return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")

    def row(name, source, replaces, kernel, plain, library, nbytes, flops,
            peak, shape):
        ms = time_ms(torch, kernel)
        dev_ms = graph_ms(torch, kernel)
        plain_ms = time_ms(torch, plain)
        lib_ms = None
        if library is not None:
            try:
                lib_ms = time_ms(torch, library)
            except RuntimeError as e:
                print(f"    library call does not run on this build: "
                      f"{str(e).splitlines()[0]}")
        bound_ms, by = bound(nbytes, flops, peak)
        print(f"  [{smi}] {name} {shape}: kernel_ms {ms:.4f} (device-only "
              f"{dev_ms if dev_ms is None else round(dev_ms, 4)}), plain_ms "
              f"{plain_ms:.4f}, library_ms "
              f"{lib_ms if lib_ms is None else round(lib_ms, 4)}, bound_us "
              f"{1e3 * bound_ms:.2f} ({by})")
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=by, library_ms=lib_ms,
                         device_ms=dev_ms, shape=shape))

    print("phase 5: timings (CUDA events; median of 25 batches of 10 calls "
          "after warm-up)")
    # gate at prefill: logits (T, E) f32, k=1
    for S in (T, SERVE["batch"]):
        x = torch.randn(S, E, generator=g).to(dev)
        nbytes = S * E * 4 + S * (4 + 4 + 4 + 4)
        row("topk_gate", "src/repro_torch/csrc/topk_gate.cu",
            "src/repro/kernels/topk_gate.py:24",
            lambda: K.fused_topk_gate(x, 1), lambda: K.topk_gate_plain(x, 1),
            lambda: torch.topk(x, 1, dim=-1), nbytes, 4 * S * E, F32_FLOPS,
            f"S={S} E={E} k=1")
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
    return rows


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
    """One profiled prefill and 8 profiled decode steps per dispatch mode at
    the serving shapes: wall time (host clock to a synchronise), the device
    time of all kernels, the device's idle share, the top kernels and the
    host's waits for the device (none may remain in a forward)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving.engine import resolve_decode_config, serve_config
    cfg = configs.get_config(ARCH)
    B, S = SERVE["batch"], SERVE["prompt_len"]
    model = Transformer(cfg, device="cuda", seed=0)
    prompt = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(3)).cuda()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    print("phase 6: profile (torch.profiler; device ms = sum of kernel "
          "times, idle = 1 - device/wall)")
    out = {}
    for mode in ("grouped", "sort"):
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
            print(f"  [{smi}] {mode} {label}: wall {wall:.3f} ms, device "
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
                  f"{mode} {label}: the host waits for the device "
                  f"{len(waits[label])} times")
            print("      top by self CPU time:")
            for e in host[:6]:
                print(f"      {e.self_cpu_time_total / 1e3 / n:8.3f} ms "
                      f"x{e.count // n:<3d} {e.key[:90]}")
            out[f"{mode} {label}"] = dict(wall_ms=wall, device_ms=dev_ms,
                                          host_waits=len(waits[label]))
    return out


def main() -> int:
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
        if "Used" in line or line.startswith("=="):
            print(f"    {line.strip()}")

    errs = phase_kernels(torch, dev)
    counts, serving = phase_serve(torch, smi)
    phase_card_vs_cpu(torch)
    rows = phase_timings(torch, dev, smi)
    profile = phase_profile(torch, smi)

    kernels = []
    for r in rows:
        if any(k["name"] == r["name"] for k in kernels):
            continue          # the first row of each kernel is the prefill shape
        kernels.append({k: r[k] for k in (
            "name", "route", "source", "replaces", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")}
            | {"launches": counts[r["name"]], "max_abs_err": errs[r["name"]]})
    print(json.dumps({"serving": serving, "timings": rows,
                      "profile": profile}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
