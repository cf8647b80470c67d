#!/usr/bin/env python3
"""Compare builds of the grouped drhs kernel on one NVIDIA GPU.

    python3 drhs_ab.py A.cu B.cu [C.cu ...] [--rounds 10]

Each argument is a version of ``src/repro_torch/csrc/grouped_ffn.cu``:
this tree's, or a parent commit's (``git show
HEAD~1:src/repro_torch/csrc/grouped_ffn.cu > parent.cu``).  Each is built
with the flags of ``repro_torch.kernels.build`` into a library of its own
under ``build/drhs_ab/`` (``sm90_mma.cuh`` found beside it, else in this
tree's ``csrc``), all builds at once.  A version whose
``grouped_drhs_bf16`` takes an output dtype (``int out_bf16``) is run in
both output dtypes, an older one in f32 only.  The script prints, for
each build and each of ``chip_smoke.py``'s phase-2e cases with bf16
inputs (the same shapes and offsets, one draw of inputs shared by all
builds), the relative Frobenius distance ||out - plain|| / ||plain|| of
the f32 output from the plain version, and whether the builds' outputs
are bitwise equal; then times drhs at M = 4096 and 8192 (K = N = 2048,
E = 16, uniform and skewed segments) with CUDA events, the builds taking
turns (A B C, then C B A, ...): median and quartiles per build.  Exits 2
without a GPU.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import pathlib
import statistics
import subprocess
import sys

import chip_smoke

ROOT = pathlib.Path(__file__).resolve().parent


def build_one(build, i: int, src: pathlib.Path):
    """(library, whether its drhs takes an output dtype)."""
    out = ROOT / "build" / "drhs_ab"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"lib{i}_{src.stem}.so"
    r = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(src.parent), "-I",
         str(build.CSRC), "-shared", "-o", str(so), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}")
    typed = "int out_bf16" in src.read_text()
    lib = ctypes.CDLL(str(so))
    fn = lib.grouped_drhs_bf16
    sig = list(build.SIGNATURES["grouped_drhs_bf16"])
    fn.argtypes = sig if typed else sig[:8] + sig[9:]
    fn.restype = ctypes.c_int
    return lib, typed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("drhs_ab: no GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import grouped_ffn as G
    torch.backends.cuda.matmul.allow_tf32 = False
    with concurrent.futures.ThreadPoolExecutor(len(args.sources)) as ex:
        built = list(ex.map(lambda a: build_one(build, *a),
                            enumerate(args.sources)))
    names = [f"{i}:{s}" for i, s in enumerate(args.sources)]

    def run(i, lhs, g, offs, out_dt):
        lib, typed = built[i]
        E = offs.shape[0] - 1
        out = torch.empty((E, lhs.shape[1], g.shape[1]), dtype=out_dt,
                          device="cuda")
        a = [build.ptr(lhs), build.ptr(g), build.ptr(offs), build.ptr(out),
             lhs.shape[0], lhs.shape[1], g.shape[1], E]
        if typed:
            a.append(int(out_dt == torch.bfloat16))
        rc = lib.grouped_drhs_bf16(*a, build.stream(lhs))
        if rc:
            raise RuntimeError(f"{names[i]}: CUDA error {rc}")
        return out

    gen = torch.Generator().manual_seed(5)
    print("relative Frobenius distance of the f32 output from the plain "
          "version, bf16 inputs")
    for name, M, K, N, E, offs in chip_smoke.drhs_cases(torch):
        lhs = torch.randn(M, K, generator=gen).to(torch.bfloat16).cuda()
        g = torch.randn(M, N, generator=gen).to(torch.bfloat16).cuda()
        o = offs.cuda()
        ref = G.grouped_drhs_plain(lhs, g, o)
        outs = [run(i, lhs, g, o, torch.float32) for i in range(len(built))]
        fro = [((x - ref).norm() / ref.norm().clamp(min=1e-30)).item()
               for x in outs]
        same = all(torch.equal(x, outs[0]) for x in outs[1:])
        print(f"  {name}: " + ", ".join(f"{n} {f:.3e}" for n, f in
                                        zip(names, fro))
              + f"; builds bitwise equal: {same}")

    d, E = 2048, 16
    shapes = []
    for M in (4096, 8192):
        uni = torch.arange(E + 1, dtype=torch.int32) * (M // E)
        skew = chip_smoke.skewed_offsets(torch, M, E, 0, 9)
        for kind, offs in (("uniform", uni), ("skewed", skew)):
            lhs = torch.randn(M, d, generator=gen).to(torch.bfloat16).cuda()
            g = torch.randn(M, d, generator=gen).to(torch.bfloat16).cuda()
            shapes.append((f"M={M} {kind}", lhs, g, offs.cuda()))
    cells = [(i, s, dt) for i in range(len(built)) for s in range(len(shapes))
             for dt in (torch.float32, torch.bfloat16)
             if dt == torch.float32 or built[i][1]]

    def time_ms(i, s, dt, n=20):
        _, lhs, g, o = shapes[s]
        for _ in range(3):
            run(i, lhs, g, o, dt)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            run(i, lhs, g, o, dt)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    times = {c: [] for c in cells}
    for r in range(args.rounds):
        for c in (cells if r % 2 == 0 else cells[::-1]):
            times[c].append(time_ms(*c))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[{smi}] ms per call, K=N={d} E={E} bf16 inputs, {args.rounds} "
          f"rounds of 20 calls")
    for (i, s, dt), xs in times.items():
        q1, _, q3 = statistics.quantiles(xs, n=4)
        print(f"  {shapes[s][0]} -> {str(dt).removeprefix('torch.')} "
              f"{names[i]}: median {statistics.median(xs):.4f}, quartiles "
              f"{q1:.4f}-{q3:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
