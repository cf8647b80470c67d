#!/usr/bin/env python3
"""Compare builds of the flash-attention kernels on one NVIDIA GPU.

    python3 flash_ab.py A.cu B.cu [C.cu ...] [--rounds 10]

Each argument is a version of ``src/repro_torch/csrc/flash_attention.cu``:
this tree's, a parent commit's (``git show
HEAD~1:src/repro_torch/csrc/flash_attention.cu > parent.cu``), or a copy
with one constant changed.  Each is built with the flags of
``repro_torch.kernels.build`` into a library of its own under
``build/flash_ab/`` (its header ``sm90_mma.cuh`` found beside it, else in
this tree's ``csrc``), all builds at once.  The script prints each
build's registers and spills at head dim 128 (ptxas), checks every build's
outputs against the first build's (bitwise, else the largest difference),
and times the bf16 forward, dq and dk/dv at the seq-1024 training shape
(B=8, H=KV=16, S=1024, d=128, causal) with CUDA events, the builds taking
turns (A B C, then C B A, ...).  It prints each build's median and
quartiles per kernel, and in how many rounds each later build beat the
first.  Exits 2 without a GPU.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
SHAPE = dict(B=8, H=16, S=1024, d=128)
KERNELS = ("flash_fwd_bf16", "flash_dq_bf16", "flash_dkv_bf16")


def build_one(build, i: int, src: pathlib.Path):
    """(library, ptxas lines of the d=128 bf16 kernels)."""
    out = ROOT / "build" / "flash_ab"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"lib{i}_{src.stem}.so"
    r = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(src.parent), "-I",
         str(build.CSRC), "-shared", "-o", str(so), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}")
    lines = r.stdout.splitlines()
    report = []
    for j, line in enumerate(lines):
        if "Compiling entry" in line and "bf16_kernelILi8E" in line:
            kind = line.split("_bf16_kernel")[0].split("flash_")[-1]
            cap = "softcap" if "bf16_kernelILi8ELb1" in line else "no cap"
            report.append(f"{kind} d=128 {cap}: {lines[j + 2].strip()}; "
                          f"{lines[j + 3].split(':', 1)[-1].strip()}")
    lib = ctypes.CDLL(str(so))
    for name in KERNELS:
        fn = getattr(lib, name)
        fn.argtypes = list(build.SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib, report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_ab: no GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    with concurrent.futures.ThreadPoolExecutor(len(args.sources)) as ex:
        built = list(ex.map(lambda a: build_one(build, *a),
                            enumerate(args.sources)))
    names = [f"{i}:{s}" for i, s in enumerate(args.sources)]
    for name, (_, report) in zip(names, built):
        print(f"== {name}")
        for line in report:
            print(f"   {line}")

    B, H, S, d = SHAPE.values()
    g = torch.Generator().manual_seed(7)
    q, k, v, do = (torch.randn(B, H, S, d, generator=g).to(torch.bfloat16)
                   .cuda() for _ in range(4))
    pos = torch.arange(S, dtype=torch.int32, device="cuda")
    tail = (B, H, H, S, S, d, d ** -0.5, 1, 0, 0, 0.0, 0, build.stream(q))
    ptr = build.ptr

    def run(lib, kernel, lse=None, delta=None):
        if kernel == "flash_fwd_bf16":
            outs = (torch.empty_like(q),
                    torch.empty(B, H, S, device="cuda"))
            ins = (q, k, v, pos, pos)
        else:
            outs = ((torch.empty_like(q),) if kernel == "flash_dq_bf16"
                    else (torch.empty_like(k), torch.empty_like(v)))
            ins = (q, k, v, do, lse, delta, pos, pos)
        rc = getattr(lib, kernel)(*(ptr(t) for t in (*ins, *outs)), *tail)
        if rc:
            raise RuntimeError(f"{kernel}: CUDA error {rc}")
        return outs

    o, lse = run(built[0][0], "flash_fwd_bf16")
    delta = (do.float() * o.float()).sum(-1)
    first = {kn: run(built[0][0], kn, lse, delta) for kn in KERNELS}
    for name, (lib, _) in zip(names[1:], built[1:]):
        for kn in KERNELS:
            outs = run(lib, kn, lse, delta)
            same = all(torch.equal(a, b) for a, b in zip(outs, first[kn]))
            diff = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(outs, first[kn]))
            print(f"{name} {kn}: " + ("bitwise equal to build 0" if same
                                      else f"max |diff| {diff:.3e}"))

    def time_ms(lib, kn, n=20):
        for _ in range(3):
            run(lib, kn, lse, delta)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            run(lib, kn, lse, delta)
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / n

    times = {(i, kn): [] for i in range(len(built)) for kn in KERNELS}
    for r in range(args.rounds):
        order = range(len(built)) if r % 2 == 0 else reversed(
            range(len(built)))
        for i in order:
            for kn in KERNELS:
                times[(i, kn)].append(time_ms(built[i][0], kn))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[{smi}] ms per call at B={B} H=KV={H} S={S} d={d} bf16 causal, "
          f"{args.rounds} rounds of 20 calls")
    for kn in KERNELS:
        for i, name in enumerate(names):
            xs = times[(i, kn)]
            q1, _, q3 = statistics.quantiles(xs, n=4)
            beat = ("" if i == 0 else f", beat build 0 in "
                    f"{sum(a < b for a, b in zip(xs, times[(0, kn)]))} of "
                    f"{len(xs)} rounds")
            print(f"  {kn} {name}: median {statistics.median(xs):.4f}, "
                  f"quartiles {q1:.4f}-{q3:.4f}{beat}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
