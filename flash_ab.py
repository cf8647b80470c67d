#!/usr/bin/env python3
"""Compare builds of the flash-attention kernels on one NVIDIA GPU.

    python3 flash_ab.py A.cu B.cu [C.cu ...] [--rounds 10] [--shape train]
                        [--shape gemma2-local ...]

Each argument is a version of ``src/repro_torch/csrc/flash_attention.cu``:
this tree's, a parent commit's (``git show
HEAD~1:src/repro_torch/csrc/flash_attention.cu > parent.cu``), or a copy
with one constant or line changed.  Each is built with the flags of
``repro_torch.kernels.build`` into a library of its own under
``build/flash_ab/`` (its header ``sm90_mma.cuh`` found beside it, else in
this tree's ``csrc``), all builds at once.  The script prints each
build's nvcc seconds and its registers and spills (ptxas) for the bf16
kernels at the shapes' head dims and for every flash kernel that spills;
then, shape by shape,
it checks every build's
outputs against the first build's (bitwise, else the largest difference),
and times the kernels with CUDA events, the builds taking turns (A B C,
then C B A, ...).  It prints each build's median and quartiles per
kernel, and in how many rounds each later build beat the first.

``--shape`` (repeatable): ``train`` (the default) times the bf16 forward, dq and dk/dv
at the seq-1024 training shape (B=8, H=KV=16, S=1024, d=128, causal);
``train-f32`` the f32 forward, dq and dk/dv at the same shape;
``gemma2-local``, ``gemma2-global`` and ``danube`` time the bf16 forward
at the windowed presets' prefill of 4 prompts of 8064 tokens: gemma2's
local layers (16:8 heads, d=256, window 4096, softcap 50), its global
ones (no window) and h2o-danube3's layers (32:8, d=120, window 4096);
``gemma2-local-train``, ``gemma2-global-train`` and ``danube-train`` time
the forward, dq and dk/dv at the same layers' training shape, batch 2 x
seq 8192.  The ptxas lines of every dq and dk/dv instance are printed
(the bf16 ones at every head dim, and the f32 ones), with those of the
forward at the shapes' head dims and of any flash kernel that spills.
Exits 2 without a GPU.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
KERNELS = ("flash_fwd_bf16", "flash_dq_bf16", "flash_dkv_bf16")
KERNELS_F32 = ("flash_fwd_f32", "flash_dq_f32", "flash_dkv_f32")
# (B, H, KV, S, d, window, cap, kernels timed; the first is the forward)
SHAPES = {
    "train": (8, 16, 16, 1024, 128, None, None, KERNELS),
    "train-f32": (8, 16, 16, 1024, 128, None, None, KERNELS_F32),
    "gemma2-local": (4, 16, 8, 8064, 256, 4096, 50.0, ("flash_fwd_bf16",)),
    "gemma2-global": (4, 16, 8, 8064, 256, None, 50.0, ("flash_fwd_bf16",)),
    "danube": (4, 32, 8, 8064, 120, 4096, None, ("flash_fwd_bf16",)),
    "gemma2-local-train": (2, 16, 8, 8192, 256, 4096, 50.0, KERNELS),
    "gemma2-global-train": (2, 16, 8, 8192, 256, None, 50.0, KERNELS),
    "danube-train": (2, 32, 8, 8192, 120, 4096, None, KERNELS),
}
# a bf16 kernel instance in ptxas's report: kernel, template head dim
# argument (NJ = d / 16 in older sources' dq and dk/dv, d since they took
# d = 120 and 256) and softcap flag; an f32 kernel's name
ENTRY = re.compile(r"flash_(fwd|dq|dkv)_bf16_kernelILi(\d+)ELb(\d)E")
ENTRY_F32 = re.compile(r"flash_(fwd|dq|dkv)_kernel")


def build_one(build, i: int, src: pathlib.Path, dims):
    """(library, ptxas lines of every dq and dk/dv instance, of the
    forward at the head dims ``dims`` and of every kernel that spills)."""
    out = ROOT / "build" / "flash_ab"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"lib{i}_{src.stem}.so"
    t0 = time.perf_counter()
    r = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(src.parent), "-I",
         str(build.CSRC), "-shared", "-o", str(so), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}")
    lines = r.stdout.splitlines()
    report = [f"nvcc {time.perf_counter() - t0:.1f} s (all builds at once, "
              f"one process each)"]
    for j, line in enumerate(lines):
        if "Compiling entry" not in line:
            continue
        spill = lines[j + 2].split(":", 1)[-1].strip()
        regs = lines[j + 3].split(":", 1)[-1].strip()
        m, m32 = ENTRY.search(line), ENTRY_F32.search(line)
        if m is not None:
            kind, arg, cap = m.group(1), int(m.group(2)), m.group(3) == "1"
            ours = kind != "fwd" or arg in dims
            name = f"{kind}<{arg}, {'softcap' if cap else 'no cap'}>"
        elif m32 is not None:
            kind = m32.group(1)
            ours, name = kind != "fwd", f"{kind} f32"
        else:
            continue
        if ours or not spill.startswith("0 bytes stack"):
            report.append(f"{name}: {spill}; {regs}")
    lib = ctypes.CDLL(str(so))
    # sources before dk/dv took the plan's scratch pointer take one less
    lib.dkv_scratch = "void* nokey" in src.read_text()
    for name in KERNELS + KERNELS_F32:
        argtypes = list(build.SIGNATURES[name])
        if name.startswith("flash_dkv") and not lib.dkv_scratch:
            argtypes.pop(10)
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--shape", choices=sorted(SHAPES), action="append")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_ab: no GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    shapes = args.shape or ["train"]
    dims = {SHAPES[sh][4] for sh in shapes}
    with concurrent.futures.ThreadPoolExecutor(len(args.sources)) as ex:
        built = list(ex.map(lambda a: build_one(build, *a, dims),
                            enumerate(args.sources)))
    names = [f"{i}:{s}" for i, s in enumerate(args.sources)]
    for name, (_, report) in zip(names, built):
        print(f"== {name}")
        for line in report:
            print(f"   {line}")
    for sh in shapes:
        compare(torch, build, built, names, sh, args.rounds)
    return 0


def compare(torch, build, built, names, shape: str, rounds: int) -> None:
    """Outputs against build 0's, then the builds timed in turns, at
    ``shape``; a build whose kernels refuse the shape's head dim (a
    parent's, before the forward took d = 120 and 256) is left out."""
    B, H, KV, S, d, window, cap, timed = SHAPES[shape]
    fwd = timed[0]
    dt = torch.float32 if fwd.endswith("f32") else torch.bfloat16
    g = torch.Generator().manual_seed(7)
    q, do = (torch.randn(B, H, S, d, generator=g).to(dt).cuda()
             for _ in range(2))
    k, v = (torch.randn(B, KV, S, d, generator=g).to(dt).cuda()
            for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32, device="cuda")
    tail = (B, H, KV, S, S, d, d ** -0.5, 1, int(window or 0),
            int(window is not None), float(cap or 0.0), int(cap is not None),
            build.stream(q))
    ptr = build.ptr

    def run(lib, kernel, lse=None, delta=None):
        if kernel == fwd:
            outs = (torch.empty_like(q),
                    torch.empty(B, H, S, device="cuda"))
            ins = (q, k, v, pos, pos)
        else:
            # dk/dv: dk, dv and the plan's scratch of ceil(S / 64) ints
            outs = ((torch.empty_like(q),) if kernel.startswith("flash_dq")
                    else (torch.empty_like(k), torch.empty_like(v),
                          torch.empty(-(-S // 64), dtype=torch.int32,
                                      device="cuda"))[:3 if lib.dkv_scratch
                                                      else 2])
            ins = (q, k, v, do, lse, delta, pos, pos)
        rc = getattr(lib, kernel)(*(ptr(t) for t in (*ins, *outs)), *tail)
        if rc:
            raise RuntimeError(f"{kernel}: CUDA error {rc}")
        return outs

    taken = []
    for name, b in zip(names, built):
        try:
            run(b[0], fwd)
            taken.append((name, b))
        except RuntimeError as e:
            print(f"{name} at {shape}: left out ({e})")
    names, built = [n for n, _ in taken], [b for _, b in taken]
    o, lse = run(built[0][0], fwd)
    delta = (do.float() * o.float()).sum(-1)
    first = {kn: run(built[0][0], kn, lse, delta) for kn in timed}
    for name, (lib, _) in zip(names[1:], built[1:]):
        for kn in timed:
            outs = run(lib, kn, lse, delta)
            same = all(torch.equal(a, b) for a, b in zip(outs[:2],
                                                          first[kn]))
            diff = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(outs[:2], first[kn]))
            print(f"{name} {kn}: " + ("bitwise equal to build 0" if same
                                      else f"max |diff| {diff:.3e}"))

    calls = 20 if shape.startswith("train") else 5

    def time_ms(lib, kn):
        for _ in range(2):
            run(lib, kn, lse, delta)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(calls):
            run(lib, kn, lse, delta)
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / calls

    times = {(i, kn): [] for i in range(len(built)) for kn in timed}
    for r in range(rounds):
        order = range(len(built)) if r % 2 == 0 else reversed(
            range(len(built)))
        for i in order:
            for kn in timed:
                times[(i, kn)].append(time_ms(built[i][0], kn))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[{smi}] ms per call at {shape}: B={B} H={H} KV={KV} S={S} "
          f"d={d} {dt} causal window={window} cap={cap}, {rounds} "
          f"rounds of {calls} calls")
    for kn in timed:
        for i, name in enumerate(names):
            xs = times[(i, kn)]
            q1, _, q3 = statistics.quantiles(xs, n=4)
            beat = ("" if i == 0 else f", beat build 0 in "
                    f"{sum(a < b for a, b in zip(xs, times[(0, kn)]))} of "
                    f"{len(xs)} rounds")
            print(f"  {kn} {name}: median {statistics.median(xs):.4f}, "
                  f"quartiles {q1:.4f}-{q3:.4f}{beat}")


if __name__ == "__main__":
    sys.exit(main())
