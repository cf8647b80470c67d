#!/usr/bin/env python3
"""Compare builds of the top-k gate and the row gather on one NVIDIA GPU.

    python3 gate_gather_ab.py A/csrc B/csrc ... [--rounds 5]

Each argument is a directory holding a version of
``src/repro_torch/csrc/topk_gate.cu`` and ``layout_transform.cu``: this
tree's ``src/repro_torch/csrc``, or a parent commit's (``git archive
HEAD~1 src/repro_torch/csrc | tar -x -C build/parent``).  Each version is
built with the flags of ``repro_torch.kernels.build`` into a library of its
own under ``build/gate_gather_ab/``, one ``nvcc`` per file, all at once;
the ptxas lines of the gate and gather kernels are printed (registers,
spills).  Every build's outputs are held against the plain versions
(bitwise; the gate's sumexp within rtol 1e-6).  Then, with the builds
taking turns (A B ..., then ... B A), device-only times from CUDA-graph
replays:

- the gate at (4096, 16) k=1, (8, 16) k=1, (8192, 16) k=4 and (8192, 128)
  k=1, beside ``torch.topk`` and an empty kernel (the launch floor);
- the gather at the paper's M=N=4096 rows of d=2048 (a permutation),
  dbrx's 32,768 rows of d=6144 from 8192 (top-4) in the served
  expert-sorted order and in token-major order (each token's 4 rows
  together), llama4's 8192 of d=5120 from 8192 (top-1, expert-sorted),
  and dbrx's sort dispatch (E·C = 40,960 buffer rows, the empty capacity
  slots zero): L2-warm (replays back to back) and L2-cold (a 128 MB read
  between calls, ``chip_smoke.graph_cold_ms``), beside ``index_select``;
  a build whose library has ``gather_rows_fanout`` also runs its fan-out
  form (each source row read once and written to its destinations).

Prints one line per measurement with the card's name and power limit,
then every number as one JSON object on the last line.  Exits 2 without
a GPU.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

import chip_smoke

ROOT = pathlib.Path(__file__).resolve().parent
FILES = ("topk_gate.cu", "layout_transform.cu")
FANOUT = "gather_rows_fanout"
PTXAS_KERNELS = ("topk_gate", "gather_rows_kernel", "gather_fanout")


def build_one(build, i: int, csrc: pathlib.Path):
    """(library, whether it has the fan-out form, ptxas report lines)."""
    out = ROOT / "build" / "gate_gather_ab"
    out.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for name in FILES:
        obj = out / f"lib{i}.{name}.o"
        objs.append(str(obj))
        procs.append(subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-c", str(csrc / name), "-o",
             str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    report = []
    for name, p in zip(FILES, procs):
        text, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {csrc / name}:\n{text}")
        lines = text.splitlines()
        for j, line in enumerate(lines):
            if "Compiling entry" in line and any(k in line for k in
                                                 PTXAS_KERNELS):
                used = next((x.strip() for x in lines[j + 1:j + 4]
                             if "Used" in x), "")
                spill = next((x.strip() for x in lines[j + 1:j + 4]
                              if "spill" in x), "")
                report.append(f"{line.split(chr(39))[1][:90]}: {used}; "
                              f"{spill}")
    so = out / f"lib{i}.so"
    r = subprocess.run([build._nvcc(), "-shared", "-o", str(so), *objs],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if r.returncode:
        raise RuntimeError(f"link failed for {csrc}:\n{r.stdout}")
    lib = ctypes.CDLL(str(so))
    names = ["topk_gate_f32", "launch_empty", "gather_rows"]
    fanout = hasattr(lib, FANOUT)
    if fanout:
        names.append(FANOUT)
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = list(build.SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib, fanout, report


def token_major_maps(torch, S: int, K: int):
    """Each token's K rows side by side: idx = arange(S) repeated K times."""
    idx = torch.arange(S, dtype=torch.int32).repeat_interleave(K)
    return idx, torch.arange(S * K, dtype=torch.int32).reshape(S, K)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("csrc", nargs="+", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gate_gather_ab: no GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import layout_transform as L
    from repro_torch.kernels import topk_gate as K
    smi = chip_smoke.smi_line()
    print(f"[{smi}] torch {torch.__version__} CUDA {torch.version.cuda}")
    with concurrent.futures.ThreadPoolExecutor(len(args.csrc)) as ex:
        built = list(ex.map(lambda a: build_one(build, *a),
                            enumerate(args.csrc)))
    names = [f"{i}:{c}" for i, c in enumerate(args.csrc)]
    for name, (_, fanout, report) in zip(names, built):
        print(f"== {name} (fan-out form: {fanout})")
        for line in report:
            print(f"   {line}")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(19)

    def stream():
        # the current stream at each call: graph capture runs on its own
        return build.stream(torch.empty(0, device=dev))

    def gate(i, x, k):
        S, E = x.shape
        outs = (torch.empty((S, k), device=dev),
                torch.empty((S, k), dtype=torch.int32, device=dev),
                torch.empty((S, 1), device=dev),
                torch.empty((S, 1), device=dev))
        rc = built[i][0].topk_gate_f32(build.ptr(x), *map(build.ptr, outs),
                                       S, E, k, stream())
        if rc:
            raise RuntimeError(f"{names[i]} topk_gate: CUDA error {rc}")
        return outs

    def gather(i, src, idx):
        out = torch.empty((idx.shape[0], src.shape[1]), dtype=src.dtype,
                          device=dev)
        rc = built[i][0].gather_rows(build.ptr(src), build.ptr(idx),
                                     build.ptr(out), src.shape[0],
                                     idx.shape[0],
                                     src.shape[1] * src.element_size(),
                                     stream())
        if rc:
            raise RuntimeError(f"{names[i]} gather_rows: CUDA error {rc}")
        return out

    def fanout(i, src, idx, dest):
        out = torch.empty((idx.shape[0], src.shape[1]), dtype=src.dtype,
                          device=dev)
        rc = built[i][0].gather_rows_fanout(
            build.ptr(src), build.ptr(idx), build.ptr(dest), build.ptr(out),
            src.shape[0], idx.shape[0], dest.shape[1],
            src.shape[1] * src.element_size(), stream())
        if rc:
            raise RuntimeError(f"{names[i]} {FANOUT}: CUDA error {rc}")
        return out

    # (label, callable, bytes moved at one read of each input byte and
    # one write of each output byte or None, whether to time it L2-cold)
    cells = []
    checks = []
    for label, S, E, k in (("paper prefill (4096, 16) k=1", 4096, 16, 1),
                           ("paper decode (8, 16) k=1", 8, 16, 1),
                           ("dbrx prefill (8192, 16) k=4", 8192, 16, 4),
                           ("llama4 prefill (8192, 128) k=1", 8192, 128, 1)):
        x = torch.randn(S, E, generator=g).to(dev)
        nbytes = S * E * 4 + S * k * 8 + S * 8
        want = K.topk_gate_plain(x, k)
        for i in range(len(built)):
            got = gate(i, x, k)
            rel = ((got[3] - want[3]).abs() / want[3].abs()).max().item()
            checks.append((f"gate {label} {names[i]}",
                           all(torch.equal(a, b) for a, b in
                               zip(got[:3], want[:3])) and rel <= 1e-6))
            cells.append((f"gate {label} {names[i]}",
                          lambda i=i, x=x, k=k: gate(i, x, k), nbytes, False))
        cells.append((f"gate {label} torch.topk",
                      lambda x=x, k=k: torch.topk(x, k, dim=-1), nbytes,
                      False))
    ties = torch.randint(0, 3, (4096, 16), generator=g).float().to(dev)
    for i in range(len(built)):
        got, want = gate(i, ties, 4), K.topk_gate_plain(ties, 4)
        checks.append((f"gate exact ties (4096, 16) k=4 {names[i]}",
                       all(torch.equal(a, b) for a, b in
                           zip(got[:3], want[:3]))))

    def empty(i):
        rc = built[i][0].launch_empty(stream())
        if rc:
            raise RuntimeError(f"{names[i]} launch_empty: CUDA error {rc}")
    for i in range(len(built)):
        cells.append((f"launch floor (empty kernel) {names[i]}",
                      lambda i=i: empty(i), None, False))

    from repro_torch import configs
    from repro_torch.core import capacity
    maps = chip_smoke.routed_maps
    C = capacity.expert_capacity(configs.get_config("dbrx-132b").moe, 8192,
                                 16)
    gathers = (
        ("paper M=N=4096 d=2048 (permutation)", 4096, 2048,
         maps(torch, g, 4096, 16, 1, "grouped")),
        ("dbrx 32768 rows of d=6144 from 8192, expert-sorted", 8192, 6144,
         maps(torch, g, 8192, 16, 4, "grouped")),
        ("dbrx 32768 rows of d=6144 from 8192, token-major", 8192, 6144,
         token_major_maps(torch, 8192, 4)),
        ("llama4 8192 rows of d=5120 from 8192, expert-sorted", 8192, 5120,
         maps(torch, g, 8192, 128, 1, "grouped")),
        (f"dbrx sort dispatch, E*C={16 * C} rows (C={C}) of d=6144 from "
         f"8192", 8192, 6144, maps(torch, g, 8192, 16, 4, "sort", C)))
    for label, N, d, (idx, dest) in gathers:
        src = torch.randn(N, d, generator=g).to(torch.bfloat16).to(dev)
        idx, dest = idx.to(dev), dest.to(dev)
        M = idx.shape[0]
        nbytes = N * d * 2 + M * 4 + M * d * 2
        want = L.gather_rows_plain(src, idx)
        clamped = idx.clamp(min=0)
        for i in range(len(built)):
            checks.append((f"gather {label} {names[i]}",
                           torch.equal(gather(i, src, idx), want)))
            cells.append((f"gather {label} {names[i]}",
                          lambda i=i, s=src, x=idx: gather(i, s, x), nbytes,
                          True))
            if built[i][1]:
                checks.append((f"fan-out {label} {names[i]}", torch.equal(
                    fanout(i, src, idx, dest), want)))
                cells.append((f"fan-out {label} {names[i]}",
                              lambda i=i, s=src, x=idx, t=dest:
                              fanout(i, s, x, t),
                              nbytes + dest.numel() * 4, True))
        cells.append((f"gather {label} index_select",
                      lambda s=src, x=clamped: torch.index_select(s, 0, x),
                      nbytes, True))
    torch.cuda.synchronize()
    for what, ok in checks:
        print(f"  check {what}: {'ok' if ok else 'DIFFERS'}")
    flush = chip_smoke.l2_flush(torch)
    warm = {c[0]: [] for c in cells}
    cold = {c[0]: [] for c in cells if c[3]}
    for r in range(args.rounds):
        order = cells if r % 2 == 0 else cells[::-1]
        for label, fn, _, is_cold in order:
            warm[label].append(chip_smoke.graph_ms(torch, fn, reps=15))
            if is_cold:
                cold[label].append(chip_smoke.graph_cold_ms(
                    torch, fn, flush, reps=15))
    print(f"[{smi}] device-only ms per call, median over {args.rounds} "
          f"rounds (quartiles); bound = bytes / "
          f"{chip_smoke.HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    result = dict(smi=smi, rounds=args.rounds, builds=names, cells=[])
    for label, _, nbytes, _ in cells:
        row = dict(label=label, bytes=nbytes)
        bound = None if nbytes is None else (
            1e3 * nbytes / chip_smoke.HBM_BYTES_PER_S)
        row["bound_ms"] = bound
        text = []
        for kind, table in (("warm", warm), ("cold", cold)):
            xs = table.get(label)
            if not xs:
                continue
            med = statistics.median(xs)
            q1, _, q3 = statistics.quantiles(xs, n=4) if len(xs) > 1 \
                else (med, med, med)
            row[kind] = dict(median=med, q1=q1, q3=q3, all=xs)
            share = "" if bound is None else f", {100 * bound / med:.1f}% " \
                f"of bound"
            text.append(f"{kind} {med:.4f} ({q1:.4f}-{q3:.4f}{share})")
        print(f"  {label}: {'; '.join(text)}"
              + ("" if bound is None else f"; bound {bound:.4f}"))
        result["cells"].append(row)
    result["checks"] = [dict(what=w, ok=ok) for w, ok in checks]
    print(json.dumps(result))
    bad = [w for w, ok in checks if not ok]
    if bad:
        print(f"FAILED checks: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
