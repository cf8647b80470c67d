"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a`` (Hopper; ``-gencode arch=compute_90a,code=sm_90a -std=c++17
-O3 -Xcompiler -fPIC``) — ``flash_attention.cu``, whose 60 bf16 instances
were the build's long pole, by ``FLASH_PARTS`` of them, one part of its
head dims each (``-DFA_PART=p``) — and the objects are linked with
``-shared`` into one
library with a plain C interface under ``build/repro_torch/`` at the repo
root (``.gitignore`` lists it).  The library's name carries a hash of the
sources, the headers beside them (``csrc/*.cuh``) and the flags, so an
edited source builds anew at first use and an unchanged one is loaded as
it is.  It is bound with ``ctypes``: every
pointer and the stream are ``c_void_p``; every entry point returns
``cudaGetLastError()`` and :func:`check` raises when that is not 0.

Nothing here runs at import: the CPU tests import every module, and no
``nvcc`` is needed until a kernel is launched on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Optional

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("topk_gate.cu", "layout_transform.cu", "grouped_ffn.cu",
           "flash_attention.cu")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flash_attention.cu is compiled in this many parts (its FA_PART; the
# source's fa_part_of assigns the head dims to them)
FLASH_PARTS = 5

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# B, H, KV, Sq, Sk, d, then scale, causal, window, use_window, cap, use_cap
_FLASH = (_I,) * 6 + (_F, _I, _I, _I, _F, _I, _P)
SIGNATURES = {
    "topk_gate_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "launch_empty": (_P,),
    "gather_rows": (_P, _P, _P, _LL, _LL, _LL, _P),
    "gather_rows_fanout": (_P, _P, _P, _P, _LL, _LL, _I, _LL, _P),
    "gather_rows_rowstep": (_P, _P, _P, _LL, _LL, _LL, _I, _P),
    # then rhs's expert and row strides
    "grouped_matmul_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _P),
    "grouped_matmul_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _P),
    "grouped_matmul_t_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _P),
    "grouped_matmul_t_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _P),
    "grouped_drhs_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "grouped_drhs_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "scatter_add_rows": (_P,) * 6 + (_LL, _LL, _LL, _I, _P),
    "flash_fwd_bf16": (_P,) * 7 + _FLASH,
    "flash_fwd_f32": (_P,) * 7 + _FLASH,
    "flash_dq_bf16": (_P,) * 9 + _FLASH,
    "flash_dq_f32": (_P,) * 9 + _FLASH,
    "flash_dkv_bf16": (_P,) * 11 + _FLASH,
    "flash_dkv_f32": (_P,) * 11 + _FLASH,
}

_LIB: Optional[ctypes.CDLL] = None
# what the last build in this process did: seconds and the ptxas report
# (registers, shared memory, spills per kernel); empty when the library
# was already built
build_info: dict = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, "
            "/usr/local/cuda and PATH): the CUDA kernels cannot be built")
    return found


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode()
                       + f" flash parts {FLASH_PARTS}".encode())
    headers = sorted(p.name for p in CSRC.glob("*.cuh"))
    for name in (*SOURCES, *headers):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def _compile(so: pathlib.Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{so.stem}.{os.getpid()}"
    jobs = [(name, ()) for name in SOURCES if name != "flash_attention.cu"]
    jobs += [(f"flash_attention.cu part {p}", (f"-DFA_PART={p}",))
             for p in range(FLASH_PARTS)]
    procs = []
    for i, (label, defs) in enumerate(jobs):
        obj = BUILD_DIR / f"{tag}.{i}.o"
        cmd = [nvcc, *NVCC_FLAGS, *defs, "-c",
               str(CSRC / label.split()[0]), "-o", str(obj)]
        procs.append((label, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    reports, failed, done = [], [], {}
    while len(done) < len(procs):          # each job's seconds to its end
        for label, _, p in procs:
            if label not in done and p.poll() is not None:
                done[label] = time.perf_counter() - t0
        time.sleep(0.05)
    for label, _, p in procs:
        out, _ = p.communicate()
        reports.append(f"== {label} ({done[label]:.1f} s)\n{out}")
        if p.returncode:
            failed.append(f"nvcc failed on {label} (exit {p.returncode}):"
                          f"\n{out}")
    objs = [obj for _, obj, _ in procs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = BUILD_DIR / f"{tag}.so.tmp"
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):"
                               f"\n{link.stdout}")
        os.replace(tmp, so)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_info.update(seconds=time.perf_counter() - t0,
                      ptxas="\n".join(reports), library=str(so))


def load() -> ctypes.CDLL:
    """The kernel library, built first if its sources changed."""
    global _LIB
    if _LIB is None:
        so = library_path()
        if not so.exists():
            _compile(so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(rc: int, kernel: str) -> None:
    """Raise if a launch was refused (the C entry point's return code)."""
    if rc != 0:
        msg = load().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def reject_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """For a kernel with no backward (the gate's top-k selection, whose
    gradient the reference stops): refuse a call that autograd would
    differentiate, rather than return a wrong gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel} has no backward: the reference stops the gradient "
            f"at its input (pass a detached tensor)")


def dispatch_device(kernel: str, t: torch.Tensor) -> bool:
    """True to launch the CUDA kernel, False for the plain version — which
    only a CPU tensor gets.  Any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{kernel}: unsupported device {t.device}")
