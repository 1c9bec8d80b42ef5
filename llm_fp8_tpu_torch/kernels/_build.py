"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and becomes
``_build/lib<name>-<hash>.so``; the hash covers the source, the shared
header and the flags, so a changed source rebuilds. The host C++ libraries
(:data:`HOST_LIBS`: the repo's ``csrc/block_allocator.cpp``, the one source
of the allocator that the JAX package builds too, read only) are built the
same way with ``g++``. Nothing is built when this module is imported: the first use of a
library builds it (:func:`library`), and :func:`build` starts every compiler
at once. A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["KERNELS", "HOST_LIBS", "build", "library", "check"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
_REPO_CSRC = _PKG.parent / "csrc"
BUILD_DIR = _PKG / "_build"
_HEADERS = ("fp8_ftz.cuh", "hopper.cuh", "decode_split.cuh", "dropout.cuh", "tf32x3.cuh")
KERNELS = ("quant_matmul", "decode_attention", "flash_attention", "paged_attention",
           "flash_attention_bwd", "quantize", "flash_attention_fp8", "rmsnorm",
           "flash_attention_f32", "flash_attention_bwd_f32")
#: Host-side C++ libraries (no CUDA) → source, built with g++ and the flags
#: of the repo's ``csrc/Makefile``.
HOST_LIBS = {"block_allocator": _REPO_CSRC / "block_allocator.cpp"}
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_HOST_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: Library → {launcher: its C argument types}; every launcher returns int.
_SIGNATURES = {
    "quant_matmul": {"qmm_launch": [_P] * 4 + [_I] * 8 + [_P],
                     "qmm_prefill_launch": [_P] * 5 + [_I] * 9 + [_P]},
    "decode_attention": {"decode_arena_launch":
                         [_P] * 4 + [_I] + [_P] * 11 + [_I] * 8 + [_F, _I, _F, _P]},
    "flash_attention": {"flash_fwd_launch":
                        [_P] * 10 + [_I] * 6 + [_F, _I, _I, _F, _I, _I, _I, _F, _P]},
    "paged_attention": {"paged_attn_launch": [_P] * 12 + [_I] * 12 + [_F, _F, _I, _F, _P]},
    "flash_attention_bwd": {
        "flash_bwd_dkv_launch": [_P] * 13 + [_I] * 6 + [_F, _I, _I, _F, _I, _I, _I, _F, _P],
        "flash_bwd_dq_launch": [_P] * 13 + [_I] * 6 + [_F, _I, _I, _F, _I, _I, _I, _F, _P]},
    "quantize": {"quantize_launch": [_P] * 3 + [_I] * 7 + [_F, _F, _P]},
    "flash_attention_fp8": {
        "flash_fp8_launch": [_P] * 12 + [_I] * 8 + [_F, _I, _I, _F, _I, _I, _P],
        "flash_fp8_prep_launch": [_P] * 6 + [_I] * 7 + [_P]},
    "rmsnorm": {"rmsnorm_residual_launch": [_P] * 5 + [_I] * 3 + [_F, _P]},
    "flash_attention_f32": {"flash_fwd_f32_launch":
                            [_P] * 8 + [_I] * 6 + [_F, _I, _I, _I, _I, _F, _P]},
    "flash_attention_bwd_f32": {
        "flash_bwd_f32_dq_launch": [_P] * 11 + [_I] * 6 + [_F, _I, _I, _I, _I, _F, _P],
        "flash_bwd_f32_dkv_launch": [_P] * 11 + [_I] * 7 + [_F, _I, _I, _I, _I, _F, _P],
        "flash_bwd_f32_dkv_sum_launch": [_P] * 3 + [_I] * 2 + [_P]},
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME)")


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++")):
        if cand and shutil.which(cand):
            return cand
    raise RuntimeError("g++ not found: the host libraries are built with g++ (set CXX)")


def _sources(name: str):
    if name in HOST_LIBS:
        return _HOST_FLAGS, (HOST_LIBS[name],)
    return _FLAGS, tuple(CSRC / f for f in (f"{name}.cu",) + _HEADERS)


def _target(name: str) -> Path:
    flags, files = _sources(name)
    h = hashlib.sha256(" ".join(flags).encode())
    for f in files:
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> list:
    if name in HOST_LIBS:
        return [_cxx(), *_HOST_FLAGS, "-o", str(out), str(HOST_LIBS[name])]
    return [_nvcc(), *_FLAGS, "-I", str(CSRC), "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Iterable[str] = KERNELS + tuple(HOST_LIBS)) -> Dict[str, float]:
    """Build the named libraries that are not built yet, all compilers in
    parallel. Returns seconds per library built; raises if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = _command(name, tmp)
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a kernel or a host library), built on
    first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        if name not in HOST_LIBS:  # a host library's caller declares its functions
            lib.kernel_error_string.restype = ctypes.c_char_p
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.restype, fn.argtypes = ctypes.c_int, argtypes
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
