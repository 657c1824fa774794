"""Build and load the port's hand-written CUDA kernels.

Every ``kernels/*/csrc/*.cu`` source (plus the shared ``kernels/csrc``) is
compiled by its own ``nvcc`` process, all started together, and the
objects are linked into ``build/kernels/libkernels.so`` at the root of the
checkout, at first use and again whenever a source's hash changes.  The library has a plain C interface and is loaded with
``ctypes``: every pointer and the stream are ``c_void_p``, every C entry
point returns ``cudaGetLastError()`` and :func:`check` raises if that is not
0.  Nothing here runs at import time, so the CPU tests import every module
on a machine with no ``nvcc``.

Launch counts live here too: each kernel wrapper calls :func:`count` once
per launch, so a run can show which kernels its main path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

import torch

_PKG = pathlib.Path(__file__).resolve().parent
_ROOT = _PKG.parent.parent.parent          # src/repro_torch/kernels -> repo
BUILD_DIR = _ROOT / "build" / "kernels"
LIB_NAME = "libkernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

# dtype codes of the C entry points (kernels/csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.uint8: 3, torch.float8_e4m3fn: 4}
FLOAT_TYPES = (torch.float32, torch.bfloat16)

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
# C entry point -> argtypes; every one returns a cudaError_t as int
SIGNATURES = {
    "repro_rmsnorm": [_P, _P, _P, _I, _I, _F, _I, _P],
    "repro_add_rmsnorm": [_P, _LL, _P, _LL, _P, _P, _P, _LL, _I, _F, _I, _P],
    "repro_dequantize_add_rmsnorm": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _F,
                                     _I, _I, _P],
    "repro_flash_prefill": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _I, _F, _I, _P],
    "repro_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _I, _LL, _LL, _LL, _F, _I, _P],
    "repro_paged_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                     _LL, _LL, _LL, _F, _I, _P],
    "repro_chunk_amax": [_P, _P, _LL, _I, _I, _I, _P],
    "repro_chunk_quantize": [_P, _P, _P, _P, _LL, _I, _I, _I, _F, _F, _I,
                             _I, _P],
    "repro_chunk_dequantize": [_P, _P, _P, _LL, _I, _I, _I, _I, _P],
    "repro_nibble_reduce_requant": [_P, _P, _LL, _I, _I, _P],
    "repro_nibble_unpack_dequantize": [_P, _P, _P, _LL, _I, _I, _I, _P],
    "repro_quant_grid": [_P, _I, _LL, _I, _I, _I, _I, _I, _P, _P],
    "repro_wkv6": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _P],
}

LAUNCHES: Dict[str, int] = {"rmsnorm": 0, "add_rms_norm": 0,
                            "dequantize_add_rms_norm": 0,
                            "flash_attention": 0,
                            "decode_attention": 0,
                            "paged_decode_attention": 0, "chunk_amax": 0,
                            "chunk_quantize": 0, "chunk_dequantize": 0,
                            "chunk_quantize_pack": 0,
                            "nibble_reduce_requant": 0,
                            "nibble_unpack_dequantize": 0, "wkv6": 0}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
last_build_seconds: Optional[float] = None


def count(name: str) -> None:
    """Add one launch of kernel ``name`` (called only where it launches)."""
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sources() -> List[pathlib.Path]:
    """Every .cu the library is built from, in a fixed order."""
    return sorted(_PKG.glob("csrc/*.cu")) + sorted(_PKG.glob("*/csrc/*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_PKG.glob("csrc/*")) + sorted(_PKG.glob("*/csrc/*")):
        h.update(path.relative_to(_PKG).as_posix().encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _run_all(cmds, verbose: bool) -> None:
    """Run the commands as processes started together; wait for every one,
    then raise if any failed (with its command and output)."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}\n{err}")
        elif verbose:
            print(err, end="")
    if failed:
        raise RuntimeError("\n".join(failed))


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the library unless a build of the same sources exists: one
    nvcc process per source, in parallel, then one link."""
    global last_build_seconds
    digest = _digest()
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "libkernels.sha256"
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    tmp = BUILD_DIR / f".{LIB_NAME}.{tag}"
    ptxas = ["-Xptxas=-v"] if verbose else []
    objs, compiles = [], []
    for src in sources():
        obj = BUILD_DIR / f".{src.parent.parent.name}_{src.stem}.{tag}.o"
        objs.append(obj)
        compiles.append([_nvcc(), *ptxas, *NVCC_FLAGS, "-I",
                         str(_PKG / "csrc"), "-c", "-o", str(obj), str(src)])
    t0 = time.perf_counter()
    try:
        _run_all(compiles, verbose)
        _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]], False)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, lib)
    stamp.write_text(digest)
    last_build_seconds = time.perf_counter() - t0
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.repro_cuda_error_string.argtypes = [ctypes.c_int]
            handle.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def dtype_code(dtype, allowed=FLOAT_TYPES) -> int:
    """The C code of ``dtype``; raises unless the kernel takes it."""
    if dtype not in allowed:
        names = " or ".join(str(d).replace("torch.", "") for d in allowed)
        raise TypeError(f"this kernel takes {names}, got {dtype}")
    return DTYPE_CODES[dtype]


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(kernel: str, name: str, t, device, dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` on ``device``
    (and of ``shape`` when given) — what the C entry points assume."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} is {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
