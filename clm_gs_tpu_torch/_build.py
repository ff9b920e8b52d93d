"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by nvcc into
``csrc/build/lib<name>.so`` for sm_90a at first use, then loaded with ctypes.
A library is rebuilt when its source (or a shared header) is newer than it.
Pointers and the stream pass as ``c_void_p``; every C entry returns
``cudaGetLastError()`` and ``launch`` raises on a nonzero code.

``LAUNCHES`` counts, per kernel wrapper, the calls that launched its kernel.

The host libraries (``csrc/host/<name>.cpp``: the SIMD host Adam and the
camera-order TSP) are built the same way by ``g++`` with the JAX package's
Makefile flags, need no CUDA, and are loaded by ``host_library``. A failed
build raises; there is no fallback.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = CSRC / "build"
KERNELS = ("fill", "segreduce", "rasterize_fwd", "rasterize_bwd")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
HOST_SRC = CSRC / "host"
HOST_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread"]

LAUNCHES = collections.Counter()
_libs: dict = {}
_lock = threading.Lock()


def reset_launches():
    LAUNCHES.clear()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [Path(CUDA_HOME) / "bin" / "nvcc"] if CUDA_HOME else []
    which = shutil.which("nvcc")
    if which:
        cand.append(Path(which))
    for c in cand:
        if c.exists():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _so(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    so = _so(name)
    if not so.exists():
        return True
    newest = max(
        p.stat().st_mtime for p in [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    )
    return so.stat().st_mtime < newest


def build(names=KERNELS) -> dict:
    """Compile the stale kernels, one nvcc process per source, all started
    together. Returns {name: ptxas report} for the libraries it built."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = BUILD / f"lib{n}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    reports, failed = {}, []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _so(n))
            reports[n] = out
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def build_host(name: str, src_dir: Path = HOST_SRC) -> Path:
    """Compile `src_dir/<name>.cpp` into BUILD/lib<name>.so with g++ unless
    the library is newer than its source; returns the library's path."""
    src, so = src_dir / f"{name}.cpp", BUILD / f"lib{name}.so"
    if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(f"no C++ compiler to build {src}: set CXX or install g++")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = BUILD / f"lib{name}.{os.getpid()}.tmp.so"
    res = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), str(src)],
                         capture_output=True, text=True, check=False)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed for {src}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so


def host_library(name: str) -> ctypes.CDLL:
    """The host library `name`, built if stale, loaded once per process."""
    key = f"host:{name}"
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = _libs[key] = ctypes.CDLL(str(build_host(name)))
        return lib


def _entry(name: str, fn: str, argtypes: list):
    """C entry `fn` of kernel `name`'s library, built if stale; restype is
    the int error code."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_so(name)))
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _libs[name] = lib
        return getattr(lib, fn)


def launch(name: str, fn: str, argtypes: list, device, *args):
    """Call C entry `fn` of kernel `name` on `device` with its current
    stream appended as the last argument; raise on a CUDA error and count
    the launch."""
    import torch

    entry = _entry(name, fn, argtypes)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"CUDA launch of {fn} failed: cudaError {err}")
    LAUNCHES[name] += 1


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require(t, name: str, dtype, shape=None, device=None):
    """Validate a kernel argument: device type, dtype, shape, contiguity."""
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
