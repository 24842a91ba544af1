"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together), linked into one shared library
with a plain C interface, and loaded with ``ctypes``.  The library lives
under ``build/repro_torch_kernels/<digest>/`` at the repository root, keyed
by a hash of the sources and flags, so an unchanged tree builds once.

There is no fallback: without ``nvcc`` the build raises.  Nothing here runs
at import time — the first kernel launch builds and loads the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parents[3] / "build"
              / "repro_torch_kernels")
LIB_NAME = "librepro_torch_kernels.so"
DEFAULT_NVCC = pathlib.Path("/usr/local/cuda/bin/nvcc")   # toolkit default
GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = GENCODE + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                   "-Xptxas=-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
# C signature of every exported launcher: pointers and the stream as
# c_void_p (a bare Python int would be cut to 32 bits), sizes as c_int (or
# an array of them), strides as c_longlong, scales as c_float.
SIGNATURES = {
    "repro_shift_conv2d": [_P] * 3 + [ctypes.POINTER(_I), _P],
    "repro_ddmm": [_P] * 5 + [ctypes.POINTER(_I), _P],
    "repro_ell_spdmm": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "repro_ell_spdmm_rows": [_P] * 4 + [_I] * 5 + [_P],
    "repro_knn": [_P, _P, _P, _I, _I, _I, _I, _P],
    "repro_knn_max_k": [],
    "repro_sddmm": [_P] * 4 + [_I] * 7 + [_P],
    "repro_sddmm_block": [],
    "repro_flash_attention": [_P] * 4 + [_I] * 8 + [_F] + [_L] * 12 + [_P],
    "repro_flash_max_d": [],
}

_LIB: ctypes.CDLL | None = None


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "cannot be built and have no fallback")


def _digest(sources: list[pathlib.Path]) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the sources (if this digest is not built yet) and return the
    shared library's path.  ``build.log`` beside it holds ``nvcc``'s output
    (``-Xptxas=-v``: registers and shared memory per kernel)."""
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    out_dir = BUILD_ROOT / _digest(sources)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    tmp = out_dir / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        units = [s for s in sources if s.suffix == ".cu"]
        procs = [(s, subprocess.Popen(
            [nvcc, *FLAGS, "-I", str(CSRC), "-c", str(s),
             "-o", str(tmp / f"{s.stem}.o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for s in units]
        log = []
        for src, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        link = subprocess.run(
            [nvcc, *GENCODE, "-shared", "-o", str(tmp / LIB_NAME),
             *(str(tmp / f"{s.stem}.o") for s in units)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        (out_dir / "build.log").write_text("\n".join(log))
        os.replace(tmp / LIB_NAME, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(err: int, name: str) -> None:
    """Raise if a launcher reported a nonzero ``cudaGetLastError()``."""
    if err != 0:
        msg = library().repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as a C pointer: the raw
    handle, without building a ``torch.cuda.Stream`` object each call."""
    return ctypes.c_void_p(
        torch._C._cuda_getCurrentRawStream(t.get_device()))


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def require_cuda(name: str, *tensors, dtypes) -> None:
    """Validate what a launcher takes: one CUDA device, the given dtypes,
    contiguous memory."""
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t is None:
            continue
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: every operand must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.numel() >= 2**31:
            raise ValueError(f"{name}: operand too large for int32 indexing")
