"""Build and load the port's CUDA kernels, and count their launches.

Each ``*.cu`` source in this directory is compiled by ``nvcc`` into its own
shared library with a plain C interface, for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), at first use, into
``build/tts_tpu_torch_kernels/`` at the root of the checkout. The file name
carries a hash of the source and the flags, so an edited source is rebuilt.
``build_all`` starts one ``nvcc`` per source at once and waits for them all,
holding a file lock on the build directory so that processes sharing it
(the ranks of a data-parallel run) build each source once.
Libraries are loaded with ``ctypes``; pointers and the stream pass as
``c_void_p``.

``LAUNCHES`` counts, per kernel name, the launches that the wrappers made:
each wrapper adds one where it launches its kernel and nowhere else (a C
entry point that loops over steps adds the number of kernels it launched).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, Optional

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = SOURCE_DIR.parents[2] / "build" / "tts_tpu_torch_kernels"
SOURCES = ("fused_resstack", "fused_melgan", "mas", "stft_mag",
           "grouped_conv_grad", "bilstm", "taco2_decode", "glow_encoder")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Counter = Counter()
# ptxas register/shared-memory report of each build, by source name
BUILD_LOGS: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        LAUNCHES.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    src = (SOURCE_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}_{digest[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Compile every source whose library is missing, all at once; returns
    the seconds taken. Raises with nvcc's output if a build fails."""
    start = time.perf_counter()
    names = list(names)
    if all(library_path(n).exists() for n in names):
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one process compiles at a time (the ranks of a data-parallel
    # run share the build directory); the others find the libraries built
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            _build([n for n in names if not library_path(n).exists()])
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return time.perf_counter() - start


def _build(todo) -> None:
    if not todo:
        return
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def library(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of ``name``.cu, built first if needed.
    ``signatures`` maps each C function to (restype, argtypes)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = list(argtypes)
            lib.kernel_error_string.restype = ctypes.c_char_p
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, kernel: str, err: int, launches: int = 1) -> None:
    """Raise if a launch returned a CUDA error; else count ``launches``
    launches."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: {msg}")
    with _count_lock:
        LAUNCHES[kernel] += launches


def stream_handle(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require_cuda_f32(name: str, t, shape: Optional[tuple] = None) -> None:
    import torch
    if t.device.type != "cuda" or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected a float32 CUDA tensor, got "
                         f"{t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
