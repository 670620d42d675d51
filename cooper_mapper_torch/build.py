"""Build and load the port's CUDA kernels.

One ``nvcc`` call compiles every ``csrc/*.cu`` for ``sm_90a`` into
``_build/libcooper_kernels.so``, a shared library with a plain C interface
(no PyTorch headers, so the build takes seconds, not minutes), which
``ctypes`` loads.  The build runs at first use, under a file lock, and again
whenever the hash of the sources and the ``csrc/*.cuh`` headers they include
changes.  ``_build/`` is git-ignored.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_NAME = "libcooper_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_seconds: float | None = None   # wall time of this process's build, if it built


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _headers():
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    return h.hexdigest()


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, else PyTorch's idea of CUDA_HOME, else the
    toolkit's default prefix."""
    homes = [os.environ.get("CUDA_HOME")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME
        homes.append(CUDA_HOME)
    except ImportError:
        pass
    homes.append("/usr/local/cuda")
    for home in homes:
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME to a CUDA toolkit (>= 12.0, for sm_90a) "
        "to build cooper_mapper_torch's kernels")


def build() -> str:
    """Compile the kernels if the library is missing or stale; return its path."""
    global build_seconds
    sources = _sources()
    digest = _digest(sources + _headers())
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    stamp = os.path.join(BUILD_DIR, LIB_NAME + ".sha256")
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.isfile(lib_path) and os.path.isfile(stamp):
                with open(stamp) as f:
                    if f.read().strip() == digest:
                        return lib_path
            tmp = lib_path + f".tmp{os.getpid()}"
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds = time.perf_counter() - t0
            with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
                f.write(" ".join(cmd) + "\n" + res.stdout + res.stderr)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}")
            os.replace(tmp, lib_path)
            with open(stamp, "w") as f:
                f.write(digest)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.cooper_nn1.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, P]
        lib.cooper_nn1_block_queries.argtypes = []
        lib.cooper_nn1_masked.argtypes = [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, F, I, I,
                                          P]
        lib.cooper_bc_races.argtypes = [P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, F, I, I,
                                        P]
        lib.cooper_bc_races_block_queries.argtypes = []
        lib.cooper_fused_races.argtypes = [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, F, I, I,
                                           P]
        lib.cooper_fused_block_threads.argtypes = []
        lib.cooper_merge_min.argtypes = [P, P, P, P, LL, I, I, P]
        lib.cooper_knn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P]
        lib.cooper_knn_block_queries.argtypes = [I]
        for fn in (lib.cooper_nn1, lib.cooper_nn1_masked, lib.cooper_bc_races,
                   lib.cooper_fused_races, lib.cooper_fused_block_threads,
                   lib.cooper_merge_min, lib.cooper_knn, lib.cooper_nn1_block_queries,
                   lib.cooper_bc_races_block_queries, lib.cooper_knn_block_queries):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
