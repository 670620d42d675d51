"""Build and load the port's CUDA kernels and its native host libraries.

One ``nvcc`` process per ``csrc/*.cu``, all started together, compiles
each source for ``sm_90a`` into an object, and one more links them into
``_build/libcooper_kernels.so``, a shared library with a plain C interface
(no PyTorch headers, so the build takes seconds, not minutes), which
``ctypes`` loads.

The host libraries (the sweep binner and the cube pager of ``native/``) are
compiled the same way, one ``g++`` call each, into ``_build/lib<name>.so``,
with ``native/Makefile``'s flags but for ``-march=native``: the prebuilt
``native/*.so`` use the instructions of the machine that built them
(AVX-512 in the binner), which another host's CPU may lack.  The binner's
OpenMP loops are built with ``-fopenmp`` where the compiler has OpenMP's
runtime, and serially (its ``#ifdef _OPENMP`` path) where it has not; the
pager uses threads of its own, not OpenMP.  The build's log ends with the
command that built the library.

Every build runs at first use, under one file lock, and again whenever the
hash of its flags and sources (the ``csrc/*.cuh`` headers included)
changes.  ``_build/`` is git-ignored.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
NATIVE = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_NAME = "libcooper_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# native/Makefile's CXXFLAGS without -march=native, and each library's own flags
HOST_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]
HOST_LIBS = {"sweep_binner": ["-fopenmp"], "cube_pager": ["-lpthread"]}
# flags dropped, in a second attempt, where the compiler rejects them
HOST_OPTIONAL = ("-fopenmp",)

_lib = None
_host_libs: dict = {}
build_seconds: float | None = None   # wall time of this process's build, if it built


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _headers():
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def _digest(sources, flags=NVCC_FLAGS) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
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


def find_cxx() -> str | None:
    """The host C++ compiler: $CXX, else g++ on the PATH (the compiler that
    nvcc drives too); None when there is none."""
    return shutil.which(os.environ.get("CXX") or "g++")


def _run_all(cmds):
    """Run the commands at once; (joined command + output, return code) of each."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    return [(" ".join(c) + "\n" + p.communicate()[0], p.returncode)
            for c, p in zip(cmds, procs)]


def _nvcc_steps(out):
    """The kernel library's build: every source compiled at once into an
    object in ``_build/``, then the objects linked into ``out``."""
    nvcc, sources = find_nvcc(), _sources()
    objs = [os.path.join(BUILD_DIR, os.path.basename(src) + ".o") for src in sources]
    return [[[nvcc, *NVCC_FLAGS, "-c", "-o", o, src] for o, src in zip(objs, sources)],
            [[nvcc, *NVCC_FLAGS, "-shared", "-o", out, *objs]]]


def _build_locked(lib_name: str, digest: str, cmds_for, log_name: str):
    """Unless ``_build/lib_name`` is stamped with ``digest``, run the compile
    commands ``cmd_for(out_path)`` of ``cmds_for`` under the build lock, in
    order, until one succeeds.  A command may also be a list of steps, each
    a list of commands run at once, the next step only after every command
    of the one before succeeded.  Returns (the library's path, the compile's
    seconds or None when nothing was built)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, lib_name)
    stamp = lib_path + ".sha256"
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.isfile(lib_path) and os.path.isfile(stamp):
                with open(stamp) as f:
                    if f.read().strip() == digest:
                        return lib_path, None
            tmp = lib_path + f".tmp{os.getpid()}"
            log = []
            t0 = time.perf_counter()
            for cmd_for in cmds_for:
                cmd = cmd_for(tmp)
                steps = cmd if isinstance(cmd[0], list) else [[cmd]]
                for step in steps:
                    done = _run_all(step)
                    log += [text for text, _ in done]
                    rc = next((code for _, code in done if code != 0), 0)
                    if rc != 0:
                        break
                if rc == 0:
                    break
            seconds = time.perf_counter() - t0
            last = " && ".join(" ".join(c) for step in steps for c in step)
            with open(os.path.join(BUILD_DIR, log_name), "w") as f:
                f.write("\n".join(log))
                if rc == 0:
                    f.write("built with: " + last + "\n")
            if rc != 0:
                raise RuntimeError(f"{os.path.basename(steps[0][0][0])} failed ({rc}):\n"
                                   + "\n".join(log))
            os.replace(tmp, lib_path)
            with open(stamp, "w") as f:
                f.write(digest)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib_path, seconds


def build() -> str:
    """Compile the kernels if the library is missing or stale; return its path."""
    global build_seconds
    sources = _sources()
    path, seconds = _build_locked(LIB_NAME, _digest(sources + _headers()), [_nvcc_steps],
                                  "build.log")
    if seconds is not None:
        build_seconds = seconds
    return path


def host_buildable(name: str) -> bool:
    """Whether ``native/<name>.cpp`` and a host compiler exist, so that
    ``host_library(name)`` can build it."""
    return os.path.isfile(os.path.join(NATIVE, f"{name}.cpp")) and find_cxx() is not None


def host_library(name: str) -> ctypes.CDLL:
    """The native host library ``name`` ("sweep_binner" or "cube_pager"),
    compiled from ``native/<name>.cpp`` into ``_build/lib<name>.so`` first
    if it is missing or stale.  Raises if the source or the compiler is
    missing, or the build fails."""
    if name not in _host_libs:
        if not host_buildable(name):
            raise RuntimeError(f"cannot build lib{name}.so: native/{name}.cpp or a host C++ "
                               "compiler (g++, or $CXX) is missing")
        src = os.path.join(NATIVE, f"{name}.cpp")
        full = HOST_LIBS[name]
        bare = [f for f in full if f not in HOST_OPTIONAL]
        cmds = [lambda out, flags=flags: [find_cxx(), *HOST_FLAGS, "-o", out, src, *flags]
                for flags in ([full, bare] if bare != full else [full])]
        path, _ = _build_locked(f"lib{name}.so", _digest([src], HOST_FLAGS + full), cmds,
                                f"lib{name}.log")
        _host_libs[name] = ctypes.CDLL(path)
    return _host_libs[name]


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lists = [P] * 4   # q_list, q_count, r_list, r_count
        lib.cooper_nn1.argtypes = [P] * 3 + lists + [P] * 4 + [I] * 6 + [P]
        lib.cooper_nn1_block_queries.argtypes = []
        lib.cooper_nn1_whole_block_queries.argtypes = []
        lib.cooper_nn1_masked.argtypes = [P] * 6 + lists + [P] * 4 + [I] * 5 + [F, I, I, P]
        lib.cooper_bc_races.argtypes = [P] * 6 + lists + [P] * 6 + [I] * 4 + [F, I, I, P]
        lib.cooper_bc_races_block_queries.argtypes = []
        lib.cooper_fused_races.argtypes = [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, F, I, I,
                                           P]
        lib.cooper_fused_block_threads.argtypes = []
        lib.cooper_merge_min.argtypes = [P, P, P, P, LL, I, I, P]
        lib.cooper_knn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P]
        lib.cooper_knn_block_queries.argtypes = [I]
        lib.cooper_knn_register_max_k.argtypes = []
        lib.cooper_merge_first_k.argtypes = [P, P, P, P, LL, I, I, P]
        lib.cooper_knn_select.argtypes = [P, P, P, P, P, P, I, I, I, I, I, LL, I, P]
        lib.cooper_knn_select_warp_max_k.argtypes = []
        lib.cooper_knn_select_keys.argtypes = [I]
        lib.cooper_knn_select_smem_keys.argtypes = []
        for fn in (lib.cooper_nn1, lib.cooper_nn1_masked, lib.cooper_bc_races,
                   lib.cooper_fused_races, lib.cooper_fused_block_threads,
                   lib.cooper_merge_min, lib.cooper_knn, lib.cooper_nn1_block_queries,
                   lib.cooper_nn1_whole_block_queries,
                   lib.cooper_bc_races_block_queries, lib.cooper_knn_block_queries,
                   lib.cooper_knn_register_max_k, lib.cooper_merge_first_k,
                   lib.cooper_knn_select, lib.cooper_knn_select_warp_max_k,
                   lib.cooper_knn_select_keys, lib.cooper_knn_select_smem_keys):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
