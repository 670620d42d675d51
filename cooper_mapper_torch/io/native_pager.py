"""ctypes bindings for the async cube-paging engine (port of
``cooper_mapper_tpu/io/native_pager.py``, over ``native/cube_pager.cpp``).

The reference's DynamicFeatureMap pages cubes synchronously inside the
mapping loop (DynamicFeatureMap.h:504-677: save leaving cubes / load
entering cubes from per-cube PCDs, blocking the solve thread).  The native
pager moves that disk traffic onto a C++ thread pool: ``flush`` is
write-behind (returns immediately), ``prefetch``/``fetch`` overlap N cube
reads.  Files are PCD v0.7 binary, interchangeable with ``io/pcd.py``.

The port compiles its own copy of the library from
``native/cube_pager.cpp`` at first use (``build.host_library``, into the
git-ignored ``_build/``).  ``CubePager.available()`` is False where the
source or a host compiler is missing, and ``maps/dynamic_map.py`` then uses
the synchronous numpy path.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from .. import build

_LIB_NAME = "cube_pager"


def _load():
    """The built library with its signatures set, or None where it cannot be
    built."""
    if not build.host_buildable(_LIB_NAME):
        return None
    lib = build.host_library(_LIB_NAME)
    lib.pager_create.restype = ctypes.c_void_p
    lib.pager_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.pager_destroy.argtypes = [ctypes.c_void_p]
    lib.pager_flush.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.pager_prefetch.restype = ctypes.c_int
    lib.pager_prefetch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.pager_fetch.restype = ctypes.c_int
    lib.pager_fetch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    lib.pager_sync.argtypes = [ctypes.c_void_p]
    return lib


class CubePager:
    """Async per-cube PCD reader/writer over a native thread pool."""

    def __init__(self, directory: str, n_threads: int = 4):
        lib = _load()
        if lib is None:
            raise RuntimeError("libcube_pager.so cannot be built: native/cube_pager.cpp or a "
                               "host C++ compiler is missing")
        self._lib = lib
        self._h = lib.pager_create(directory.encode(), n_threads)

    @staticmethod
    def available() -> bool:
        return _load() is not None

    def flush(self, type_id: int, key: Tuple[int, int, int],
              xyz: np.ndarray) -> None:
        """Write-behind save of one cube's points (data copied natively)."""
        pts = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
        self._lib.pager_flush(
            self._h, type_id, key[0], key[1], key[2],
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pts),
        )

    def prefetch(self, type_id: int, key: Tuple[int, int, int]) -> int:
        """Enqueue an async read of one cube; returns a ticket for fetch()."""
        return self._lib.pager_prefetch(
            self._h, type_id, key[0], key[1], key[2]
        )

    def fetch(self, ticket: int, capacity: int) -> np.ndarray:
        """Block on a prefetch ticket; returns up to capacity points [M,3]."""
        out = np.empty((capacity, 3), np.float32)
        n = self._lib.pager_fetch(
            self._h, ticket,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), capacity,
        )
        if n < 0:
            raise KeyError(f"bad pager ticket {ticket}")
        return out[: min(n, capacity)]

    def sync(self) -> None:
        """Barrier: all pending flushes/prefetches are on disk / in memory."""
        self._lib.pager_sync(self._h)

    def close(self) -> None:
        if self._h is not None:
            self._lib.pager_sync(self._h)
            self._lib.pager_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - interpreter-shutdown best effort
        try:
            self.close()
        except Exception:
            pass
