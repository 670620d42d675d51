"""ctypes bindings for the native sweep organizer (port of
``cooper_mapper_tpu/io/native_binner.py``, over ``native/sweep_binner.cpp``).

The C++/OpenMP binner keeps host-side ingest off the critical path when
feeding the device at sensor rate x batch.  The port compiles its own copy
of the library from ``native/sweep_binner.cpp`` at first use
(``build.host_library``, into the git-ignored ``_build/``), without the
prebuilt ``native/libsweep_binner.so``'s ``-march=native``.
``available()`` is False where the source or a host compiler is missing;
``models/scan_registration.organize_unordered`` is the numpy organizer.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import build

_LIB_NAME = "sweep_binner"


def _load():
    """The built library with its signatures set, or None where it cannot be
    built."""
    if not build.host_buildable(_LIB_NAME):
        return None
    lib = build.host_library(_LIB_NAME)
    F, I = ctypes.c_float, ctypes.c_int
    PF, PU = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)
    out = [PF, PU, PF]                            # xyz, mask, rel
    lib.bin_sweep.argtypes = [PF, I, I, I, I, F, F, F, F, F, *out]
    lib.bin_sweep_batch.argtypes = [PF, I, I, I, I, I, F, F, F, F, F, *out]
    lib.bin_sweep_table.argtypes = [PF, I, I, I, I, PF, F, F, F, *out]
    lib.bin_sweep_table_batch.argtypes = [PF, I, I, I, I, I, PF, F, F, F, *out]
    for name in ("bin_sweep", "bin_sweep_batch", "bin_sweep_table", "bin_sweep_table_batch"):
        getattr(lib, name).restype = I
    return lib


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("libsweep_binner.so cannot be built: native/sweep_binner.cpp or "
                           "a host C++ compiler is missing")
    return lib


def available() -> bool:
    return _load() is not None


def bin_sweep_native(
    points: np.ndarray,
    n_rings: int,
    width: int,
    lower_deg: float = -15.0,
    upper_deg: float = 15.0,
    min_range: float = 0.5,
    max_range: float = 150.0,
    axis_remap: bool = True,
    sentinel: float = 1.0e6,
):
    """Organize one raw sweep.  Returns (xyz [R,W,3], mask [R,W], rel [R,W])."""
    lib = _require()
    pts = np.ascontiguousarray(points, np.float32)
    n = len(pts)
    xyz = np.empty((n_rings, width, 3), np.float32)
    mask = np.empty((n_rings, width), np.uint8)
    rel = np.empty((n_rings, width), np.float32)
    lib.bin_sweep(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int(n),
        ctypes.c_int(1 if axis_remap else 0),
        ctypes.c_int(n_rings),
        ctypes.c_int(width),
        ctypes.c_float(lower_deg),
        ctypes.c_float(upper_deg),
        ctypes.c_float(min_range),
        ctypes.c_float(max_range),
        ctypes.c_float(sentinel),
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        rel.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return xyz, mask.astype(bool), rel


def bin_sweep_batch_native(points: np.ndarray, n_rings: int, width: int, **kw):
    """points: [B, N, 3].  Returns stacked (xyz, mask, rel)."""
    lib = _require()
    pts = np.ascontiguousarray(points, np.float32)
    b, n = pts.shape[:2]
    xyz = np.empty((b, n_rings, width, 3), np.float32)
    mask = np.empty((b, n_rings, width), np.uint8)
    rel = np.empty((b, n_rings, width), np.float32)
    lib.bin_sweep_batch(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int(b),
        ctypes.c_int(n),
        ctypes.c_int(1 if kw.get("axis_remap", True) else 0),
        ctypes.c_int(n_rings),
        ctypes.c_int(width),
        ctypes.c_float(kw.get("lower_deg", -15.0)),
        ctypes.c_float(kw.get("upper_deg", 15.0)),
        ctypes.c_float(kw.get("min_range", 0.5)),
        ctypes.c_float(kw.get("max_range", 150.0)),
        ctypes.c_float(kw.get("sentinel", 1.0e6)),
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        rel.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return xyz, mask.astype(bool), rel


def table_supported() -> bool:
    """Whether ``bin_sweep_table_native`` runs: the port's build always
    carries the table binner, so wherever the library builds."""
    return available()


def bin_sweep_table_native(
    points: np.ndarray,
    table_deg: np.ndarray,
    width: int,
    min_range: float = 0.5,
    max_range: float = 150.0,
    axis_remap: bool = True,
    sentinel: float = 1.0e6,
):
    """Organize one raw sweep with a vendor elevation table (ring = nearest
    channel angle, the Pandar40 mapper — lidar_type.h:13-72).  ``table_deg``
    must be ascending; its length is the ring count."""
    lib = _require()
    pts = np.ascontiguousarray(points, np.float32)
    table = np.ascontiguousarray(table_deg, np.float32)
    n_rings = len(table)
    n = len(pts)
    xyz = np.empty((n_rings, width, 3), np.float32)
    mask = np.empty((n_rings, width), np.uint8)
    rel = np.empty((n_rings, width), np.float32)
    lib.bin_sweep_table(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int(n),
        ctypes.c_int(1 if axis_remap else 0),
        ctypes.c_int(n_rings),
        ctypes.c_int(width),
        table.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_float(min_range),
        ctypes.c_float(max_range),
        ctypes.c_float(sentinel),
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        rel.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return xyz, mask.astype(bool), rel
