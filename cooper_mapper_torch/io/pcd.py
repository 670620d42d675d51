"""Minimal PCD (Point Cloud Data) file I/O (a copy of
``cooper_mapper_tpu/io/pcd.py``: numpy only, byte-equal files).

The reference persists everything as PCL .pcd files (map cubes
FeatureMap.h:378-462, trajectory clouds graph.h:60-93, keyframe dumps
keyframe.cpp:21-31).  This is a dependency-free reader/writer for the
PCD v0.7 subset used there: x/y/z(+intensity) fields, ascii or binary.
"""

from __future__ import annotations

import numpy as np


def write_pcd(path: str, xyz: np.ndarray, intensity: np.ndarray | None = None,
              binary: bool = True) -> None:
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = len(xyz)
    fields = ["x", "y", "z"]
    data = [xyz]
    if intensity is not None:
        fields.append("intensity")
        data.append(np.asarray(intensity, np.float32).reshape(-1, 1))
    arr = np.concatenate(data, axis=1).astype(np.float32)

    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(['4'] * len(fields))}\n"
        f"TYPE {' '.join(['F'] * len(fields))}\n"
        f"COUNT {' '.join(['1'] * len(fields))}\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(arr.tobytes())
        else:
            np.savetxt(f, arr, fmt="%.6f")


def read_pcd(path: str):
    """Returns (xyz [N,3], intensity [N] or None)."""
    with open(path, "rb") as f:
        raw = f.read()
    # parse header line by line
    lines = []
    pos = 0
    while True:
        nl = raw.index(b"\n", pos)
        line = raw[pos:nl].decode()
        pos = nl + 1
        lines.append(line)
        if line.startswith("DATA"):
            break
    meta = {}
    for line in lines:
        parts = line.split()
        if parts:
            meta[parts[0]] = parts[1:]
    fields = meta.get("FIELDS", ["x", "y", "z"])
    n = int(meta["POINTS"][0])
    mode = meta["DATA"][0]
    k = len(fields)
    if mode == "binary":
        arr = np.frombuffer(raw[pos : pos + 4 * k * n], np.float32).reshape(n, k)
    else:
        arr = np.loadtxt(raw[pos:].decode().splitlines(), np.float32).reshape(n, k)
    cols = {f: arr[:, i] for i, f in enumerate(fields)}
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], -1)
    inten = cols.get("intensity")
    return xyz, inten
