"""Pure-Python rosbag v1 (format V2.0) reader + NPZ converter (port of
``cooper_mapper_tpu/io/rosbag.py``: numpy, ``bz2`` and ``struct`` only,
copied as it is).

The reference's entire integration story is bag replay: the launch topology
subscribes the pipeline to ``/multi_scan_points`` and ``/imu/data``
(L_SLAM/launch/node/lidar_mapping.launch:13-44) and the
front end explicitly tolerates bag-replay time delays
(L_SLAM/src/odometry/OrganizedScanRegistration.cpp:85-90).
This module opens those recorded workloads without ROS: a sequential record
parser for the V2.0 container (chunks, connections, message data), hand-rolled
deserializers for the three message types the pipeline consumes
(``sensor_msgs/PointCloud2``, ``sensor_msgs/Imu``, ``nav_msgs/Odometry`` for
ground truth), and a converter that writes the sweep-per-file NPZ layout
``examples/run_offline.py`` replays.

A minimal writer (uncompressed, unindexed) exists so tests can synthesize a
bag and round-trip it — the reader never needs the index records, it scans
chunks start-to-end exactly like ``rosbag play`` does on an unindexed bag.

Format notes (rosbag V2.0 on-disk container):
  file     := "#ROSBAG V2.0\n" record*
  record   := u32 header_len, header, u32 data_len, data
  header   := (u32 field_len, name "=" value)*
  op field := 0x03 bag header | 0x05 chunk | 0x07 connection |
              0x02 message data | 0x04 index | 0x06 chunk info
Chunk data holds nested connection/message records, optionally bz2-compressed
(the ``compression`` header field).  All scalars little-endian.
"""

from __future__ import annotations

import bz2
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07

_U32 = struct.Struct("<I")


# ---------------------------------------------------------------------------
# container parsing
# ---------------------------------------------------------------------------


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields: Dict[bytes, bytes] = {}
    off = 0
    n = len(buf)
    while off < n:
        (flen,) = _U32.unpack_from(buf, off)
        off += 4
        field = buf[off:off + flen]
        off += flen
        eq = field.index(b"=")
        fields[field[:eq]] = field[eq + 1:]
    return fields


def _read_record(f) -> Optional[Tuple[Dict[bytes, bytes], bytes]]:
    raw = f.read(4)
    if len(raw) < 4:
        return None
    (hlen,) = _U32.unpack(raw)
    header = _parse_header(f.read(hlen))
    (dlen,) = _U32.unpack(f.read(4))
    data = f.read(dlen)
    return header, data


def _records_in(buf: bytes) -> Iterator[Tuple[Dict[bytes, bytes], bytes]]:
    off = 0
    n = len(buf)
    while off < n:
        (hlen,) = _U32.unpack_from(buf, off)
        off += 4
        header = _parse_header(buf[off:off + hlen])
        off += hlen
        (dlen,) = _U32.unpack_from(buf, off)
        off += 4
        yield header, buf[off:off + dlen]
        off += dlen


class Connection:
    __slots__ = ("cid", "topic", "msg_type", "md5sum")

    def __init__(self, cid: int, topic: str, msg_type: str, md5sum: str):
        self.cid = cid
        self.topic = topic
        self.msg_type = msg_type
        self.md5sum = md5sum


class BagReader:
    """Sequential reader over a rosbag V2.0 file.

    ``messages()`` yields ``(topic, msg_type, stamp_sec, raw_bytes)`` in file
    order (which is record order = arrival order for recorded bags).  No
    index is required.
    """

    def __init__(self, path: str):
        self.path = path
        self.connections: Dict[int, Connection] = {}

    def _handle_connection(self, header, data):
        cid = _U32.unpack(header[b"conn"])[0]
        conn_fields = _parse_header(data)
        self.connections[cid] = Connection(
            cid,
            header.get(b"topic", conn_fields.get(b"topic", b"")).decode(),
            conn_fields.get(b"type", b"").decode(),
            conn_fields.get(b"md5sum", b"").decode(),
        )

    def messages(self) -> Iterator[Tuple[str, str, float, bytes]]:
        with open(self.path, "rb") as f:
            magic = f.read(len(MAGIC))
            if magic != MAGIC:
                raise ValueError(
                    f"{self.path}: not a rosbag V2.0 file (magic {magic!r})"
                )
            while True:
                rec = _read_record(f)
                if rec is None:
                    return
                header, data = rec
                op = header[b"op"][0]
                if op == OP_CONNECTION:
                    self._handle_connection(header, data)
                elif op == OP_CHUNK:
                    comp = header.get(b"compression", b"none")
                    if comp == b"bz2":
                        data = bz2.decompress(data)
                    elif comp not in (b"none", b""):
                        raise ValueError(
                            f"unsupported chunk compression {comp!r} "
                            "(none/bz2 supported; lz4 is not in this image)"
                        )
                    for h2, d2 in _records_in(data):
                        op2 = h2[b"op"][0]
                        if op2 == OP_CONNECTION:
                            self._handle_connection(h2, d2)
                        elif op2 == OP_MSG:
                            yield self._emit(h2, d2)
                elif op == OP_MSG:  # unchunked (never written by rosbag,
                    yield self._emit(header, data)  # but trivial to accept)
                # OP_BAG_HEADER / OP_INDEX / OP_CHUNK_INFO: skipped

    def _emit(self, header, data):
        cid = _U32.unpack(header[b"conn"])[0]
        secs, nsecs = struct.unpack("<II", header[b"time"])
        conn = self.connections.get(cid)
        topic = conn.topic if conn else f"conn{cid}"
        msg_type = conn.msg_type if conn else ""
        return topic, msg_type, secs + 1e-9 * nsecs, data

    def topics(self) -> Dict[str, str]:
        """{topic: msg_type} discovered by a full scan (cheap: headers only
        are parsed; message payloads are skipped lazily by the generator)."""
        out = {}
        for topic, msg_type, _, _ in self.messages():
            out.setdefault(topic, msg_type)
        return out


# ---------------------------------------------------------------------------
# message deserialization (ROS little-endian wire format)
# ---------------------------------------------------------------------------

# sensor_msgs/PointField datatype codes -> numpy
_PF_DTYPE = {1: "i1", 2: "u1", 3: "i2", 4: "u2", 5: "i4", 6: "u4",
             7: "f4", 8: "f8"}


def _read_string(buf: bytes, off: int) -> Tuple[str, int]:
    (n,) = _U32.unpack_from(buf, off)
    off += 4
    return buf[off:off + n].decode(errors="replace"), off + n


def _read_header(buf: bytes, off: int) -> Tuple[float, int]:
    # std_msgs/Header: uint32 seq, time stamp, string frame_id
    _, secs, nsecs = struct.unpack_from("<III", buf, off)
    off += 12
    _, off = _read_string(buf, off)
    return secs + 1e-9 * nsecs, off


def decode_pointcloud2(buf: bytes) -> Dict[str, np.ndarray]:
    """sensor_msgs/PointCloud2 -> {'xyz', 'stamp', + optional per-point
    'intensity'/'ring'/'time'} (whatever fields the bag carries)."""
    stamp, off = _read_header(buf, 0)
    height, width = struct.unpack_from("<II", buf, off)
    off += 8
    (n_fields,) = _U32.unpack_from(buf, off)
    off += 4
    names, formats, offsets = [], [], []
    for _ in range(n_fields):
        name, off = _read_string(buf, off)
        f_off, dtype, count = struct.unpack_from("<IBI", buf, off)
        off += 9
        base = _PF_DTYPE[dtype]
        names.append(name)
        formats.append(base if count == 1 else (base, (count,)))
        offsets.append(f_off)
    is_bigendian, point_step, row_step = struct.unpack_from("<BII", buf, off)
    off += 9
    (data_len,) = _U32.unpack_from(buf, off)
    off += 4
    raw = buf[off:off + data_len]
    off += data_len
    # is_dense (1 byte) follows; nothing after it that we need

    dt = np.dtype({"names": names, "formats": formats, "offsets": offsets,
                   "itemsize": point_step})
    if is_bigendian:
        dt = dt.newbyteorder(">")
    n_points = height * width
    pts = np.frombuffer(raw[: n_points * point_step], dtype=dt)

    out: Dict[str, np.ndarray] = {"stamp": np.float64(stamp)}
    xyz = np.stack(
        [pts["x"].astype(np.float32), pts["y"].astype(np.float32),
         pts["z"].astype(np.float32)], axis=-1)
    out["xyz"] = xyz
    for extra in ("intensity", "ring", "time", "t", "timestamp"):
        if extra in names:
            out[extra] = np.ascontiguousarray(pts[extra])
    return out


def decode_imu(buf: bytes) -> Dict[str, np.ndarray]:
    """sensor_msgs/Imu -> {'stamp','orientation','angular_velocity',
    'linear_acceleration'} (covariances skipped)."""
    stamp, off = _read_header(buf, 0)
    quat = np.frombuffer(buf, np.dtype("<f8"), 4, off)
    off += 32 + 72                          # quaternion + orientation_cov[9]
    gyro = np.frombuffer(buf, np.dtype("<f8"), 3, off)
    off += 24 + 72
    accel = np.frombuffer(buf, np.dtype("<f8"), 3, off)
    return {"stamp": np.float64(stamp), "orientation": quat.copy(),
            "angular_velocity": gyro.copy(), "linear_acceleration": accel.copy()}


def decode_odometry(buf: bytes) -> Dict[str, np.ndarray]:
    """nav_msgs/Odometry -> {'stamp','position','orientation' (x,y,z,w)}."""
    stamp, off = _read_header(buf, 0)
    _, off = _read_string(buf, off)          # child_frame_id
    pos = np.frombuffer(buf, np.dtype("<f8"), 3, off)
    quat = np.frombuffer(buf, np.dtype("<f8"), 4, off + 24)
    return {"stamp": np.float64(stamp), "position": pos.copy(),
            "orientation": quat.copy()}


_DECODERS = {
    "sensor_msgs/PointCloud2": decode_pointcloud2,
    "sensor_msgs/Imu": decode_imu,
    "nav_msgs/Odometry": decode_odometry,
}


# ---------------------------------------------------------------------------
# bag -> NPZ sweep directory (the run_offline.py replay format)
# ---------------------------------------------------------------------------


def bag_to_npz(bag_path: str, out_dir: str,
               cloud_topic: Optional[str] = None,
               imu_topic: Optional[str] = None,
               odom_topic: Optional[str] = None,
               max_sweeps: Optional[int] = None) -> Dict[str, object]:
    """Convert a bag to ``sweep_NNNNNN.npz`` files (+ ``imu.npz``/``gt.npz``).

    Topic selection: explicit arguments win; otherwise the reference's
    topic names (``/multi_scan_points``, ``/imu/data`` — the
    lidar_mapping.launch wiring) are preferred, falling back to the first
    topic of the matching type.
    """
    reader = BagReader(bag_path)
    topics = reader.topics()

    def pick(explicit, preferred, msg_type):
        if explicit is not None:
            if explicit not in topics:
                raise ValueError(f"topic {explicit!r} not in bag "
                                 f"(has: {sorted(topics)})")
            return explicit
        for p in preferred:
            if topics.get(p) == msg_type:
                return p
        for t, ty in topics.items():
            if ty == msg_type:
                return t
        return None

    cloud_topic = pick(cloud_topic,
                       ("/multi_scan_points", "/organised_scan_points",
                        "/velodyne_points"), "sensor_msgs/PointCloud2")
    imu_topic = pick(imu_topic, ("/imu/data", "/imu/data_raw"),
                     "sensor_msgs/Imu")
    odom_topic = pick(odom_topic, ("/fpd",), "nav_msgs/Odometry")
    if cloud_topic is None:
        raise ValueError(f"no PointCloud2 topic in {bag_path} "
                         f"(topics: {sorted(topics)})")

    os.makedirs(out_dir, exist_ok=True)
    n_sweeps = 0
    sweep_stamps: List[float] = []
    imu: Dict[str, List[np.ndarray]] = {
        "stamp": [], "orientation": [], "angular_velocity": [],
        "linear_acceleration": []}
    gt: Dict[str, List[np.ndarray]] = {
        "stamp": [], "position": [], "orientation": []}

    for topic, msg_type, stamp, raw in reader.messages():
        if topic == cloud_topic:
            if max_sweeps is not None and n_sweeps >= max_sweeps:
                continue
            msg = decode_pointcloud2(raw)
            arrays = {"xyz": msg["xyz"], "stamp": msg["stamp"]}
            for k in ("intensity", "ring", "time"):
                if k in msg:
                    arrays[k] = msg[k]
            np.savez(os.path.join(out_dir, f"sweep_{n_sweeps:06d}.npz"),
                     **arrays)
            sweep_stamps.append(float(msg["stamp"]))
            n_sweeps += 1
        elif topic == imu_topic:
            msg = decode_imu(raw)
            for k in imu:
                imu[k].append(msg[k])
        elif topic == odom_topic:
            msg = decode_odometry(raw)
            for k in gt:
                gt[k].append(msg[k])

    if imu["stamp"]:
        np.savez(os.path.join(out_dir, "imu.npz"),
                 **{k: np.stack(v) for k, v in imu.items()})
    if gt["stamp"]:
        np.savez(os.path.join(out_dir, "gt.npz"),
                 **{k: np.stack(v) for k, v in gt.items()})
    return {"n_sweeps": n_sweeps, "n_imu": len(imu["stamp"]),
            "n_gt": len(gt["stamp"]), "cloud_topic": cloud_topic,
            "imu_topic": imu_topic, "odom_topic": odom_topic,
            "sweep_stamps": sweep_stamps}


# ---------------------------------------------------------------------------
# minimal writer (synthetic test bags: uncompressed, unindexed)
# ---------------------------------------------------------------------------


def _header_bytes(fields: Dict[bytes, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        field = k + b"=" + v
        out += _U32.pack(len(field)) + field
    return out


def _record(fields: Dict[bytes, bytes], data: bytes) -> bytes:
    h = _header_bytes(fields)
    return _U32.pack(len(h)) + h + _U32.pack(len(data)) + data


def _time_bytes(stamp: float) -> bytes:
    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    return struct.pack("<II", secs, nsecs)


def encode_pointcloud2(xyz: np.ndarray, stamp: float,
                       intensity: Optional[np.ndarray] = None,
                       ring: Optional[np.ndarray] = None,
                       frame_id: str = "velodyne") -> bytes:
    """Serialize an [N,3] float32 cloud as sensor_msgs/PointCloud2."""
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    fields = [("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1)]
    step = 12
    if intensity is not None:
        fields.append(("intensity", step, 7, 1))
        step += 4
    if ring is not None:
        fields.append(("ring", step, 4, 1))
        step += 2
    rec = np.zeros(n, np.dtype(
        {"names": [f[0] for f in fields],
         "formats": ["<f4", "<f4", "<f4"] + (["<f4"] if intensity is not None
                                             else [])
         + (["<u2"] if ring is not None else []),
         "offsets": [f[1] for f in fields], "itemsize": step}))
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    if intensity is not None:
        rec["intensity"] = np.asarray(intensity, np.float32)
    if ring is not None:
        rec["ring"] = np.asarray(ring, np.uint16)
    data = rec.tobytes()

    out = struct.pack("<III", 0, int(stamp), int(round((stamp % 1) * 1e9)))
    out += _U32.pack(len(frame_id)) + frame_id.encode()
    out += struct.pack("<II", 1, n)                     # height, width
    out += _U32.pack(len(fields))
    for name, f_off, dtype, count in fields:
        out += _U32.pack(len(name)) + name.encode()
        out += struct.pack("<IBI", f_off, dtype, count)
    out += struct.pack("<BII", 0, step, step * n)       # LE, point/row step
    out += _U32.pack(len(data)) + data
    out += struct.pack("<B", 1)                         # is_dense
    return out


def encode_imu(stamp: float, orientation, angular_velocity,
               linear_acceleration, frame_id: str = "imu") -> bytes:
    out = struct.pack("<III", 0, int(stamp), int(round((stamp % 1) * 1e9)))
    out += _U32.pack(len(frame_id)) + frame_id.encode()
    out += np.asarray(orientation, "<f8").tobytes()
    out += np.zeros(9, "<f8").tobytes()
    out += np.asarray(angular_velocity, "<f8").tobytes()
    out += np.zeros(9, "<f8").tobytes()
    out += np.asarray(linear_acceleration, "<f8").tobytes()
    out += np.zeros(9, "<f8").tobytes()
    return out


def encode_odometry(stamp: float, position, orientation,
                    frame_id: str = "map",
                    child_frame_id: str = "base_link") -> bytes:
    out = struct.pack("<III", 0, int(stamp), int(round((stamp % 1) * 1e9)))
    out += _U32.pack(len(frame_id)) + frame_id.encode()
    out += _U32.pack(len(child_frame_id)) + child_frame_id.encode()
    out += np.asarray(position, "<f8").tobytes()
    out += np.asarray(orientation, "<f8").tobytes()
    out += np.zeros(36, "<f8").tobytes()
    out += np.zeros(6, "<f8").tobytes()                 # twist
    out += np.zeros(36, "<f8").tobytes()
    return out


def write_bag(path: str,
              messages: List[Tuple[str, str, float, bytes]],
              compression: str = "none") -> None:
    """Write a V2.0 bag: one connection per topic, one chunk of messages.

    ``messages``: list of (topic, msg_type, stamp, serialized_bytes).
    Unindexed (index_pos=0); our reader and `rosbag reindex` both accept it.
    """
    conns: Dict[str, int] = {}
    for topic, msg_type, _, _ in messages:
        conns.setdefault(topic, len(conns))
    types = {topic: msg_type for topic, msg_type, _, _ in messages}

    chunk = b""
    for topic, cid in conns.items():
        conn_data = _header_bytes({
            b"topic": topic.encode(),
            b"type": types[topic].encode(),
            b"md5sum": b"*",
            b"message_definition": b"",
        })
        chunk += _record(
            {b"op": bytes([OP_CONNECTION]), b"conn": _U32.pack(cid),
             b"topic": topic.encode()}, conn_data)
    for topic, _, stamp, raw in messages:
        chunk += _record(
            {b"op": bytes([OP_MSG]), b"conn": _U32.pack(conns[topic]),
             b"time": _time_bytes(stamp)}, raw)

    comp_name = compression.encode()
    payload = bz2.compress(chunk) if compression == "bz2" else chunk

    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(_record(
            {b"op": bytes([OP_BAG_HEADER]),
             b"index_pos": struct.pack("<Q", 0),
             b"conn_count": _U32.pack(len(conns)),
             b"chunk_count": _U32.pack(1)},
            b" " * 4096))                               # standard padding
        f.write(_record(
            {b"op": bytes([OP_CHUNK]), b"compression": comp_name,
             b"size": _U32.pack(len(chunk))}, payload))
