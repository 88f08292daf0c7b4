"""Pure-Python rosbag 2.0 reader + TUM-RSVI -> npz converter (no ROS; the
port's own copy of `ctrlvio_tpu/io/rosbag.py`).

The reference ingests data exclusively by replaying rosbags
(`OdometryManager::LoadBag/RunBag`, `odometry_manager.cpp:97-165`,
`README.md:37-54`). This module re-implements the ingest path without any
ROS dependency: a sequential reader for the rosbag V2.0 container format
(http://wiki.ros.org/Bags/Format/2.0) plus deserializers for the two
message types the reference subscribes to (`sensor_msgs/Imu`,
`sensor_msgs/Image` — also `CompressedImage` for convenience), feeding
`bag_to_sequence` which emits the npz schema of `io/dataset.py`.

Container format summary (implemented below):
  - file starts with the ASCII line ``#ROSBAG V2.0\\n``;
  - then a stream of records: ``<u32 hlen><header bytes><u32 dlen><data>``;
  - a header is a sequence of fields ``<u32 len>name=value``; every record
    carries an ``op`` field (one byte) identifying its type;
  - op 0x03 bag header (index_pos, conn/chunk counts; padded with spaces),
    op 0x05 chunk (data = concatenated connection/message-data records,
    possibly bz2/lz4 compressed), op 0x07 connection (topic + msg type),
    op 0x02 message data (conn id + time + serialized message),
    op 0x04 index data / op 0x06 chunk info (skipped — we scan chunks
    sequentially, which also works for unindexed/truncated bags).
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"

OP_MSG_DATA = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX_DATA = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07

_u32 = struct.Struct("<I")
_u64 = struct.Struct("<Q")


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields = {}
    o = 0
    n = len(buf)
    while o < n:
        (flen,) = _u32.unpack_from(buf, o)
        o += 4
        field = buf[o:o + flen]
        o += flen
        eq = field.index(b"=")
        fields[field[:eq]] = field[eq + 1:]
    return fields


def _read_record(buf: bytes, o: int) -> Tuple[Dict[bytes, bytes], bytes, int]:
    (hlen,) = _u32.unpack_from(buf, o)
    hdr = _parse_header(buf[o + 4:o + 4 + hlen])
    o += 4 + hlen
    (dlen,) = _u32.unpack_from(buf, o)
    data = buf[o + 4:o + 4 + dlen]
    return hdr, data, o + 4 + dlen


@dataclass
class Connection:
    topic: str
    msg_type: str
    md5sum: str


def read_messages(path: str, topics: Optional[List[str]] = None
                  ) -> Iterator[Tuple[str, int, bytes, Connection]]:
    """Yield (topic, t_ns, raw_serialized_msg, connection) in file order.

    Sequential chunk scan (no use of the index records), so partially
    written bags still replay — same robustness as rosbag's reindex path.
    """
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(MAGIC):
        raise ValueError(f"{path}: not a rosbag V2.0 file")
    conns: Dict[int, Connection] = {}
    o = len(MAGIC)
    end = len(blob)

    def scan(buf: bytes):
        """Yield message-data records from a flat record stream."""
        p = 0
        while p < len(buf):
            hdr, data, p = _read_record(buf, p)
            op = hdr[b"op"][0]
            if op == OP_CONNECTION:
                (cid,) = _u32.unpack(hdr[b"conn"])
                ch = _parse_header(data)
                conns[cid] = Connection(
                    topic=ch.get(b"topic", hdr.get(b"topic", b"")).decode(),
                    msg_type=ch.get(b"type", b"").decode(),
                    md5sum=ch.get(b"md5sum", b"").decode())
            elif op == OP_MSG_DATA:
                (cid,) = _u32.unpack(hdr[b"conn"])
                (t_raw,) = _u64.unpack(hdr[b"time"])
                # bag time field: secs in low 4 bytes, nsecs in high 4
                secs = t_raw & 0xFFFFFFFF
                nsecs = t_raw >> 32
                yield cid, secs * 1_000_000_000 + nsecs, data

    while o < end:
        hdr, data, o = _read_record(blob, o)
        op = hdr[b"op"][0]
        if op == OP_CHUNK:
            comp = hdr.get(b"compression", b"none")
            if comp == b"bz2":
                data = bz2.decompress(data)
            elif comp == b"lz4":
                # roslz4 writes the LZ4 Frame format; decoded by the
                # in-tree pure-python codec (io/lz4.py) — no external dep
                from ctrlvio_tpu_torch.io import lz4

                data = lz4.decompress_frame(data)
            elif comp != b"none":
                raise ValueError(f"unknown chunk compression {comp!r}")
            for cid, t_ns, raw in scan(data):
                c = conns.get(cid)
                if c is None:
                    continue
                if topics is None or c.topic in topics:
                    yield c.topic, t_ns, raw, c
        elif op in (OP_CONNECTION, OP_MSG_DATA):
            # unchunked (rosbag never writes these at top level post-V1.2,
            # but handle them for hand-rolled bags)
            if op == OP_CONNECTION:
                (cid,) = _u32.unpack(hdr[b"conn"])
                ch = _parse_header(data)
                conns[cid] = Connection(
                    topic=ch.get(b"topic", b"").decode(),
                    msg_type=ch.get(b"type", b"").decode(),
                    md5sum=ch.get(b"md5sum", b"").decode())
            else:
                (cid,) = _u32.unpack(hdr[b"conn"])
                (t_raw,) = _u64.unpack(hdr[b"time"])
                secs = t_raw & 0xFFFFFFFF
                nsecs = t_raw >> 32
                c = conns.get(cid)
                if c is not None and (topics is None or c.topic in topics):
                    yield c.topic, secs * 1_000_000_000 + nsecs, data, c
        # op 0x03/0x04/0x06: bag header / index / chunk info -> skip


# ---------------------------------------------------------------------------
# ROS1 message deserialization (little-endian, no padding)
# ---------------------------------------------------------------------------

class _Reader:
    __slots__ = ("b", "o")

    def __init__(self, b: bytes):
        self.b = b
        self.o = 0

    def u8(self):
        v = self.b[self.o]
        self.o += 1
        return v

    def u32(self):
        (v,) = _u32.unpack_from(self.b, self.o)
        self.o += 4
        return v

    def f64(self, n=1):
        v = np.frombuffer(self.b, np.dtype("<f8"), n, self.o)
        self.o += 8 * n
        return v

    def string(self) -> bytes:
        n = self.u32()
        v = self.b[self.o:self.o + n]
        self.o += n
        return v

    def time_ns(self) -> int:
        secs = self.u32()
        nsecs = self.u32()
        return secs * 1_000_000_000 + nsecs

    def header(self) -> int:
        """std_msgs/Header -> stamp in ns (seq + frame_id skipped)."""
        self.u32()  # seq
        t = self.time_ns()
        self.string()  # frame_id
        return t


@dataclass
class ImuMsg:
    t_ns: int  # header stamp (sensor time — what the reference uses)
    gyro: np.ndarray
    accel: np.ndarray
    orientation: np.ndarray  # (x, y, z, w); all-zero if unpopulated


def parse_imu(raw: bytes) -> ImuMsg:
    """sensor_msgs/Imu (≙ the fields read in `odometry_manager.cpp:319-330`)."""
    r = _Reader(raw)
    t = r.header()
    quat = r.f64(4).copy()          # orientation x y z w
    r.f64(9)                        # orientation_covariance
    gyro = r.f64(3).copy()          # angular_velocity
    r.f64(9)
    accel = r.f64(3).copy()         # linear_acceleration
    return ImuMsg(t_ns=t, gyro=gyro, accel=accel, orientation=quat)


@dataclass
class ImageMsg:
    t_ns: int
    image: np.ndarray  # (H, W) uint8 grayscale


def _to_gray(img: np.ndarray, encoding: str) -> np.ndarray:
    if img.ndim == 2:
        return img
    if encoding.startswith("bgr"):
        w = np.array([0.114, 0.587, 0.299])
    else:  # rgb*
        w = np.array([0.299, 0.587, 0.114])
    return np.clip(img[..., :3].astype(np.float32) @ w.astype(np.float32),
                   0, 255).astype(np.uint8)


def parse_image(raw: bytes) -> ImageMsg:
    """sensor_msgs/Image -> grayscale u8 (≙ cv_bridge mono8 conversion in
    `feature_tracker_node.cpp:95-120`)."""
    r = _Reader(raw)
    t = r.header()
    height = r.u32()
    width = r.u32()
    encoding = r.string().decode()
    r.u8()          # is_bigendian
    step = r.u32()
    n = r.u32()
    data = np.frombuffer(r.b, np.uint8, n, r.o)
    enc = encoding.lower()
    if enc in ("mono8", "8uc1"):
        img = data.reshape(height, step)[:, :width]
    elif enc in ("bgr8", "rgb8"):
        img = _to_gray(data.reshape(height, step)[:, :width * 3]
                       .reshape(height, width, 3), enc)
    elif enc in ("mono16", "16uc1"):
        img16 = data.view("<u2").reshape(height, step // 2)[:, :width]
        img = (img16 >> 8).astype(np.uint8)
    else:
        raise ValueError(f"unsupported image encoding {encoding!r}")
    return ImageMsg(t_ns=t, image=np.ascontiguousarray(img))


def parse_compressed_image(raw: bytes) -> ImageMsg:
    """sensor_msgs/CompressedImage (jpeg/png payload via PIL)."""
    from io import BytesIO

    from PIL import Image as PILImage

    r = _Reader(raw)
    t = r.header()
    r.string()  # format, e.g. "bgr8; jpeg compressed bgr8"
    n = r.u32()
    payload = r.b[r.o:r.o + n]
    img = np.asarray(PILImage.open(BytesIO(payload)).convert("L"))
    return ImageMsg(t_ns=t, image=img)


_IMAGE_PARSERS = {
    "sensor_msgs/Image": parse_image,
    "sensor_msgs/CompressedImage": parse_compressed_image,
}


# ---------------------------------------------------------------------------
# Converter
# ---------------------------------------------------------------------------

def bag_to_sequence(bag_path: str, imu_topic: str, image_topic: str,
                    t_start: float = 0.0, t_end: float = float("inf"),
                    image_stride: int = 1):
    """Read a bag into a raw-image `dataset.Sequence` (images + IMU).

    Sensor (header) timestamps are used, matching the reference
    (`odometry_manager.cpp:319-339` reads `msg->header.stamp`). t_start/t_end
    select a window in seconds relative to the first message (≙ the
    `bag_start/bag_durr` config knobs, `odometry_manager.cpp:104-118`).
    """
    from ctrlvio_tpu_torch.io import dataset

    imu_t, gyr, acc = [], [], []
    img_t, imgs = [], []
    t0 = None
    n_img = 0
    for topic, bag_t_ns, raw, conn in read_messages(
            bag_path, [imu_topic, image_topic]):
        if t0 is None:
            t0 = bag_t_ns
        rel = (bag_t_ns - t0) * 1e-9
        if rel < t_start:
            continue
        if rel > t_end:
            break
        if topic == imu_topic:
            m = parse_imu(raw)
            imu_t.append(m.t_ns)
            gyr.append(m.gyro)
            acc.append(m.accel)
        else:
            n_img += 1
            if (n_img - 1) % image_stride:
                continue
            parser = _IMAGE_PARSERS.get(conn.msg_type, parse_image)
            m = parser(raw)
            img_t.append(m.t_ns)
            imgs.append(m.image)
    if not imu_t:
        raise ValueError(f"no IMU messages on {imu_topic!r}")
    if not img_t:
        raise ValueError(f"no image messages on {image_topic!r}")
    return dataset.Sequence(
        imu_t_ns=np.asarray(imu_t, np.int64),
        gyro=np.stack(gyr), accel=np.stack(acc),
        frame_t_ns=np.asarray(img_t, np.int64),
        feat_ids=[], feat_pts=[], feat_rows=[],
        images=np.stack(imgs))


def bag_to_npz(bag_path: str, out_path: str, imu_topic: str = "/imu0",
               image_topic: str = "/cam0/image_raw", **kw):
    """Convert a bag to a raw-image npz (run the front-end at replay time,
    or `frontend.extract_sequence` offline to produce a feature npz)."""
    seq = bag_to_sequence(bag_path, imu_topic, image_topic, **kw)
    np.savez_compressed(
        out_path, imu_t_ns=seq.imu_t_ns, gyro=seq.gyro, accel=seq.accel,
        frame_t_ns=seq.frame_t_ns, images=seq.images,
        feat_ptr=np.zeros(len(seq.frame_t_ns) + 1, np.int64),
        feat_ids=np.zeros(0, np.int64), feat_pts=np.zeros((0, 2)),
        feat_rows=np.zeros(0))
    return seq
