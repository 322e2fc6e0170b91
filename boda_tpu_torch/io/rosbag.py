"""rosbag (v2.0) stream stage: ROS bag reading without ROS.

The port's copy of boda_tpu/io/rosbag.py.

Reference parity: data-stream-rosbag.cc (`rosbag-src`) — one block per
message on selected topics, with sensor_msgs/Image payloads decoded to
image ndas. The reference linked the ROS C++ stack (ros/rosbag/view);
the host has no ROS, so this parses the documented bag v2.0 container
format directly (http://wiki.ros.org/Bags/Format/2.0):

    #ROSBAG V2.0\\n then records of
    <u32 hlen><header fields: u32 flen, name=value ...><u32 dlen><data>

  op=0x03 bag header | 0x07 connection (topic, type, md5) |
  0x05 chunk (compression none|bz2; contains nested connection/message
  records) | 0x02 message data (conn id + time) | 0x04/0x06 index/info
  (skipped).

Message bodies on matching topics are emitted as raw-bytes blocks
(tag=topic, timestamp from the record); `decode_images=1` additionally
decodes sensor_msgs/Image bodies (ROS1 serialization: Header, height,
width, encoding, is_bigendian, step, data) into (y, x, chan) u8 ndas
for mono8/rgb8/bgr8/bgra8/rgba8 encodings.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from ..core.config import Attr, register
from ..core.dims import NDA, Dims
from ..core.error import RtErr
from .data_stream import DataBlock, DataStream, resolve_stage_fn

MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAGHDR = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONN = 0x07


def _parse_header(buf: bytes) -> dict[str, bytes]:
    out = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off:off + flen]
        off += flen
        eq = field.index(b"=")
        out[field[:eq].decode()] = field[eq + 1:]
    return out


def _time_ns(field: bytes) -> int:
    """rosbag time field: sec in the low u32, nsec in the high u32."""
    (t,) = struct.unpack("<Q", field)
    return (t & 0xFFFFFFFF) * 1_000_000_000 + (t >> 32)


def _records(buf: bytes, off: int = 0):
    while off < len(buf):
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        hdr = _parse_header(buf[off:off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        data = buf[off:off + dlen]
        off += dlen
        yield hdr, data


def decode_ros_image(body: bytes):
    """sensor_msgs/Image ROS1 wire → (np image, encoding, stamp_ns)."""
    off = 0
    _seq, sec, nsec = struct.unpack_from("<III", body, off)
    off += 12
    (fid_len,) = struct.unpack_from("<I", body, off)
    off += 4 + fid_len
    h, w = struct.unpack_from("<II", body, off)
    off += 8
    (enc_len,) = struct.unpack_from("<I", body, off)
    off += 4
    enc = body[off:off + enc_len].decode()
    off += enc_len
    _bige, = struct.unpack_from("<B", body, off)
    off += 1
    (step,) = struct.unpack_from("<I", body, off)
    off += 4
    (dlen,) = struct.unpack_from("<I", body, off)
    off += 4
    data = body[off:off + dlen]
    chans = {"mono8": 1, "rgb8": 3, "bgr8": 3, "rgba8": 4, "bgra8": 4}.get(enc)
    if chans is None:
        raise RtErr(f"rosbag-src: unsupported image encoding '{enc}'")
    img = np.frombuffer(data, np.uint8).reshape(h, step)[:, :w * chans]
    img = img.reshape(h, w, chans)
    if enc.startswith("bgr"):
        img = img[:, :, [2, 1, 0] + ([3] if chans == 4 else [])]
    return img.copy(), enc, sec * 1_000_000_000 + nsec


@register(DataStream, "rosbag-src",
          help="one block per rosbag message on selected topics")
class RosbagSrc(DataStream):
    fn = Attr(str, req=True, help="input .bag file (v2.0)")
    topics = Attr(str, default="", help="':'-separated topic filter "
                                        "('' = all topics)")
    decode_images = Attr(bool, default=True,
                         help="decode sensor_msgs/Image bodies to ndas")

    def data_stream_init(self):
        buf = Path(resolve_stage_fn(self.fn)).read_bytes()
        if not buf.startswith(MAGIC):
            raise RtErr("rosbag-src: not a '#ROSBAG V2.0' file")
        self._conns: dict[int, dict] = {}
        self._msgs: list[tuple[int, int, bytes]] = []  # (conn, time, body)
        want = set(t for t in self.topics.split(":") if t)
        for hdr, data in _records(buf, len(MAGIC)):
            op = hdr["op"][0]
            if op == OP_CONN:
                self._add_conn(hdr, data)
            elif op == OP_CHUNK:
                comp = hdr.get("compression", b"none").decode()
                if comp == "none":
                    inner = data
                elif comp == "bz2":
                    import bz2
                    inner = bz2.decompress(data)
                else:
                    raise RtErr(f"rosbag-src: unsupported chunk compression "
                                f"'{comp}' (none|bz2)")
                for ih, idata in _records(inner):
                    iop = ih["op"][0]
                    if iop == OP_CONN:
                        self._add_conn(ih, idata)
                    elif iop == OP_MSG:
                        self._msgs.append((struct.unpack("<I", ih["conn"])[0],
                                           _time_ns(ih["time"]), idata))
            elif op == OP_MSG:  # unchunked bags
                self._msgs.append((struct.unpack("<I", hdr["conn"])[0],
                                   _time_ns(hdr["time"]), data))
        if want:
            self._msgs = [m for m in self._msgs
                          if self._conns.get(m[0], {}).get("topic") in want]
        self._msgs.sort(key=lambda m: m[1])
        self._ix = 0

    def _add_conn(self, hdr, data):
        (cid,) = struct.unpack("<I", hdr["conn"])
        ch = _parse_header(data)
        self._conns[cid] = {
            "topic": (ch.get("topic") or hdr.get("topic") or b"").decode(),
            "type": (ch.get("type") or b"").decode()}

    def proc_block(self, db: DataBlock) -> DataBlock:
        if self._ix >= len(self._msgs):
            return DataBlock()
        conn, ts_ns, body = self._msgs[self._ix]
        self._ix += 1
        ci = self._conns.get(conn, {})
        out = DataBlock(tag=ci.get("topic", ""), meta=ci.get("type", ""),
                        frame_ix=self._ix - 1, timestamp_ns=ts_ns)
        if self.decode_images and ci.get("type") == "sensor_msgs/Image":
            img, enc, stamp = decode_ros_image(body)
            out.nda = NDA(Dims([("y", img.shape[0]), ("x", img.shape[1]),
                                ("chan", img.shape[2])], tn="uint8_t"), img)
            out.meta = f"sensor_msgs/Image/{enc}"
        elif self.decode_images and ci.get("type") == "sensor_msgs/PointCloud2":
            xyz, _stamp = decode_pointcloud2(body)
            out.nda = NDA(Dims.make(tn="float", y=xyz.shape[0],
                                    x=xyz.shape[1], xyz=3), xyz)
            out.meta = "pointcloud"
        else:
            out.nda = NDA(Dims.make(tn="uint8_t", v=len(body)),
                          np.frombuffer(body, np.uint8).copy())
        return out

    def seek_to_block(self, frame_ix: int) -> bool:
        if frame_ix > len(self._msgs):
            return False
        self._ix = frame_ix
        return True

    def get_pos_info_str(self) -> str:
        return (f"rosbag-src: {self._ix}/{len(self._msgs)} msgs, "
                f"{len(self._conns)} conns")


# ---- minimal bag writer (test-fixture support; the reference had no
# rosbag writer — this exists so the reader is testable without ROS) ----

def _rec(hdr_fields: dict[str, bytes], data: bytes) -> bytes:
    h = b"".join(struct.pack("<I", len(k) + 1 + len(v)) + k.encode() + b"="
                 + v for k, v in hdr_fields.items())
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def write_bag(path, msgs, compression: str = "none") -> None:
    """msgs: list of (topic, msg_type, time_ns, body-bytes)."""
    topics = {}
    for topic, mtype, _t, _b in msgs:
        topics.setdefault(topic, (len(topics), mtype))
    chunk = bytearray()
    for topic, (cid, mtype) in topics.items():
        inner = b"".join(struct.pack("<I", len(k) + 1 + len(v)) + k.encode()
                         + b"=" + v for k, v in
                         {"topic": topic.encode(),
                          "type": mtype.encode()}.items())
        chunk += _rec({"op": bytes([OP_CONN]),
                       "conn": struct.pack("<I", cid),
                       "topic": topic.encode()}, inner)
    for topic, mtype, t_ns, body in msgs:
        cid = topics[topic][0]
        t = (t_ns // 1_000_000_000) | ((t_ns % 1_000_000_000) << 32)
        chunk += _rec({"op": bytes([OP_MSG]),
                       "conn": struct.pack("<I", cid),
                       "time": struct.pack("<Q", t)}, bytes(body))
    payload = bytes(chunk)
    comp = compression
    if comp == "bz2":
        import bz2
        payload = bz2.compress(bytes(chunk))
    out = bytearray(MAGIC)
    out += _rec({"op": bytes([OP_BAGHDR]), "index_pos": struct.pack("<Q", 0),
                 "conn_count": struct.pack("<I", len(topics)),
                 "chunk_count": struct.pack("<I", 1)}, b"\x20" * 4096)
    out += _rec({"op": bytes([OP_CHUNK]), "compression": comp.encode(),
                 "size": struct.pack("<I", len(chunk))}, payload)
    Path(path).write_bytes(bytes(out))


def encode_ros_image(img: np.ndarray, enc: str = "rgb8",
                     stamp_ns: int = 0) -> bytes:
    h, w, c = img.shape
    out = struct.pack("<III", 0, stamp_ns // 1_000_000_000,
                      stamp_ns % 1_000_000_000)
    out += struct.pack("<I", 3) + b"cam"
    out += struct.pack("<II", h, w)
    out += struct.pack("<I", len(enc)) + enc.encode()
    out += struct.pack("<B", 0)
    out += struct.pack("<I", w * c)
    data = np.ascontiguousarray(img).tobytes()
    return out + struct.pack("<I", len(data)) + data


# ---- sensor_msgs/PointCloud2 (ROS1 wire) ----

_PF_FLOAT32 = 7


def encode_pointcloud2(xyz: np.ndarray, stamp_ns: int = 0,
                       frame_id: str = "base_link") -> bytes:
    """(y, x, 3) float32 → sensor_msgs/PointCloud2 body (x/y/z FLOAT32
    fields, point_step 12) — the layout the reference's rosbag-sink
    emitted for lidar frames (data-stream-rosbag.cc:341+)."""
    h, w, c = xyz.shape
    if c != 3:
        raise RtErr(f"encode_pointcloud2: want (y,x,3), got {xyz.shape}")
    fid = frame_id.encode()
    out = struct.pack("<III", 0, stamp_ns // 1_000_000_000,
                      stamp_ns % 1_000_000_000)
    out += struct.pack("<I", len(fid)) + fid
    out += struct.pack("<II", h, w)
    out += struct.pack("<I", 3)  # fields[]
    for i, name in enumerate((b"x", b"y", b"z")):
        out += struct.pack("<I", len(name)) + name
        out += struct.pack("<IBI", 4 * i, _PF_FLOAT32, 1)
    out += struct.pack("<B", 0)            # is_bigendian
    out += struct.pack("<II", 12, 12 * w)  # point_step, row_step
    data = np.ascontiguousarray(xyz, np.float32).tobytes()
    out += struct.pack("<I", len(data)) + data
    out += struct.pack("<B", 1)            # is_dense
    return out


def decode_pointcloud2(body: bytes):
    """sensor_msgs/PointCloud2 body → ((y, x, 3) float32, stamp_ns)."""
    off = 0
    _seq, sec, nsec = struct.unpack_from("<III", body, off)
    off += 12
    (fid_len,) = struct.unpack_from("<I", body, off)
    off += 4 + fid_len
    h, w = struct.unpack_from("<II", body, off)
    off += 8
    (n_fields,) = struct.unpack_from("<I", body, off)
    off += 4
    fields = {}
    for _ in range(n_fields):
        (nlen,) = struct.unpack_from("<I", body, off)
        off += 4
        name = body[off:off + nlen].decode()
        off += nlen
        foff, dtype, _cnt = struct.unpack_from("<IBI", body, off)
        off += 9
        fields[name] = (foff, dtype)
    off += 1  # is_bigendian
    point_step, _row_step = struct.unpack_from("<II", body, off)
    off += 8
    (dlen,) = struct.unpack_from("<I", body, off)
    off += 4
    data = body[off:off + dlen]
    for n in ("x", "y", "z"):
        if n not in fields or fields[n][1] != _PF_FLOAT32:
            raise RtErr("decode_pointcloud2: need FLOAT32 x/y/z fields, "
                        f"got {sorted(fields)}")
    raw = np.frombuffer(data, np.uint8).reshape(h * w, point_step)
    xyz = np.stack([raw[:, fields[n][0]:fields[n][0] + 4]
                    .copy().view(np.float32)[:, 0]
                    for n in ("x", "y", "z")], axis=-1)
    return xyz.reshape(h, w, 3), sec * 1_000_000_000 + nsec


@register(DataStream, "rosbag-sink",
          help="write image/pointcloud blocks to a .bag (finalized at EOF)")
class RosbagSink(DataStream):
    """Reference: rosbag-sink (data-stream-rosbag.cc:341) — per-subblock
    topics; image blocks become sensor_msgs/Image, pointcloud blocks
    (e.g. velo-pcdm-to-xyz output, meta='pointcloud') become
    sensor_msgs/PointCloud2. The reference appended through rosbag::Bag;
    this buffers messages and writes one chunked bag v2.0 file when the
    stream ends (the npy-sink convention)."""

    fn = Attr(str, req=True, help="output .bag filename")
    topics = Attr(str, default="",
                  help="':'-separated topic per subblock (empty name skips);"
                       " default: /<tag> of each (sub)block")
    frame_id = Attr(str, default="base_link")
    compression = Attr(str, default="none", help="none | bz2")

    def data_stream_init(self):
        self._msgs: list[tuple[str, str, int, bytes]] = []
        self._written = False

    def _add(self, db: DataBlock, topic: str) -> None:
        if not topic:
            return
        if db.nda is None:
            return
        t_ns = db.timestamp_ns if db.timestamp_ns is not None else \
            (db.frame_ix or 0)
        v = db.nda.v
        if db.meta.startswith("pointcloud") or (
                v.ndim == 3 and v.shape[-1] == 3 and
                v.dtype in (np.float32, np.float64)):
            self._msgs.append((topic, "sensor_msgs/PointCloud2", t_ns,
                               encode_pointcloud2(
                                   np.asarray(v, np.float32), t_ns,
                                   self.frame_id)))
        elif v.dtype == np.uint8 and v.ndim == 3 and v.shape[-1] == 3:
            self._msgs.append((topic, "sensor_msgs/Image", t_ns,
                               encode_ros_image(v, "rgb8", t_ns)))
        else:
            raise RtErr(f"rosbag-sink: unhandled block for topic {topic}: "
                        f"meta='{db.meta}' dims={db.nda.dims.pretty()}")

    def proc_block(self, db: DataBlock) -> DataBlock:
        if not db.valid():
            if not self._written:
                write_bag(resolve_stage_fn(self.fn), self._msgs,
                          self.compression)
                self._written = True
            return db
        topics = self.topics.split(":") if self.topics else []
        if db.subblocks is not None:
            if topics and len(topics) != len(db.subblocks):
                raise RtErr(f"rosbag-sink: topics count {len(topics)} != "
                            f"num_subblocks {len(db.subblocks)}")
            for i, sdb in enumerate(db.subblocks):
                self._add(sdb, topics[i] if topics
                          else "/" + (sdb.tag or f"sb{i}"))
        else:
            self._add(db, topics[0] if topics else "/" + (db.tag or "data"))
        return db

    def get_pos_info_str(self) -> str:
        return (f"rosbag-sink: {len(self._msgs)} msgs"
                + (" (written)" if self._written else ""))
