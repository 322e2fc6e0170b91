"""Velodyne lidar stream stages.

The port's copy of boda_tpu/io/velodyne.py.

Reference parity: data-stream-velo.cc —
  * `velodyne` (:102-...): parse a stream of 1206-byte HDL-32/64 UDP
    payloads (12 firing blocks of [u16 block_id, u16 rot_pos-centidegrees,
    32 x (u16 distance, u8 intensity)] + 6-byte status) into
    per-field-of-view frames: a (laser, rot_samp) u16 distance nda with
    an `azi` subblock, triggered when the azimuth crosses fov_center and
    emitted after half the FoV samples follow (ring buffer), with
    64-laser upper/lower block-id checks and dual-return skipping;
  * `velodyne-gen` (:706-885): the inverse — synthesize standard 32-laser
    packets from (32, n_azi) frames (fov_center/azi_step azimuths,
    default-32 scanline→firing-order remap, HDL32E status bytes,
    gps-timestamp stepping with hourly wrap);
  * `velo-pcdm-to-xyz` (:911-...): frames → (laser, samp, 3) float32
    XYZ point clouds using the documented angle conventions and, as in
    the reference's config-less HDL-32 path, evenly-spread default
    elevations (+10.67° down by 4/3°); azimuths from the azi subblock;
  * `velo_crc` / mode `test_velo_crc` (:55-93): the CRC16 (poly 0x8005)
    used by the 64-laser calibration status stream.

Out of scope (documented): 64-laser in-stream calibration parsing (the
status-epoch laser_corr machinery) — the reference itself required an
xml config for HDL-64 XYZ output.
"""

from __future__ import annotations

import struct

import numpy as np

from ..core.config import Attr, register
from ..core.dims import NDA, Dims
from ..core.error import RtErr
from ..core.has_main import HasMain, mode
from .data_stream import DataBlock, DataStream

ANG_MAX = 36000                      # centidegrees
BLOCK_IDS = (0xEEFF, 0xDDFF)         # lower(0-31) / upper(32-63) firing ids
PACKET_SZ = 1206
FB_SZ = 4 + 32 * 3                   # block hdr + 32 (u16 dist, u8 inten)


def rel_angle_delta(a1: int, a2: int) -> int:
    d = a1 - a2
    if d >= ANG_MAX // 2:
        d -= ANG_MAX
    if d < -(ANG_MAX // 2):
        d += ANG_MAX
    return d


def rel_angle_lt(a1: int, a2: int) -> bool:
    return rel_angle_delta(a1, a2) < 0


def velo_crc(data: bytes) -> int:
    """CRC16, poly 0x8005 (reference velo_crc, data-stream-velo.cc:56)."""
    ret = 0
    for b in data:
        ret ^= b << 8
        for _ in range(8):
            hbs = ret & 0x8000
            ret = (ret << 1) & 0xFFFF
            if hbs:
                ret ^= 0x8005
    return ret


def default_32_laser_to_row() -> list[int]:
    """HDL-32 firing order → scanline rows (reference 'default-32'):
    interleaved lower/upper blocks, downward-most first, y flipped."""
    out = [0] * 32
    for blix in range(16):
        for block in range(2):
            out[blix * 2 + block] = 31 - (block * 16 + blix)
    return out


@register(DataStream, "velodyne",
          help="merge velodyne packets into per-FoV lidar frames")
class VelodyneSrc(DataStream):
    vps = Attr(DataStream, req=True, help="underlying packet stream "
               "(e.g. pcap-src with extract_udp_payload=1)")
    fbs_per_packet = Attr(int, default=12)
    beams_per_fb = Attr(int, default=32)
    fov_center = Attr(float, default=0.0, help="FoV center, degrees")
    fov_rot_samps = Attr(int, default=384, help="rotation samples per frame")
    tot_lasers = Attr(int, default=32, help="32 (one block) or 64 (two)")
    dual_return_and_use_only_first_return = Attr(bool, default=True)
    laser_to_row_ix_str = Attr(str, default="",
                               help="''=raw order | 'default-32' | "
                                    "':'-separated permutation")

    def data_stream_init(self):
        self.vps.data_stream_init()
        if self.tot_lasers not in (32, 64):
            raise RtErr("velodyne: tot_lasers must be 32 or 64")
        if self.fov_rot_samps < 2:
            raise RtErr("velodyne: fov_rot_samps must be >= 2")
        s = self.laser_to_row_ix_str
        if not s:
            self._l2r = list(range(self.tot_lasers))
        elif s == "default-32":
            if self.tot_lasers != 32:
                raise RtErr("default-32 mapping needs tot_lasers=32")
            self._l2r = default_32_laser_to_row()
        else:
            self._l2r = [int(v) for v in s.split(":")]
        if sorted(self._l2r) != list(range(self.tot_lasers)):
            raise RtErr("laser_to_row_ix is not a permutation of "
                        f"[0,{self.tot_lasers})")
        self._l2r_np = np.asarray(self._l2r, np.int64)
        N = self.fov_rot_samps
        self._buf = np.zeros((self.tot_lasers, N), np.uint16)
        self._azi = np.zeros((N,), np.uint16)
        self._rot = 0                 # ring cursor
        self._last_rot = None
        self._last_ub_rot = None
        self._rte = None              # rots_till_emit (None = untriggered)
        self._fov_center_rot = int(self.fov_center * 100) % ANG_MAX
        self._frame_ix = 0

    def _emit(self, ts_ns):
        N = self.fov_rot_samps
        idx = (np.arange(N) + self._rot + 1) % N
        out = DataBlock(nda=NDA(Dims.make(tn="uint16_t", y=self.tot_lasers,
                                          x=N), self._buf[:, idx].copy()),
                        tag=f"lidar-velodyne-{self.tot_lasers}",
                        meta=f"lidar/VD_HDL{self.tot_lasers}",
                        frame_ix=self._frame_ix, timestamp_ns=ts_ns)
        self._frame_ix += 1
        azi = DataBlock(nda=NDA(Dims.make(tn="uint16_t", x=N),
                                self._azi[idx].copy()), tag="azi",
                        meta="azi")
        out.ensure_has_subblocks()
        out.subblocks.append(azi)
        return out

    def proc_block(self, db: DataBlock) -> DataBlock:
        fb_n, bm = self.fbs_per_packet, self.beams_per_fb
        while True:
            pkt_db = self.vps.proc_block(DataBlock())
            if not pkt_db.valid():
                return DataBlock()
            pkt = pkt_db.nda.v.tobytes()
            want = FB_SZ * fb_n + 6
            if len(pkt) != want:
                raise RtErr(f"velodyne: expected packet_sz={want} but got "
                            f"block with sz={len(pkt)}")
            emit = None
            for fbix in range(fb_n):
                off = FB_SZ * fbix
                block_id, rot = struct.unpack_from("<HH", pkt, off)
                base = 0
                if self.tot_lasers == 64:
                    if block_id != BLOCK_IDS[fbix & 1]:
                        raise RtErr(f"(64 laser mode) unexpected block_id="
                                    f"{block_id:#x} at fbix={fbix}")
                    if fbix & 1:
                        base = 32
                    if self.dual_return_and_use_only_first_return and fbix & 2:
                        if rot != self._last_rot:
                            raise RtErr("dual-return skip: rot mismatch")
                        continue
                elif block_id != BLOCK_IDS[0]:
                    raise RtErr(f"(32 laser mode) unexpected block_id="
                                f"{block_id:#x} at fbix={fbix}")
                dist = np.frombuffer(pkt, np.uint8, 32 * 3,
                                     off + 4).reshape(32, 3)
                dv = dist[:, 0].astype(np.uint16) | (
                    dist[:, 1].astype(np.uint16) << 8)
                self._buf[self._l2r_np[base:base + bm], self._rot] = dv
                self._azi[self._rot] = rot
                if self.tot_lasers == 64:
                    if not (fbix & 1):
                        self._last_ub_rot = rot
                        continue   # cursor advances after the upper block
                    if rot != self._last_ub_rot:
                        raise RtErr("64-laser: upper/lower rot mismatch")
                if self._rte is None:
                    if (self._last_rot is not None
                            and rel_angle_lt(self._last_rot, self._fov_center_rot)
                            and not rel_angle_lt(rot, self._fov_center_rot)):
                        self._rte = self.fov_rot_samps >> 1
                else:
                    self._rte -= 1
                    if self._rte == 0:
                        emit = self._emit(pkt_db.timestamp_ns)
                        self._rte = None
                self._last_rot = rot
                self._rot = (self._rot + 1) % self.fov_rot_samps
            if emit is not None:
                return emit

    def get_pos_info_str(self) -> str:
        return f"velodyne: {self._frame_ix} frames [{self.vps.get_pos_info_str()}]"


@register(DataStream, "velodyne-gen",
          help="synthesize standard 32-laser velodyne packets from frames")
class VelodyneGen(DataStream):
    src = Attr(DataStream, req=True, help="(32, n_azi) u16 frame source")
    fov_center = Attr(float, default=0.0)
    azi_step = Attr(float, default=0.165, help="degrees per firing")
    timestamp_step = Attr(int, default=553, help="per-packet gps us step")
    timestamp_start = Attr(int, default=0)
    tot_lasers = Attr(int, default=32)
    laser_to_row_ix_str = Attr(str, default="", help="'' | 'default-32'")

    def data_stream_init(self):
        self.src.data_stream_init()
        if self.tot_lasers != 32:
            raise RtErr("velodyne-gen: only the standard 32-laser output "
                        "is implemented (reference :739)")
        self._l2r = (default_32_laser_to_row()
                     if self.laser_to_row_ix_str == "default-32"
                     else list(range(32)))
        self._pend_fbs: list[bytes] = []
        self._ts = self.timestamp_start
        self._n = 0

    def _consume_frame(self, v: np.ndarray) -> None:
        lasers, n_azi = v.shape
        if lasers != self.tot_lasers:
            raise RtErr(f"velodyne-gen: configured tot_lasers="
                        f"{self.tot_lasers} but got frame with {lasers}")
        for ai in range(n_azi):
            deg = self.fov_center + self.azi_step * (ai - n_azi / 2.0)
            if deg < 0.0:
                deg += 360.0
            if not (0.0 <= deg < 360.0):
                raise RtErr(f"velodyne-gen: azimuth {deg} out of [0,360)")
            rot = int(deg * 100)
            lis = bytearray()
            for i in range(32):
                lis += struct.pack("<HB", int(v[self._l2r[i], ai]), 90)
            self._pend_fbs.append(struct.pack("<HH", BLOCK_IDS[0], rot)
                                  + bytes(lis))

    def proc_block(self, db: DataBlock) -> DataBlock:
        while len(self._pend_fbs) < 12:
            fr = self.src.proc_block(DataBlock())
            if not fr.valid():
                return DataBlock()  # note: partial trailing packet dropped
            self._consume_frame(np.asarray(fr.nda.v, np.uint16))
        fbs, self._pend_fbs = self._pend_fbs[:12], self._pend_fbs[12:]
        # HDL32E status bytes (reference :858-863: constant type=7 val=33)
        status = struct.pack("<IBB", self._ts, 7, 33)
        self._ts += self.timestamp_step
        if self._ts >= 3600 * 1000 * 1000:
            self._ts -= 3600 * 1000 * 1000
        pkt = b"".join(fbs) + status
        assert len(pkt) == PACKET_SZ
        out = DataBlock(nda=NDA(Dims.make(tn="uint8_t", v=PACKET_SZ),
                                np.frombuffer(pkt, np.uint8).copy()),
                        tag="velodyne-gen", frame_ix=self._n)
        self._n += 1
        return out

    def get_pos_info_str(self) -> str:
        return f"velodyne-gen: {self._n} pkts"


@register(DataStream, "velo-pcdm-to-xyz",
          help="lidar frames -> (laser, samp, 3) float32 XYZ point clouds")
class VeloToXyz(DataStream):
    dist_scale = Attr(float, default=0.002, help="raw distance -> meters")
    x_offset = Attr(float, default=0.0)
    y_offset = Attr(float, default=0.0)
    z_offset = Attr(float, default=0.0)
    azi_step = Attr(float, default=0.0, help="used when no azi subblock")
    fov_center = Attr(float, default=0.0)

    def proc_block(self, db: DataBlock) -> DataBlock:
        if not db.valid() or db.nda is None:
            return db
        v = np.asarray(db.nda.v)
        lasers, n = v.shape
        if lasers != 32:
            raise RtErr("velo-pcdm-to-xyz: only the default HDL-32 "
                        "elevation spread is implemented (the reference "
                        "required an xml config for 64-laser data)")
        # default HDL-32 corrs: scanline top at +10.67 deg, step -4/3
        elev = np.deg2rad(10.67 - (4.0 / 3.0) * np.arange(lasers))
        azi_sb = None
        for sb in (db.subblocks or []):
            if sb.meta == "azi" or sb.tag == "azi":
                azi_sb = np.asarray(sb.nda.v, np.float64) / 100.0
        if azi_sb is None:
            step = self.azi_step or 0.165
            azi_sb = self.fov_center + step * (np.arange(n) - n / 2.0)
        azi = np.deg2rad(azi_sb)
        dist = v.astype(np.float32) * self.dist_scale
        xy = dist * np.cos(elev)[:, None]
        xyz = np.stack([xy * np.sin(azi)[None, :] + self.x_offset,
                        xy * np.cos(azi)[None, :] + self.y_offset,
                        dist * np.sin(elev)[:, None] + self.z_offset],
                       axis=-1).astype(np.float32)
        out = db.clone()
        out.nda = NDA(Dims.make(tn="float", y=lasers, x=n, xyz=3), xyz)
        out.meta = "pointcloud"
        return out

    def get_pos_info_str(self) -> str:
        return "velo-pcdm-to-xyz"


@register(DataStream, "velo-frame-gen",
          help="synthetic (lasers, n_azi) u16 lidar frames (test source)")
class VeloFrameGen(DataStream):
    """Deterministic lidar-frame source (v[r,c] = r*500 + c), the
    velodyne analog of test-gen — feeds velodyne-gen for self-contained
    pipeline tests/goldens (the reference used velodyne-gen the same
    way, data-stream-velo.cc:706)."""

    num = Attr(int, default=4)
    n_azi = Attr(int, default=192)
    lasers = Attr(int, default=32)

    def data_stream_init(self):
        self._i = 0

    def proc_block(self, db: DataBlock) -> DataBlock:
        if self._i >= self.num:
            return DataBlock()
        r = np.arange(self.lasers, dtype=np.uint16)[:, None]
        c = np.arange(self.n_azi, dtype=np.uint16)[None, :]
        v = (r * 500 + c).astype(np.uint16)
        self._i += 1
        return DataBlock(nda=NDA(Dims.make(tn="uint16_t", y=self.lasers,
                                           x=self.n_azi), v),
                         tag="frame", frame_ix=self._i - 1,
                         timestamp_ns=self._i * 1000)

    def get_pos_info_str(self) -> str:
        return f"velo-frame-gen: {self._i}"


@mode("test_velo_crc", help="check the velodyne crc16 implementation")
class TestVeloCrc(HasMain):
    out_fn = Attr(str, default="test-velo-crc.txt")
    hex_input = Attr(str, default="0607")
    hex_crc = Attr(str, default="9411", help="expected crc (2 bytes hex)")

    def main(self):
        data = bytes.fromhex(self.hex_input)
        want = bytes.fromhex(self.hex_crc)
        if len(want) != 2:
            raise RtErr(f"hex_crc={self.hex_crc} must be exactly 2 bytes")
        expected = (want[0] << 8) | want[1]
        calc = velo_crc(data)
        with open(self.out_path(self.out_fn), "w") as f:
            f.write(f"calc_crc={calc:x} expected_crc={expected:x}\n")
            f.write("OK\n" if calc == expected else "FAIL\n")
        print(f"test_velo_crc: calc={calc:x} expected={expected:x} "
              + ("OK" if calc == expected else "FAIL"))
