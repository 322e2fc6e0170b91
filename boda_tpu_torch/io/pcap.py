"""pcap stream stages: packet-capture file reader/writer.

The port's copy of boda_tpu/io/pcap.py.

Reference parity: data-stream-pcap.cc (pcap-src :115-253, pcap-sink
:257-334): libpcap file framing (global header magic 0xa1b2c3d4 v2.4 +
per-record ts_sec/ts_usec/incl_len/orig_len), one block per packet, and
the `extract_udp_payload` path — ethernet/IPv4/UDP parse with the
reference's limited in-order IP defragmentation (fragments must arrive
in order, one pending datagram; mismatched fragments are dropped with a
warning, non-contiguous ones are errors) and optional dest-port filter.
The sink can prepend the same synthetic 42-byte eth+IPv4+UDP header the
reference generates (add_header=1; checksummed IPv4, configurable UDP
ports) so sink→src round-trips exercise the extraction path.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from ..core.config import Attr, register
from ..core.dims import NDA, Dims
from ..core.error import RtErr
from .data_stream import DataBlock, DataStream, resolve_stage_fn

PCAP_MAGIC = 0xA1B2C3D4
_GHDR = struct.Struct("<IHHiIII")   # magic, vmaj, vmin, thiszone, sigfigs, snaplen, network
_RHDR = struct.Struct("<IIII")      # ts_sec, ts_usec, incl_len, orig_len
ETHERTYPE_IPV4 = 0x0800
IPPROTO_UDP = 17


def _ip_cksum(data: bytes) -> int:
    s = 0
    for i in range(0, len(data) - 1, 2):
        s += data[i] | (data[i + 1] << 8)
    if len(data) % 2:
        s += data[-1]
    s = (s >> 16) + (s & 0xFFFF)
    s += s >> 16
    return (~s) & 0xFFFF


def _u8_nda(data: bytes) -> NDA:
    return NDA(Dims.make(tn="uint8_t", v=len(data)),
               np.frombuffer(data, np.uint8).copy())


@register(DataStream, "pcap-src",
          help="one block per pcap packet (optional eth/IPv4/UDP payload "
               "extraction with in-order defragmentation)")
class PcapSrc(DataStream):
    fn = Attr(str, req=True, help="input .pcap file")
    extract_udp_payload = Attr(bool, default=False,
                               help="assume ethernet+IPv4+UDP; emit payloads")
    udp_dest_port = Attr(int, default=0,
                         help="with extract_udp_payload: keep only this "
                              "dest port (0 = all)")

    def data_stream_init(self):
        self._buf = Path(resolve_stage_fn(self.fn)).read_bytes()
        self._src_init()

    def _src_init(self):
        if len(self._buf) < _GHDR.size:
            raise RtErr("pcap-src: file shorter than the global header")
        magic, vmaj, vmin, _tz, _sf, snap, net = _GHDR.unpack_from(self._buf, 0)
        if magic != PCAP_MAGIC:
            raise RtErr(f"pcap-src: expected pcap magic {PCAP_MAGIC:#x}, "
                        f"got {magic:#x}")
        self._hdr = (vmaj, vmin, snap, net)
        self._off = _GHDR.size
        self._ix = 0
        self._frag = b""       # in-progress IP datagram payload
        self._frag_id = None   # (src, dst, id, proto)

    def seek_to_block(self, frame_ix: int) -> bool:
        if frame_ix != 0:
            return False       # reference: restart only
        self._src_init()
        return True

    def _emit(self, payload: bytes, ts_ns: int) -> DataBlock:
        db = DataBlock(nda=_u8_nda(payload), tag="pcap",
                       frame_ix=self._ix, timestamp_ns=ts_ns)
        self._ix += 1
        return db

    def proc_block(self, db: DataBlock) -> DataBlock:
        while True:
            if self._off >= len(self._buf):
                return DataBlock()
            ts_sec, ts_usec, incl, _orig = _RHDR.unpack_from(self._buf, self._off)
            self._off += _RHDR.size
            pkt = self._buf[self._off:self._off + incl]
            self._off += incl
            ts_ns = ts_sec * 1_000_000_000 + ts_usec * 1_000
            if not self.extract_udp_payload:
                return self._emit(pkt, ts_ns)
            # --- ethernet ---
            if len(pkt) < 14:
                raise RtErr("pcap-src: truncated ethernet header")
            ethertype = (pkt[12] << 8) | pkt[13]
            if ethertype != ETHERTYPE_IPV4:
                raise RtErr(f"pcap-src: expected IPv4 ethertype, got "
                            f"{ethertype:#x}")
            # --- IPv4 ---
            ip = pkt[14:]
            ver, ihl = ip[0] >> 4, ip[0] & 0xF
            if ver != 4:
                raise RtErr(f"pcap-src: expected IPv4 packet, got v{ver}")
            if ihl < 5:
                raise RtErr(f"pcap-src: bad IPv4 header length {ihl}")
            # honor the IPv4 total-length field: NICs pad frames to the
            # 60-byte ethernet minimum and the trailer would otherwise
            # leak into the emitted payload
            tot_len = (ip[2] << 8) | ip[3]
            if tot_len < ihl * 4 or tot_len > len(ip):
                raise RtErr(f"pcap-src: bad IPv4 total length {tot_len}")
            ip = ip[:tot_len]
            ip_id = (ip[4] << 8) | ip[5]
            ip_off_f = (ip[6] << 8) | ip[7]
            frag_off = (ip_off_f & 0x1FFF) << 3
            ip_mf = bool(ip_off_f & 0x2000)
            proto = ip[9]
            src, dst = ip[12:16], ip[16:20]
            payload = ip[ihl * 4:]
            if ip_mf or frag_off or self._frag:
                fid = (bytes(src), bytes(dst), ip_id, proto)
                if not self._frag:
                    if frag_off != 0:
                        # capture started mid-datagram (or dropped the
                        # first fragment): unreassemblable — drop it
                        print("warning: pcap-src dropping fragment with "
                              "no in-progress datagram (frag_off "
                              f"{frag_off} != 0)")
                        continue
                    self._frag_id = fid
                else:
                    if self._frag_id != fid:
                        print("warning: pcap-src dropping fragment with "
                              "mismatched id vs in-progress datagram")
                        continue
                    if frag_off != len(self._frag):
                        raise RtErr(f"pcap-src: non-contiguous ip fragment: "
                                    f"have {len(self._frag)} bytes, next "
                                    f"offset {frag_off}")
                self._frag += payload
                if ip_mf:
                    continue
                payload, self._frag, self._frag_id = self._frag, b"", None
            # --- UDP ---
            if proto != IPPROTO_UDP:
                continue  # reference skips non-UDP after defrag
            if len(payload) < 8:
                raise RtErr("pcap-src: truncated UDP header")
            dport = (payload[2] << 8) | payload[3]
            if self.udp_dest_port and dport != self.udp_dest_port:
                continue
            return self._emit(payload[8:], ts_ns)

    def get_pos_info_str(self) -> str:
        return f"pcap-src: {self._ix} pkts, byte {self._off}/{len(self._buf)}"


@register(DataStream, "pcap-sink",
          help="write blocks as pcap packets (optional synthetic "
               "eth/IPv4/UDP header)")
class PcapSink(DataStream):
    fn = Attr(str, default="out.pcap")
    add_header = Attr(bool, default=False,
                      help="prepend a synthetic 42-byte eth+IPv4+UDP header")
    header_udp_sport = Attr(int, default=443)
    header_udp_dport = Attr(int, default=2368)

    def data_stream_init(self):
        self._f = open(resolve_stage_fn(self.fn), "wb")
        self._f.write(_GHDR.pack(PCAP_MAGIC, 2, 4, 0, 0, 1 << 18, 1))
        self._n = 0

    def proc_block(self, db: DataBlock) -> DataBlock:
        if not db.valid():
            self._f.flush()
            return db
        data = db.nda.v.tobytes() if db.nda is not None else b""
        ts_us = (db.timestamp_ns or 0) // 1000
        hdr = b""
        if self.add_header:
            eth = b"\0" * 12 + struct.pack(">H", ETHERTYPE_IPV4)
            ip_wo_ck = bytes([0x45, 0]) + struct.pack(
                ">HHHBB", 20 + 8 + len(data), 1, 0, 128, IPPROTO_UDP) \
                + b"\0\0" + b"\0" * 8
            ck = _ip_cksum(ip_wo_ck)
            ip = ip_wo_ck[:10] + struct.pack("<H", ck) + ip_wo_ck[12:]
            udp = struct.pack(">HHHH", self.header_udp_sport,
                              self.header_udp_dport, 8 + len(data), 0)
            hdr = eth + ip + udp
        rec = hdr + data
        self._f.write(_RHDR.pack(ts_us // 1_000_000, ts_us % 1_000_000,
                                 len(rec), len(rec)))
        self._f.write(rec)
        self._n += 1
        return db

    def get_pos_info_str(self) -> str:
        return f"pcap-sink: wrote {self._n} pkts"
