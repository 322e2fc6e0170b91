"""Composable data-stream framework: timestamped, tagged tensor blocks
flowing through source/xform/sink stages.

The port's copy of boda_tpu/io/data_stream.py. Capability parity with the
reference's data-stream core (data-stream.H:25-115, data-stream.cc:81-976):
`DataBlock` (nda + tag/meta/frame_ix/timestamp_ns + named and indexed
subblocks), a polymorphic `DataStream` stage interface (`proc_block`,
`seek_to_block`, `get_pos_info_str`) selected by `mode=`, and the
composable stage library: start-stop-skip, pipe, merge, ts-merge, sync,
flatten, fold, stamp, crop, sort-by-ts, pass, text-src/sink, csv-src,
raw-file-src, test-gen, hash-check, stream-src/stream-sink, the mxnet
brick source and sink, plus the top-level `scan_data_stream` driver. The
stages are host code; the serving stages that run a net (`zmq-det`,
`cnet-infer`) are in apps/.

Stage conventions (reference data-stream.H:84-93): sources are called with
an empty block and produce data as a side effect of reading; sinks echo
their input; xforms transform/filter. An invalid (empty) returned block
means end-of-stream.

Additions of the JAX package kept here: a `batch` stage that stacks N
blocks into one batched nda (the feed path for run_cnet-style engines),
and `npy-src`/`npy-sink` for zero-copy numpy interchange. stream-src's
spawned producer is `python -m boda_tpu_torch scan_data_stream`.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np

from ..core.config import Attr, Config, register
from ..core.dims import NDA, Dims
from ..core.error import RtErr
from ..core.has_main import HasMain, mode

_INVALID = np.uint64(0xFFFFFFFFFFFFFFFF)


class DataBlock:
    """One stream element (reference: data_block_t, data-stream.H:25-80)."""

    __slots__ = ("nda", "tag", "meta", "frame_ix", "timestamp_ns",
                 "subblocks", "named")

    def __init__(self, nda: Optional[NDA] = None, tag: str = "", meta: str = "",
                 frame_ix: Optional[int] = None, timestamp_ns: Optional[int] = None):
        self.nda = nda
        self.tag = tag
        self.meta = meta
        self.frame_ix = frame_ix
        self.timestamp_ns = timestamp_ns
        self.subblocks: Optional[list[DataBlock]] = None  # indexed
        self.named: Optional[dict[str, DataBlock]] = None  # by tag

    def valid(self) -> bool:
        return (self.nda is not None or self.subblocks is not None
                or self.named is not None)

    def sz_bytes(self) -> int:
        return 0 if self.nda is None else self.nda.v.nbytes

    def ensure_has_subblocks(self) -> None:
        if self.subblocks is None:
            self.subblocks = []

    def num_subblocks(self) -> int:
        return len(self.subblocks) if self.subblocks is not None else 0

    def set_sdb(self, sdb: "DataBlock") -> None:
        if not sdb.tag:
            raise RtErr("set_sdb: subblock must have a tag")
        if self.named is None:
            self.named = {}
        self.named[sdb.tag] = sdb

    def get_sdb(self, tag: str) -> Optional["DataBlock"]:
        return None if self.named is None else self.named.get(tag)

    def clone(self) -> "DataBlock":
        ret = DataBlock(self.nda, self.tag, self.meta, self.frame_ix,
                        self.timestamp_ns)
        if self.subblocks is not None:
            ret.subblocks = [sb.clone() for sb in self.subblocks]
        if self.named is not None:
            ret.named = {k: v.clone() for k, v in self.named.items()}
        return ret

    def info_str(self) -> str:
        parts = []
        if self.tag:
            parts.append(f"tag={self.tag}")
        if self.meta:
            parts.append(f"meta={self.meta}")
        if self.frame_ix is not None:
            parts.append(f"frame_ix={self.frame_ix}")
        if self.timestamp_ns is not None:
            parts.append(f"ts={self.timestamp_ns}")
        if self.nda is not None:
            parts.append(f"dims={self.nda.dims.pretty()}")
        if self.subblocks is not None:
            parts.append(f"subblocks={len(self.subblocks)}")
            for sb in self.subblocks:
                parts.append("[" + sb.info_str() + "]")
        if self.named is not None:
            for k in sorted(self.named):
                parts.append(f"{k}:[{self.named[k].info_str()}]")
        return " ".join(parts) if parts else "(invalid)"


def make_nda_db(tag: str, nda: NDA, **kw) -> DataBlock:
    return DataBlock(nda=nda, tag=tag, **kw)


class DataStream(Config):
    """One stream stage (reference: data_stream_t, data-stream.H:96-115)."""

    TID_KEY = "mode"

    def data_stream_init(self) -> None:
        pass

    def proc_block(self, db: DataBlock) -> DataBlock:
        raise NotImplementedError

    def seek_to_block(self, frame_ix: int) -> bool:
        return False  # by default, not implemented / fails

    def get_pos_info_str(self) -> str:
        return "<no-pos-info>"

    def stream_eof(self) -> None:
        """End-of-scan notification. Sinks that buffer until EOF override
        this to finalize (and still finalize on an in-band invalid block —
        the pipe-flow EOF convention); the default recurses into child
        stages declared as Attrs so the notification reaches sinks nested
        anywhere in a stage tree."""
        for name in self._attrs:
            v = getattr(self, name, None)
            if isinstance(v, DataStream):
                v.stream_eof()
            elif isinstance(v, list):
                for s in v:
                    if isinstance(s, DataStream):
                        s.stream_eof()


def make_data_stream(spec) -> DataStream:
    from ..core.lexp import Lexp
    if isinstance(spec, dict):
        spec = Lexp.from_obj(spec)
    ds = DataStream.init_from_lexp(spec)
    ds.data_stream_init()
    return ds


def read_all_blocks(ds: DataStream, max_blocks: int = 1 << 40) -> list[DataBlock]:
    out = []
    while len(out) < max_blocks:
        db = ds.proc_block(DataBlock())
        if not db.valid():
            break
        out.append(db)
    return out


# ---------------- sources ----------------

@register(DataStream, "text-src", help="one block per line of a text file")
class TextSrc(DataStream):
    fn = Attr(str, req=True, help="input text file")
    tag = Attr(str, default="text", help="tag for output blocks")

    def data_stream_init(self):
        self._lines = Path(self.fn).read_text().splitlines()
        self._ix = 0

    def proc_block(self, db: DataBlock) -> DataBlock:
        if self._ix >= len(self._lines):
            return DataBlock()
        raw = np.frombuffer(self._lines[self._ix].encode(), dtype=np.uint8).copy()
        ret = DataBlock(NDA(Dims.make(tn="uint8_t", v=max(raw.size, 1)),
                            raw if raw.size else np.zeros(1, np.uint8)),
                        tag=self.tag, frame_ix=self._ix, timestamp_ns=self._ix)
        self._ix += 1
        return ret

    def seek_to_block(self, frame_ix: int) -> bool:
        if frame_ix > len(self._lines):
            return False
        self._ix = frame_ix
        return True

    def get_pos_info_str(self) -> str:
        return f"text-src: line {self._ix}/{len(self._lines)}"


@register(DataStream, "csv-src", help="one float-vector block per CSV row")
class CsvSrc(DataStream):
    fn = Attr(str, req=True, help="input csv file")
    tag = Attr(str, default="csv")
    skip_rows = Attr(int, default=0, help="header rows to skip")
    ts_col = Attr(int, default=-1,
                  help="column holding timestamp_ns (-1: use row index)")

    def data_stream_init(self):
        rows = []
        with open(self.fn) as f:
            for i, line in enumerate(f):
                if i < self.skip_rows or not line.strip():
                    continue
                rows.append([float(v) for v in line.strip().split(",")])
        self._rows = rows
        self._ix = 0

    def proc_block(self, db: DataBlock) -> DataBlock:
        if self._ix >= len(self._rows):
            return DataBlock()
        row = self._rows[self._ix]
        ts = int(row[self.ts_col]) if self.ts_col >= 0 else self._ix
        v = np.asarray(row, dtype=np.float32)
        ret = DataBlock(NDA(Dims.make(tn="float", v=v.size), v), tag=self.tag,
                        frame_ix=self._ix, timestamp_ns=ts)
        self._ix += 1
        return ret

    def seek_to_block(self, frame_ix: int) -> bool:
        if frame_ix > len(self._rows):
            return False
        self._ix = frame_ix
        return True

    def get_pos_info_str(self) -> str:
        return f"csv-src: row {self._ix}/{len(self._rows)}"


@register(DataStream, "raw-file-src",
          help="fixed-size binary frames from a raw file")
class RawFileSrc(DataStream):
    """Reference: the stream-src/tagged-frames file framing readers
    (data-stream-file.{H,cc})."""

    fn = Attr(str, req=True, help="input binary file")
    frame_sz = Attr(int, req=True, help="bytes per frame")
    tag = Attr(str, default="raw")
    meta = Attr(str, default="")

    def data_stream_init(self):
        self._f = open(self.fn, "rb")
        self._sz = os.fstat(self._f.fileno()).st_size
        if self._sz % self.frame_sz:
            raise RtErr(f"raw-file-src: file size {self._sz} not a multiple "
                        f"of frame_sz {self.frame_sz}")
        self._n = self._sz // self.frame_sz
        self._ix = 0

    def proc_block(self, db: DataBlock) -> DataBlock:
        if self._ix >= self._n:
            return DataBlock()
        raw = np.frombuffer(self._f.read(self.frame_sz), dtype=np.uint8).copy()
        ret = DataBlock(NDA(Dims.make(tn="uint8_t", v=raw.size), raw),
                        tag=self.tag, meta=self.meta, frame_ix=self._ix,
                        timestamp_ns=self._ix)
        self._ix += 1
        return ret

    def seek_to_block(self, frame_ix: int) -> bool:
        if frame_ix > self._n:
            return False
        self._f.seek(frame_ix * self.frame_sz)
        self._ix = frame_ix
        return True

    def get_pos_info_str(self) -> str:
        return f"raw-file-src: frame {self._ix}/{self._n}"


@register(DataStream, "npy-src", help="frames from axis 0 of a .npy stack")
class NpySrc(DataStream):
    fn = Attr(str, req=True, help="input .npy file (N x ...)")
    tag = Attr(str, default="npy")

    def data_stream_init(self):
        self._arr = np.load(self.fn, mmap_mode="r")
        self._ix = 0

    def proc_block(self, db: DataBlock) -> DataBlock:
        if self._ix >= self._arr.shape[0]:
            return DataBlock()
        from ..core.dims import dtype_to_tn
        v = np.ascontiguousarray(self._arr[self._ix])
        dims = Dims([(f"d{i}", s) for i, s in enumerate(v.shape)],
                    tn=dtype_to_tn(v.dtype))
        ret = DataBlock(NDA(dims, v), tag=self.tag, frame_ix=self._ix,
                        timestamp_ns=self._ix)
        self._ix += 1
        return ret

    def seek_to_block(self, frame_ix: int) -> bool:
        if frame_ix > self._arr.shape[0]:
            return False
        self._ix = frame_ix
        return True

    def get_pos_info_str(self) -> str:
        return f"npy-src: frame {self._ix}/{self._arr.shape[0]}"


@register(DataStream, "test-gen", help="deterministic synthetic blocks")
class TestGen(DataStream):
    num = Attr(int, default=10, help="number of blocks to generate")
    sz = Attr(int, default=16, help="elements per block")
    dt_ns = Attr(int, default=1000, help="timestamp step")
    t0_ns = Attr(int, default=0, help="first timestamp")
    tag = Attr(str, default="test-gen")

    def data_stream_init(self):
        self._ix = 0

    def proc_block(self, db: DataBlock) -> DataBlock:
        if self._ix >= self.num:
            return DataBlock()
        v = (np.arange(self.sz, dtype=np.float32) + self._ix * 100.0)
        ret = DataBlock(NDA(Dims.make(tn="float", v=self.sz), v), tag=self.tag,
                        frame_ix=self._ix,
                        timestamp_ns=self.t0_ns + self._ix * self.dt_ns)
        self._ix += 1
        return ret

    def seek_to_block(self, frame_ix: int) -> bool:
        self._ix = min(frame_ix, self.num)
        return True

    def get_pos_info_str(self) -> str:
        return f"test-gen: {self._ix}/{self.num}"


# ---------------- xforms ----------------

@register(DataStream, "start-stop-skip",
          help="skip initial blocks / subsample / limit count")
class StartStopSkip(DataStream):
    """Reference: data_stream_start_stop_skip_t (data-stream.cc:80-116)."""

    src = Attr(DataStream, req=True, help="wrapped source")
    start_block = Attr(int, default=0, help="start at this block")
    skip_blocks = Attr(int, default=0, help="drop this many after each returned")
    num_to_read = Attr(int, default=0, help="max blocks; 0 = unlimited")

    def data_stream_init(self):
        self.src.data_stream_init()
        self._read = 0
        if not (self.start_block and self.src.seek_to_block(self.start_block)):
            for _ in range(self.start_block):
                self.src.proc_block(DataBlock())

    def proc_block(self, db: DataBlock) -> DataBlock:
        if self.num_to_read and self._read >= self.num_to_read:
            return DataBlock()
        ret = self.src.proc_block(db)
        if not ret.valid():
            return ret
        self._read += 1
        for _ in range(self.skip_blocks):
            self.src.proc_block(DataBlock())
        return ret

    def get_pos_info_str(self) -> str:
        return (f"start-stop-skip: read {self._read} "
                f"[{self.src.get_pos_info_str()}]")


@register(DataStream, "pipe", help="chain stages: block flows through each")
class Pipe(DataStream):
    stages = Attr(list[DataStream], req=True, help="stages in order")

    def data_stream_init(self):
        for s in self.stages:
            s.data_stream_init()

    def proc_block(self, db: DataBlock) -> DataBlock:
        # an invalid block still flows through the remaining stages so
        # sinks see EOF (stateless stages echo invalid blocks unchanged)
        for s in self.stages:
            db = s.proc_block(db)
        return db

    def seek_to_block(self, frame_ix: int) -> bool:
        return bool(self.stages) and self.stages[0].seek_to_block(frame_ix)

    def get_pos_info_str(self) -> str:
        return " | ".join(s.get_pos_info_str() for s in self.stages)


@register(DataStream, "seq", help="concatenate sources end-to-end")
class Seq(DataStream):
    srcs = Attr(list[DataStream], req=True)

    def data_stream_init(self):
        for s in self.srcs:
            s.data_stream_init()
        self._cur = 0
        self._ix = 0

    def proc_block(self, db: DataBlock) -> DataBlock:
        while self._cur < len(self.srcs):
            b = self.srcs[self._cur].proc_block(DataBlock())
            if b.valid():
                b.frame_ix = self._ix
                self._ix += 1
                return b
            self._cur += 1
        return DataBlock()

    def get_pos_info_str(self) -> str:
        return f"seq[{self._cur}/{len(self.srcs)}]"


@register(DataStream, "pass", help="identity stage")
class PassStream(DataStream):
    def proc_block(self, db: DataBlock) -> DataBlock:
        return db

    def get_pos_info_str(self) -> str:
        return "pass"


@register(DataStream, "adj-angle",
          help="normalize angle data (degrees) to [-180,180) with offset")
class AdjAngle(DataStream):
    """Reference: data-stream.cc:944 (adj-angle) — elementwise
    (optionally negated) angle + offset, wrapped into [-180, 180)."""

    adj = Attr(float, default=0.0, help="offset to add (degrees)")
    negate = Attr(bool, default=False, help="negate input angle first")

    def proc_block(self, db: DataBlock) -> DataBlock:
        if db.valid():
            if db.nda is None:
                raise RtErr("can only adj-angle on data blocks with nda "
                            "data, but nda was null in input db.")
            db = db.clone()
            v = np.asarray(db.nda.v, np.float64)
            if self.negate:
                v = -v
            v = np.mod(v + self.adj + 180.0, 360.0) - 180.0
            db.nda = NDA(db.nda.dims, v.astype(db.nda.v.dtype))
        return db

    def get_pos_info_str(self) -> str:
        return f"adj-angle: adj={self.adj} <no-state>"


@register(DataStream, "merge",
          help="read one block from each source; emit with named subblocks")
class Merge(DataStream):
    srcs = Attr(list[DataStream], req=True)

    def data_stream_init(self):
        for s in self.srcs:
            s.data_stream_init()
        self._ix = 0

    def proc_block(self, db: DataBlock) -> DataBlock:
        ret = DataBlock(frame_ix=self._ix)
        for s in self.srcs:
            sb = s.proc_block(DataBlock())
            if not sb.valid():
                return DataBlock()  # any source EOF ends the merge
            ret.set_sdb(sb)
            if ret.timestamp_ns is None:
                ret.timestamp_ns = sb.timestamp_ns
        self._ix += 1
        return ret

    def get_pos_info_str(self) -> str:
        return "merge[" + "; ".join(s.get_pos_info_str() for s in self.srcs) + "]"


@register(DataStream, "ts-merge",
          help="merge N streams into timestamp order (k-way)")
class TsMerge(DataStream):
    srcs = Attr(list[DataStream], req=True)

    def data_stream_init(self):
        for s in self.srcs:
            s.data_stream_init()
        self._heads: list[Optional[DataBlock]] = [
            self._pull(s) for s in self.srcs]

    def _pull(self, s: DataStream) -> Optional[DataBlock]:
        b = s.proc_block(DataBlock())
        return b if b.valid() else None

    def proc_block(self, db: DataBlock) -> DataBlock:
        best = -1
        for i, h in enumerate(self._heads):
            if h is None:
                continue
            if best < 0 or (h.timestamp_ns or 0) < (self._heads[best].timestamp_ns or 0):
                best = i
        if best < 0:
            return DataBlock()
        ret = self._heads[best]
        self._heads[best] = self._pull(self.srcs[best])
        return ret

    def get_pos_info_str(self) -> str:
        return "ts-merge[" + "; ".join(s.get_pos_info_str() for s in self.srcs) + "]"


@register(DataStream, "sync",
          help="align secondary streams to a primary by nearest timestamp")
class Sync(DataStream):
    """Reference: the `sync` timestamp-alignment stage. Emits the primary
    block with each secondary's nearest-timestamp block attached as a named
    subblock; drops primary blocks when a secondary has no block within
    max_delta_ns."""

    primary = Attr(DataStream, req=True)
    secondary = Attr(list[DataStream], req=True)
    max_delta_ns = Attr(int, default=0, help="0 = unlimited")

    def data_stream_init(self):
        self.primary.data_stream_init()
        self._bufs: list[list[DataBlock]] = []
        for s in self.secondary:
            s.data_stream_init()
            self._bufs.append([])

    def _fill(self, i: int, up_to_ts: int) -> None:
        buf = self._bufs[i]
        while not buf or (buf[-1].timestamp_ns or 0) <= up_to_ts:
            b = self.secondary[i].proc_block(DataBlock())
            if not b.valid():
                break
            buf.append(b)

    def proc_block(self, db: DataBlock) -> DataBlock:
        while True:
            p = self.primary.proc_block(DataBlock())
            if not p.valid():
                return p
            pts = p.timestamp_ns or 0
            ok = True
            for i in range(len(self.secondary)):
                self._fill(i, pts)
                buf = self._bufs[i]
                if not buf:
                    ok = False
                    break
                best = min(buf, key=lambda b: abs((b.timestamp_ns or 0) - pts))
                delta = abs((best.timestamp_ns or 0) - pts)
                if self.max_delta_ns and delta > self.max_delta_ns:
                    ok = False
                    break
                # drop buffered blocks strictly older than the chosen one
                self._bufs[i] = [b for b in buf if (b.timestamp_ns or 0)
                                 >= (best.timestamp_ns or 0)]
                p.set_sdb(best)
            if ok:
                return p

    def get_pos_info_str(self) -> str:
        return f"sync[{self.primary.get_pos_info_str()}]"


@register(DataStream, "flatten", help="emit subblocks of each input one at a time")
class Flatten(DataStream):
    src = Attr(DataStream, req=True)

    def data_stream_init(self):
        self.src.data_stream_init()
        self._pend: list[DataBlock] = []

    def proc_block(self, db: DataBlock) -> DataBlock:
        while not self._pend:
            b = self.src.proc_block(DataBlock())
            if not b.valid():
                return DataBlock()
            if b.subblocks is not None:
                self._pend += b.subblocks
            elif b.named is not None:
                self._pend += [b.named[k] for k in sorted(b.named)]
            else:
                return b
        return self._pend.pop(0)

    def get_pos_info_str(self) -> str:
        return f"flatten[{self.src.get_pos_info_str()}]"


@register(DataStream, "fold", help="group N blocks into one with indexed subblocks")
class Fold(DataStream):
    src = Attr(DataStream, req=True)
    n = Attr(int, req=True, help="blocks per group")

    def data_stream_init(self):
        self.src.data_stream_init()
        self._ix = 0

    def proc_block(self, db: DataBlock) -> DataBlock:
        ret = DataBlock(frame_ix=self._ix)
        ret.ensure_has_subblocks()
        for _ in range(self.n):
            b = self.src.proc_block(DataBlock())
            if not b.valid():
                break
            ret.subblocks.append(b)
        if not ret.subblocks:
            return DataBlock()
        ret.timestamp_ns = ret.subblocks[0].timestamp_ns
        self._ix += 1
        return ret

    def get_pos_info_str(self) -> str:
        return f"fold(n={self.n})[{self.src.get_pos_info_str()}]"


@register(DataStream, "stamp", help="assign timestamps at a fixed rate")
class Stamp(DataStream):
    t0_ns = Attr(int, default=0)
    dt_ns = Attr(int, default=1000000)

    def data_stream_init(self):
        self._ix = 0

    def proc_block(self, db: DataBlock) -> DataBlock:
        if db.valid():
            db.timestamp_ns = self.t0_ns + self._ix * self.dt_ns
            if db.frame_ix is None:
                db.frame_ix = self._ix
            self._ix += 1
        return db

    def get_pos_info_str(self) -> str:
        return f"stamp@{self._ix}"


@register(DataStream, "crop", help="crop the last two dims of each block's nda")
class Crop(DataStream):
    y0 = Attr(int, default=0)
    x0 = Attr(int, default=0)
    ysz = Attr(int, req=True)
    xsz = Attr(int, req=True)

    def proc_block(self, db: DataBlock) -> DataBlock:
        if db.valid() and db.nda is not None and len(db.nda.dims) >= 2:
            v = db.nda.v
            v = v[..., self.y0:self.y0 + self.ysz, self.x0:self.x0 + self.xsz]
            names = db.nda.dims.names()
            dims = Dims([(n, v.shape[i]) for i, n in enumerate(names)],
                        tn=db.nda.dims.tn)
            db = db.clone()
            db.nda = NDA(dims, np.ascontiguousarray(v))
        return db

    def get_pos_info_str(self) -> str:
        return "crop"


@register(DataStream, "sort-by-ts",
          help="windowed reorder into timestamp order")
class SortByTs(DataStream):
    src = Attr(DataStream, req=True)
    window = Attr(int, default=16, help="lookahead window size")

    def data_stream_init(self):
        self.src.data_stream_init()
        self._buf: list[DataBlock] = []
        self._eof = False

    def proc_block(self, db: DataBlock) -> DataBlock:
        while not self._eof and len(self._buf) < self.window:
            b = self.src.proc_block(DataBlock())
            if not b.valid():
                self._eof = True
                break
            self._buf.append(b)
        if not self._buf:
            return DataBlock()
        i = min(range(len(self._buf)),
                key=lambda j: self._buf[j].timestamp_ns or 0)
        return self._buf.pop(i)

    def get_pos_info_str(self) -> str:
        return f"sort-by-ts(buf={len(self._buf)})"


@register(DataStream, "batch",
          help="stack N blocks into one batched nda (device feed path)")
class Batch(DataStream):
    """Builds fixed-size batches for an engine: one batch shape per run
    (the JAX package's stage, where static shapes keep XLA from
    recompiling)."""

    src = Attr(DataStream, req=True)
    n = Attr(int, req=True, help="batch size")
    drop_partial = Attr(bool, default=True,
                        help="drop a final short batch (keeps shapes static)")

    def data_stream_init(self):
        self.src.data_stream_init()
        self._ix = 0

    def proc_block(self, db: DataBlock) -> DataBlock:
        vs, last = [], None
        for _ in range(self.n):
            b = self.src.proc_block(DataBlock())
            if not b.valid():
                break
            if b.nda is None:
                raise RtErr("batch: input block has no nda")
            vs.append(b.nda.v)
            last = b
        if not vs or (self.drop_partial and len(vs) < self.n):
            return DataBlock()
        v = np.stack(vs)
        dims = Dims([("img", v.shape[0])]
                    + list(zip(last.nda.dims.names(), v.shape[1:])),
                    tn=last.nda.dims.tn)
        ret = DataBlock(NDA(dims, v), tag=last.tag, frame_ix=self._ix,
                        timestamp_ns=last.timestamp_ns)
        self._ix += 1
        return ret

    def get_pos_info_str(self) -> str:
        return f"batch(n={self.n})@{self._ix}"


# ---------------- sinks ----------------

@register(DataStream, "text-sink", help="write each block's info line to a file")
class TextSink(DataStream):
    fn = Attr(str, req=True)

    def data_stream_init(self):
        self._f = open(resolve_stage_fn(self.fn), "w")
        self._n = 0

    def proc_block(self, db: DataBlock) -> DataBlock:
        if db.valid():
            self._f.write(db.info_str() + "\n")
            self._f.flush()
            self._n += 1
        return db

    def get_pos_info_str(self) -> str:
        return f"text-sink: wrote {self._n}"


@register(DataStream, "npy-sink", help="collect blocks; save stacked .npy at EOF")
class NpySink(DataStream):
    fn = Attr(str, req=True)

    def data_stream_init(self):
        self._vs: list[np.ndarray] = []
        self._saved = False

    def proc_block(self, db: DataBlock) -> DataBlock:
        if db.valid() and db.nda is not None:
            self._vs.append(db.nda.v)
        elif not db.valid():
            self.stream_eof()
        return db

    def stream_eof(self) -> None:
        if not self._saved:
            np.save(resolve_stage_fn(self.fn),
                    np.stack(self._vs) if self._vs else np.zeros(0))
            self._saved = True

    def get_pos_info_str(self) -> str:
        return f"npy-sink: {len(self._vs)} buffered"


# ---------------- driver mode ----------------

_STAGE_OUT_DIR: "contextvars.ContextVar" = None  # set lazily below


def _ensure_ctx():
    global _STAGE_OUT_DIR
    if _STAGE_OUT_DIR is None:
        import contextvars
        _STAGE_OUT_DIR = contextvars.ContextVar("boda_stage_out_dir",
                                                default=None)
    return _STAGE_OUT_DIR


def resolve_stage_fn(fn: str) -> str:
    """Resolve a stage's relative file path against the driving mode's
    output dir (HasMain.out_path convention): stream stages aren't modes,
    so without this their outputs leak into the CWD (the reference's
    stages had the same cwd-relative behavior, but our golden harness
    requires outputs under boda_output_dir)."""
    import os
    d = _ensure_ctx().get()
    if d is None or os.path.isabs(fn):
        return fn
    return os.path.join(d, fn)


@mode("scan_data_stream",
      help="run a data stream to EOF; print per-block info + totals")
class ScanDataStream(HasMain):
    """Reference: the scan-data-stream top-level driver (data-stream.cc)."""

    stream = Attr(DataStream, req=True, help="stream spec to scan")
    verbose = Attr(bool, default=True, help="print per-block info lines")
    max_blocks = Attr(int, default=0, help="stop after this many (0: all)")

    def main(self):
        tok = _ensure_ctx().set(str(self.out_path(".")))
        try:
            self._scan()
        finally:
            _ensure_ctx().reset(tok)

    def _scan(self):
        self.stream.data_stream_init()
        n = 0
        tot_bytes = 0
        last_ts = None
        while not self.max_blocks or n < self.max_blocks:
            db = self.stream.proc_block(DataBlock())
            if not db.valid():
                # give sinks their EOF notification
                self.stream.proc_block(DataBlock())
                break
            if self.verbose:
                print(f"block[{n}]: {db.info_str()}")
            n += 1
            tot_bytes += db.sz_bytes()
            last_ts = db.timestamp_ns
        # end-of-scan finalization: a max_blocks-limited scan never flows
        # an invalid block through the pipe (and pushing one would PULL a
        # fresh block from any source-headed pipe), so sinks finalize via
        # the explicit stream_eof protocol instead
        self.stream.stream_eof()
        print(f"scan-data-stream: {n} blocks, {tot_bytes} bytes, "
              f"last_ts={last_ts} pos=[{self.stream.get_pos_info_str()}]")


@register(DataStream, "hash-check",
          help="digest each block; record to or verify against a file")
class HashCheck(DataStream):
    """Reference: the hash-check stream stage (data-stream.cc type_id
    'hash-check') — content-integrity checking over a stream, rebuilt on
    the nda-digest machinery."""

    fn = Attr(str, req=True, help="digest file (one lexp per block)")
    write = Attr(bool, default=False, help="record mode (else verify)")
    mrd_toler = Attr(float, default=0.0, help="0 = exact qhash match")

    def data_stream_init(self):
        self._n = 0
        self._fails = 0
        if self.write:
            self._f = open(resolve_stage_fn(self.fn), "w")
            self._want = None
        else:
            from ..core.digest import Digest
            self._want = [Digest.from_lexp(ln) for ln in
                          Path(resolve_stage_fn(self.fn)).read_text().splitlines()
                          if ln.strip()]

    def proc_block(self, db: DataBlock) -> DataBlock:
        from ..core.digest import nda_digest
        if db.valid() and db.nda is not None:
            d = nda_digest(db.nda)
            if self.write:
                self._f.write(str(d) + "\n")
                self._f.flush()
            else:
                if self._n >= len(self._want):
                    raise RtErr(f"hash-check: block {self._n} beyond recorded "
                                f"digests ({len(self._want)})")
                err = self._want[self._n].comp(d, self.mrd_toler)
                if err is not None:
                    raise RtErr(f"hash-check: block {self._n} mismatch: {err}")
            self._n += 1
        elif not db.valid():
            self.stream_eof()
        return db

    def stream_eof(self) -> None:
        # a truncated stream must FAIL verification, not silently pass
        # with partial coverage
        if self._want is not None and self._n < len(self._want):
            raise RtErr(f"hash-check: stream ended after {self._n} blocks "
                        f"but {len(self._want)} digests were recorded")

    def get_pos_info_str(self) -> str:
        return f"hash-check: {self._n} blocks " + \
            ("recorded" if self.write else "verified")


# ---------------- cross-process stages ----------------
# Reference: the multi-process image-pipeline pattern of cap_app.cc:26-253
# (cs_disp / proc_ipc / display_ipc): frames flowing between processes over
# the stream_util transport. Here the same capability is two ordinary
# data-stream stages over parallel/transport (so ANY stage pipeline can
# span processes), plus a fork/exec-self spawn path (stream-src spawn=...)
# mirroring the reference's worker launch.

def _pack_block(db: DataBlock) -> bytes:
    """DataBlock -> one self-describing binary blob (recursive): a lexp
    header + length-prefixed NDA bwrite payloads + child blobs."""
    import struct

    from ..core.lexp import Lexp
    h = Lexp.empty_list()
    if db.tag:
        h.add_key_val("tag", db.tag)
    if db.meta:
        h.add_key_val("meta", db.meta)
    if db.frame_ix is not None:
        h.add_key_val("frame_ix", str(db.frame_ix))
    if db.timestamp_ns is not None:
        h.add_key_val("ts", str(db.timestamp_ns))
    h.add_key_val("has_nda", "1" if db.nda is not None else "0")
    h.add_key_val("nsub", str(db.num_subblocks()))
    if db.named:
        h.add_key_val("nnamed", str(len(db.named)))
    hb = str(h).encode()
    out = bytearray(struct.pack("<I", len(hb)) + hb)
    if db.nda is not None:
        nb = db.nda.bwrite()
        out += struct.pack("<I", len(nb)) + nb
    for sb in (db.subblocks or []):
        b = _pack_block(sb)
        out += struct.pack("<I", len(b)) + b
    for k in sorted(db.named or {}):
        b = _pack_block(db.named[k])
        out += struct.pack("<I", len(b)) + b
    return bytes(out)


def _unpack_block(buf: bytes, off: int = 0) -> tuple[DataBlock, int]:
    import struct

    from ..core.lexp import parse_lexp
    (hn,) = struct.unpack_from("<I", buf, off)
    off += 4
    h = parse_lexp(buf[off:off + hn].decode())
    h.deep_inc_use_cnt()
    off += hn
    g = lambda k: (h.get_kid(k).leaf_val if h.get_kid(k) is not None else None)
    db = DataBlock(tag=g("tag") or "", meta=g("meta") or "",
                   frame_ix=int(g("frame_ix")) if g("frame_ix") else None,
                   timestamp_ns=int(g("ts")) if g("ts") else None)
    if g("has_nda") == "1":
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        db.nda, _ = NDA.bread(buf[off:off + n])
        off += n
    for _ in range(int(g("nsub") or 0)):
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        sb, _ = _unpack_block(buf[off:off + n])
        off += n
        db.ensure_has_subblocks()
        db.subblocks.append(sb)
    for _ in range(int(g("nnamed") or 0)):
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        sb, _ = _unpack_block(buf[off:off + n])
        off += n
        db.set_sdb(sb)
    return db, off


@register(DataStream, "stream-sink",
          help="send blocks to another process over a framed byte stream")
class StreamSink(DataStream):
    addr = Attr(str, req=True, help="transport address (fds:/fns:/tcp:/"
                                    "tcp-listen:)")
    listen = Attr(bool, default=False, help="act as the transport server")

    def data_stream_init(self):
        from ..parallel.transport import make_stream
        self._st = make_stream(self.addr, is_server=self.listen)
        self._eos_sent = False

    def proc_block(self, db: DataBlock) -> DataBlock:
        if not db.valid():
            self.stream_eof()
            return db
        self._st.write_frame(_pack_block(db))
        return db

    def stream_eof(self) -> None:
        if not self._eos_sent:
            self._st.write_frame(b"")  # EOS sentinel
            self._eos_sent = True

    def get_pos_info_str(self) -> str:
        return f"stream-sink[{self.addr}]"


@register(DataStream, "stream-src",
          help="receive blocks from another process over a framed byte stream")
class StreamSrc(DataStream):
    addr = Attr(str, default="", help="transport address to connect/listen "
                                      "(unused when spawn= is given)")
    listen = Attr(bool, default=False, help="act as the transport server")
    spawn = Attr(str, default="",
                 help="lexp spec of a producer data-stream: fork/exec self "
                      "running scan_data_stream with a stream-sink over an "
                      "inherited socketpair (the cap_app proc_ipc pattern)")

    def data_stream_init(self):
        from ..parallel.transport import Stream, make_stream
        self._proc = None
        if self.spawn:
            import socket
            import subprocess
            import sys
            par, chi = socket.socketpair()
            chi_fd = chi.fileno()
            spec = (f"(mode=pipe,stages=(_0={self.spawn},"
                    f"_1=(mode=stream-sink,addr=fds:{chi_fd}:{chi_fd})))")
            cmd = [sys.executable, "-m", "boda_tpu_torch", "scan_data_stream",
                   f"--stream={spec}", "--verbose=0"]
            self._proc = subprocess.Popen(cmd, pass_fds=(chi_fd,),
                                          stdout=subprocess.DEVNULL)
            chi.close()
            self._st = Stream(sock=par)
        else:
            if not self.addr:
                raise RtErr("stream-src: need addr= or spawn=")
            self._st = make_stream(self.addr, is_server=self.listen)
        self._done = False

    def proc_block(self, db: DataBlock) -> DataBlock:
        if self._done:
            return DataBlock()
        buf = self._st.read_frame()
        if not buf:  # EOS sentinel
            self._done = True
            if self._proc is not None:
                self._proc.wait(60)
            return DataBlock()
        blk, _ = _unpack_block(buf)
        return blk

    def get_pos_info_str(self) -> str:
        src = "spawn" if self.spawn else self.addr
        return f"stream-src[{src}]"


# ---------------- mxnet brick (RecordIO) ----------------
# Reference: data-stream-mxnet.cc (mxnet-brick-src :25-113, -sink :118-159).
# Record framing: u32 magic 0xced7230a, u32 lrec = len | cflag<<29, payload,
# zero-pad to 4 bytes. Payloads containing the magic are split at each
# (4-aligned) occurrence into chunks chained by cflag (0=whole, 1=first,
# 2=middle, 3=last) and rejoined with the magic on read.

_MX_MAGIC = 0xCED7230A
_MX_MAX_REC = 1 << 29


@register(DataStream, "mxnet-brick-src",
          help="read records from an mxnet brick (RecordIO) file")
class MxnetBrickSrc(DataStream):
    fn = Attr(str, req=True, help="input .brick file")
    skip_recs_after_cnt = Attr(int, default=0,
                               help="drop this many records after each "
                                    "returned one")

    def data_stream_init(self):
        self._buf = Path(resolve_stage_fn(self.fn)).read_bytes()
        self._off = 0
        self._ix = 0

    def _read_chunk(self):
        import struct
        if self._off + 8 > len(self._buf):
            raise RtErr(f"mxnet-brick-src: not at eof, but only "
                        f"{len(self._buf) - self._off} bytes left for the "
                        f"next record header")
        magic, lrec = struct.unpack_from("<II", self._buf, self._off)
        if magic != _MX_MAGIC:
            raise RtErr(f"mxnet-brick-src: expected magic {_MX_MAGIC:#x}, "
                        f"got {magic:#x}")
        self._off += 8
        cflag, ln = lrec >> 29, lrec & (_MX_MAX_REC - 1)
        payload = self._buf[self._off:self._off + ln]
        self._off += ln + (-ln % 4)  # consume padding to 4-byte alignment
        return cflag, payload

    def _read_record(self) -> bytes:
        import struct
        parts = []
        while True:
            cflag, payload = self._read_chunk()
            parts.append(payload)
            if cflag in (0, 1):
                if len(parts) != 1:
                    raise RtErr("mxnet-brick-src: expected cflag 2/3 in "
                                f"continuation of split record, saw {cflag}")
                if cflag == 0:
                    break
            else:
                if len(parts) == 1:
                    raise RtErr("mxnet-brick-src: expected cflag 0/1 at "
                                f"record start, saw {cflag}")
                if cflag == 3:
                    break
        # split records rejoin with the magic value between parts
        return struct.pack("<I", _MX_MAGIC).join(parts)

    def proc_block(self, db: DataBlock) -> DataBlock:
        if self._off >= len(self._buf):
            return DataBlock()
        rec = self._read_record()
        nda = NDA(Dims.make(tn="uint8_t", v=len(rec)),
                  np.frombuffer(rec, np.uint8).copy())
        out = DataBlock(nda=nda, tag="mxnet-brick", frame_ix=self._ix,
                        timestamp_ns=self._off)
        self._ix += 1
        for _ in range(self.skip_recs_after_cnt):
            if self._off < len(self._buf):
                self._read_record()
        return out

    def get_pos_info_str(self) -> str:
        return f"mxnet-brick-src: {self._ix} recs, byte {self._off}/{len(self._buf)}"


@register(DataStream, "mxnet-brick-sink",
          help="write blocks as records into an mxnet brick (RecordIO) file")
class MxnetBrickSink(DataStream):
    fn = Attr(str, default="out.brick", help="output brick filename")

    def data_stream_init(self):
        self._f = open(resolve_stage_fn(self.fn), "wb")
        self._n = 0

    def _write_chunk(self, cflag: int, payload: bytes) -> None:
        import struct
        self._f.write(struct.pack("<II", _MX_MAGIC,
                                  len(payload) | (cflag << 29)))
        self._f.write(payload)

    def stream_eof(self) -> None:
        self._f.flush()

    def proc_block(self, db: DataBlock) -> DataBlock:
        import struct
        if not db.valid():
            self._f.flush()
            return db
        data = db.nda.v.tobytes() if db.nda is not None else b""
        if len(data) >= _MX_MAX_REC:
            raise RtErr(f"mxnet-brick-sink: record too big ({len(data)})")
        # split the payload at every 4-aligned occurrence of the magic
        splits = [i << 2 for i in range(len(data) >> 2)
                  if struct.unpack_from("<I", data, i << 2)[0] == _MX_MAGIC]
        spos, cflag_next, cflag_final = 0, 1, 0
        for ipos in splits:
            self._write_chunk(cflag_next, data[spos:ipos])
            spos, cflag_next, cflag_final = ipos + 4, 2, 3
        self._write_chunk(cflag_final, data[spos:])
        self._f.write(b"\0" * (-len(data) % 4))
        self._n += 1
        return db

    def get_pos_info_str(self) -> str:
        return f"mxnet-brick-sink: wrote {self._n} recs"


@register(DataStream, "img-dir-src",
          help="image blocks from files in a directory (sorted)")
class ImgDirSrc(DataStream):
    dir = Attr(str, req=True, help="directory of image files")
    glob = Attr(str, default="*.jpg *.jpeg *.png", help="patterns")
    tag = Attr(str, default="image")

    def data_stream_init(self):
        d = Path(self.dir)
        files: list[Path] = []
        for pat in self.glob.split():
            files += d.glob(pat)
        self._files = sorted(set(files))
        if not self._files:
            raise RtErr(f"img-dir-src: no images matching '{self.glob}' "
                        f"in '{self.dir}'")
        self._ix = 0

    def proc_block(self, db: DataBlock) -> DataBlock:
        from .img import load_img
        if self._ix >= len(self._files):
            return DataBlock()
        v = load_img(self._files[self._ix])
        dims = Dims([("y", v.shape[0]), ("x", v.shape[1]), ("chan", 3)],
                    tn="uint8_t")
        ret = DataBlock(NDA(dims, np.ascontiguousarray(v)), tag=self.tag,
                        meta="image", frame_ix=self._ix, timestamp_ns=self._ix)
        self._ix += 1
        return ret

    def seek_to_block(self, frame_ix: int) -> bool:
        self._ix = min(frame_ix, len(self._files))
        return True

    def get_pos_info_str(self) -> str:
        return f"img-dir-src: {self._ix}/{len(self._files)}"
