"""Data-stream blocks and the stage base: `DataBlock` (nda + tag/meta/
frame_ix/timestamp_ns + named and indexed subblocks) and the polymorphic
`DataStream` stage interface (`proc_block`, `seek_to_block`,
`get_pos_info_str`) selected by `mode=` (reference data-stream.H:25-115).

Stage conventions (reference data-stream.H:84-93): sources are called with
an empty block and produce data as a side effect of reading; sinks echo
their input; xforms transform/filter. An invalid (empty) returned block
means end-of-stream.

The port's copy of the core of boda_tpu/io/data_stream.py, with
make_data_stream, read_all_blocks and the stages `test-gen` (synthetic
blocks) and `pipe` (a chain of stages), which carry the serving stages
`zmq-det` (apps/zmq_serve.py) and `cnet-infer` (apps/stream_infer.py).
The labeled sources that feed cls_agree and test_lmdb are in
apps/eval_cls.py; the JAX package's other stages and the scan_data_stream
mode are left out.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.config import Attr, Config, register
from ..core.dims import NDA, Dims
from ..core.error import RtErr

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
