"""Video data-stream source/sink (the ffmpeg reader's role).

The port's copy of boda_tpu/io/video.py.

Capability parity with the reference's video ingestion
(data-stream-ffmpeg.cc:533 — libav demux/decode into image data blocks,
one block per frame with stream timestamps). This environment has no
ffmpeg/pyav; OpenCV's VideoCapture/VideoWriter (bundled ffmpeg) fills the
decoder role, feature-gated as 'video'. Blocks follow the labeled-image
convention used everywhere else: nda = (chan,y,x) float32 RGB in [0,255],
frame_ix + timestamp_ns set from the container.

`video-sink` (VideoWriter) exists mainly so tests and demos can generate
fixtures; the reference wrote frames via ffmpeg too (same file, :600+).
"""

from __future__ import annotations

import numpy as np

from ..core.config import Attr
from ..core.dims import NDA, Dims
from ..core.error import RtErr
from .data_stream import DataBlock, DataStream, register


def _cv2():
    try:
        import cv2
        return cv2
    except ImportError:
        raise RtErr("video stages need OpenCV (feature 'video' disabled)")


@register(DataStream, "video-src",
          help="one block per decoded video frame (feature 'video')")
class VideoSrc(DataStream):
    fn = Attr(str, req=True, help="video file (any OpenCV-decodable container)")
    tag = Attr(str, default="video")
    max_frames = Attr(int, default=0, help="stop after N frames (0: all)")

    def data_stream_init(self):
        cv2 = _cv2()
        self._cap = cv2.VideoCapture(self.fn)
        if not self._cap.isOpened():
            raise RtErr(f"video-src: can't open '{self.fn}'")
        self._fps = self._cap.get(cv2.CAP_PROP_FPS) or 30.0
        self._ix = 0

    def proc_block(self, db: DataBlock) -> DataBlock:
        if self.max_frames and self._ix >= self.max_frames:
            return DataBlock()
        ok, frame = self._cap.read()  # BGR uint8 (y, x, 3)
        if not ok:
            return DataBlock()
        rgb = frame[:, :, ::-1].astype(np.float32)
        v = np.ascontiguousarray(np.transpose(rgb, (2, 0, 1)))
        dims = Dims.make(tn="float", chan=3, y=v.shape[1], x=v.shape[2])
        ts = int(self._ix / self._fps * 1e9)
        ret = DataBlock(NDA(dims, v), tag=self.tag, frame_ix=self._ix,
                        timestamp_ns=ts)
        self._ix += 1
        return ret

    def seek_to_block(self, frame_ix: int) -> bool:
        cv2 = _cv2()
        ok = self._cap.set(cv2.CAP_PROP_POS_FRAMES, frame_ix)
        if ok:
            self._ix = frame_ix
        return bool(ok)

    def get_pos_info_str(self) -> str:
        return f"video-src: frame {self._ix} @ {self._fps:g} fps"


@register(DataStream, "video-sink",
          help="encode each block's image into a video file")
class VideoSink(DataStream):
    fn = Attr(str, req=True, help="output video file (.avi/.mp4)")
    fps = Attr(float, default=30.0)
    fourcc = Attr(str, default="MJPG")

    def data_stream_init(self):
        self._wr = None
        self._cnt = 0

    def proc_block(self, db: DataBlock) -> DataBlock:
        if not db.valid() or db.nda is None:
            if self._wr is not None:
                self._wr.release()
                self._wr = None
            return db
        cv2 = _cv2()
        v = db.nda.v
        if v.ndim != 3 or v.shape[0] != 3:
            raise RtErr(f"video-sink: need (3,y,x) blocks, got {v.shape}")
        frame = np.transpose(np.clip(v, 0, 255).astype(np.uint8),
                             (1, 2, 0))[:, :, ::-1]  # RGB chw -> BGR hwc
        if self._wr is None:
            fcc = cv2.VideoWriter_fourcc(*self.fourcc)
            self._wr = cv2.VideoWriter(self.fn, fcc, self.fps,
                                       (frame.shape[1], frame.shape[0]))
            if not self._wr.isOpened():
                raise RtErr(f"video-sink: can't open '{self.fn}' for write")
        self._wr.write(frame)
        self._cnt += 1
        return db

    def get_pos_info_str(self) -> str:
        return f"video-sink: {self._cnt} frames"


def write_test_video(fn: str, num_frames: int = 8, ysz: int = 64,
                     xsz: int = 64, fps: float = 10.0) -> None:
    """Deterministic moving-gradient fixture clip."""
    cv2 = _cv2()
    wr = cv2.VideoWriter(fn, cv2.VideoWriter_fourcc(*"MJPG"), fps, (xsz, ysz))
    if not wr.isOpened():
        raise RtErr(f"write_test_video: can't open '{fn}'")
    yy, xx = np.mgrid[0:ysz, 0:xsz]
    for f in range(num_frames):
        r = ((xx * 4 + f * 32) % 256).astype(np.uint8)
        g = ((yy * 4) % 256).astype(np.uint8)
        b = np.full_like(r, 32 + 8 * f)
        wr.write(np.stack([b, g, r], axis=-1))  # BGR
    wr.release()
