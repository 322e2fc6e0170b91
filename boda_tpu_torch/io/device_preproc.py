"""Device-side batched image preprocessing with host-to-card prefetch.

The port's copy of boda_tpu/io/device_preproc.py, on torch ops. Decode
stays on the host (PIL); everything after the raw uint8 image (resize,
RGB->BGR, mean subtraction, HWC->CHW) runs on the input tensor's device,
and `PrefetchFeeder` overlaps the next batch's host-to-card copy with the
current batch's compute. `PinnedStager` is the fused engine's upload of a
host array on a card: one copy into a page-locked buffer it owns, then a
non-blocking DMA.

The resize is the function `jax.image.resize(..., method="bilinear")`
computes, the way it computes it: per spatial axis whose size changes, a
float32 weight matrix of the triangle filter (widened by the inverse scale
on a downscale: the antialias), contracted with the image in full FP32.
`F.interpolate(mode="bilinear", antialias=True)` computes the same
function and matches it on the CPU, but its CUDA kernel is 2.3e-3 off its
CPU result on the 0-255 scale at a 300x400 -> 224x224 downscale (an
H100); without antialias a downscale differs by up to half the range.
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dims import NDA, Dims
from ..ops.cuda.util import full_fp32, torch_dtype
from .img import DEFAULT_MEAN_BGR


def _weight_mat(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of jax.image.resize's bilinear
    (the triangle kernel, scaled by max(in/out, 1): antialiased on a
    downscale; jax/_src/image/scale.py compute_weight_mat), computed in
    float32 step for step as it does."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale \
        - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    tot = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(tot != 0, tot, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_nhwc(x: torch.Tensor, out_y: int, out_x: int,
                weights: dict) -> torch.Tensor:
    """(B,y,x,C) float32 -> (B,out_y,out_x,C), jax.image.resize's bilinear
    on the input's device: one full-FP32 contraction per axis whose size
    changes. `weights` caches the weight matrices on their device, keyed
    (in_size, out_size, device): the caller's, kept across its calls."""
    def w_on(n_in: int, n_out: int):
        key = (n_in, n_out, x.device)
        if key not in weights:
            weights[key] = torch.from_numpy(_weight_mat(n_in, n_out)) \
                .to(x.device)
        return weights[key]

    _b, h, w, _c = x.shape
    with full_fp32():
        if h != out_y:
            x = torch.einsum("byxc,yY->bYxc", x, w_on(h, out_y))
        if w != out_x:
            x = torch.einsum("byxc,xX->byXc", x, w_on(w, out_x))
    return x


def _mean_of(mean: Optional[tuple]):
    """dev -> the mean as a float32 tensor on dev (None when `mean` is
    None), made once per device: a fresh host-to-card copy on each call
    would make the host wait for the card."""
    cache: dict = {}

    def on(dev: torch.device):
        if mean is None:
            return None
        if dev not in cache:
            cache[dev] = torch.tensor(mean, dtype=torch.float32, device=dev)
        return cache[dev]

    return on


def device_preproc_fn(out_y: int, out_x: int, bgr: bool = True,
                      mean: Optional[tuple] = DEFAULT_MEAN_BGR,
                      dtype="float32"):
    """(B,y,x,3) uint8 tensor -> (B,3,out_y,out_x) tensor of `dtype` (a
    numpy dtype name), on the input's device: cast to float32, resize
    only when the size differs, flip the channels, subtract the mean,
    permute, cast. Engine `set_input_preproc` composes it in front of
    the forward (the u8 serving wire: a 4x smaller upload than f32)."""
    out_dt = torch_dtype(np.dtype(dtype))
    mean_on = _mean_of(mean)
    weights: dict = {}

    def preproc(imgs: torch.Tensor) -> torch.Tensor:
        x = imgs.to(torch.float32)
        _b, h, w, _c = x.shape
        if (h, w) != (out_y, out_x):
            x = resize_nhwc(x, out_y, out_x, weights)
        if bgr:
            x = x.flip(-1)
        mean_v = mean_on(x.device)
        if mean_v is not None:
            x = x - mean_v
        return x.permute(0, 3, 1, 2).to(out_dt).contiguous()

    return preproc


def make_device_preproc(out_y: int, out_x: int, bgr: bool = True,
                        mean: Optional[tuple] = DEFAULT_MEAN_BGR,
                        dtype="float32"):
    """(B,y,x,3) uint8 -> (B,3,out_y,out_x) preprocessing, run without
    autograd (the JAX package jits it; eager torch needs no wrapper)."""
    fn = device_preproc_fn(out_y, out_x, bgr=bgr, mean=mean, dtype=dtype)

    def run(imgs: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return fn(imgs)

    return run


def make_device_pyra_pack(pp, bgr: bool = True,
                          mean: Optional[tuple] = DEFAULT_MEAN_BGR,
                          dtype="float32"):
    """Device-side pyramid pack: (in_y,in_x,3) frame (0-255 RGB, any
    numeric dtype) -> (num_bins, 3, bin_y, bin_x) packed batch, on the
    frame's device.

    Counterpart of `ImgPyraPack.scale_and_pack_img_into_bins` (the
    host/PIL path, reference conv_pyra.cc:24 img_pyra_pack): the host
    uploads one raw frame, and every scale's resize, edge pad and bin
    placement, the BGR swap and the mean subtraction run on the card. All
    offsets are static, from the placement in `pp`: one preallocated
    (num_bins, 3, bin_y, bin_x) float32 tensor of zeros; per scale the
    resize (resize_nhwc), the bottom and right edges replicated by
    min(p1 + pad, bin) - p1, written into its box by slice assignment.
    Uncovered pixels come out as 0 - mean, as in the host path (uint8
    zeros, then the mean subtracted)."""
    bin_y, bin_x = pp.bin_sz.y, pp.bin_sz.x
    out_dt = torch_dtype(np.dtype(dtype))
    mean_on = _mean_of(mean)
    weights: dict = {}

    def pack(frame: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            x = frame.to(torch.float32)[None]  # (1,y,x,3)
            bins = torch.zeros((pp.num_bins, 3, bin_y, bin_x),
                               dtype=torch.float32, device=frame.device)
            for si in pp.scales:
                sc = resize_nhwc(x, si.sz.y, si.sz.x, weights) \
                    .permute(0, 3, 1, 2)
                b = si.place
                ey = min(b.p1.y + pp.pad.y, bin_y) - b.p1.y
                ex = min(b.p1.x + pp.pad.x, bin_x) - b.p1.x
                if ey or ex:
                    sc = F.pad(sc, (0, ex, 0, ey), mode="replicate")
                bins[si.bin_ix, :, b.p0.y:b.p0.y + sc.shape[2],
                     b.p0.x:b.p0.x + sc.shape[3]] = sc[0]
            if bgr:
                bins = bins.flip(1)
            mean_v = mean_on(bins.device)
            if mean_v is not None:
                bins = bins - mean_v[:, None, None]
            return bins.to(out_dt).contiguous()

    return pack


class PrefetchFeeder:
    """Iterate preprocessed device batches with one batch of host-to-card
    prefetch.

    source: iterator of (B,y,x,3) uint8 numpy batches. On a card each
    batch is staged into one of two pinned host buffers and copied to the
    card on a side stream, so the copy of batch i+1 overlaps the
    consumer's compute on batch i; the consumer's stream waits on the
    copy's event before preprocessing. A pinned buffer is rewritten only
    after the event of the copy that last read it has completed. On the
    CPU it is a plain iterator of preprocessed batches."""

    def __init__(self, source: Iterator[np.ndarray], out_y: int, out_x: int,
                 device="cuda", **preproc_kw):
        from ..core.device import get_device
        self._src = iter(source)
        self._preproc = make_device_preproc(out_y, out_x, **preproc_kw)
        self.dev = get_device(device) if isinstance(device, str) else device
        self._on_card = self.dev.type == "cuda"
        self._pinned: list = [None, None]
        self._events: list = [None, None]
        self._slot = 0
        self._side = torch.cuda.Stream(self.dev) if self._on_card else None

    def _stage(self):
        """The next batch on the device (a copy in flight on the side
        stream, with its event), or None at the end of the source."""
        try:
            host = np.ascontiguousarray(next(self._src))
        except StopIteration:
            return None
        if not self._on_card:
            return torch.from_numpy(host), None
        s = self._slot
        self._slot ^= 1
        buf = self._pinned[s]
        if self._events[s] is not None:
            self._events[s].synchronize()  # its last copy has read it
        dt = torch_dtype(host.dtype)
        if buf is None or tuple(buf.shape) != host.shape or buf.dtype != dt:
            buf = self._pinned[s] = torch.empty(host.shape, dtype=dt,
                                                pin_memory=True)
        buf.numpy()[...] = host
        with torch.cuda.stream(self._side):
            dev_t = buf.to(self.dev, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._side)
        self._events[s] = ev
        return dev_t, ev

    def __iter__(self):
        pending = self._stage()
        while pending is not None:
            cur, ev = pending
            if ev is not None:
                cur_stream = torch.cuda.current_stream(self.dev)
                cur_stream.wait_event(ev)
                # cur was made on the side stream: keep its memory alive
                # until the consumer's stream is done with it
                cur.record_stream(cur_stream)
            out = self._preproc(cur)
            pending = self._stage()  # overlaps with the consumer's compute
            yield out


class PinnedStager:
    """Host arrays to a card through one page-locked buffer per key.

    upload(key, arr) gives arr's copy on the card `dev` (its shape and
    dtype, the same bytes) and the bytes it copied through the pinned
    buffer. The host copies arr into the key's buffer (torch's `copy_`, on
    the intra-op threads), enqueues the buffer's non-blocking copy to the
    card on the current stream and returns: work the caller enqueues after
    it on that stream is ordered after the copy. A key's buffer is
    allocated at its first upload and grown only for a larger array. An
    event recorded after the copy is waited on before the buffer is written
    again, so no DMA still in flight from an earlier upload (one whose
    caller raised before syncing, say) reads bytes of a later one. Uploads
    from several threads take turns.

    One copy and one DMA, not chunks whose DMAs run under the host's copy
    of the next, which gained nothing measurable. On an H100 80GB HBM3 at
    700 W with 8 host threads, the b128 u8 wire (19,267,584 B) took
    0.36-0.42 ms of pinned DMA (46-54 GB/s) and 0.38-0.76 ms of torch's
    copy into pinned memory (25-51 GB/s), against 2.21-3.82 ms through a
    pageable copy; ResNet-50's b128 run_fwd took 9.48-10.98 ms with one
    copy, 9.56-18.30 ms in 4 MiB chunks and 10.96-12.29 ms pageable."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self._bufs: dict = {}
        self._events: dict = {}
        self._lock = threading.Lock()

    def upload(self, key, arr: np.ndarray) -> tuple[torch.Tensor, int]:
        src = torch.from_numpy(np.ascontiguousarray(arr))
        out = torch.empty(src.shape, dtype=src.dtype, device=self.dev)
        n = src.numel() * src.element_size()
        if n == 0:
            return out, 0
        with self._lock:
            ev = self._events.get(key)
            if ev is None:
                ev = self._events[key] = torch.cuda.Event()
            else:
                ev.synchronize()  # the last upload's DMA has read the buffer
            buf = self._bufs.get(key)
            if buf is None or buf.numel() < n:
                buf = self._bufs[key] = torch.empty(n, dtype=torch.uint8,
                                                    pin_memory=True)
            buf[:n].copy_(src.view(-1).view(torch.uint8))
            out.view(-1).view(torch.uint8).copy_(buf[:n], non_blocking=True)
            ev.record(torch.cuda.current_stream(self.dev))
        return out, n


def preprocess_batch_nda(imgs: np.ndarray, dims: Dims, bgr: bool = True,
                         mean: Optional[tuple] = DEFAULT_MEAN_BGR,
                         device: str = "cuda") -> NDA:
    """One-shot helper: uint8 (B,y,x,3) -> NDA matching a net's data dims,
    preprocessed on `device`."""
    from ..core.device import get_device
    fn = make_device_preproc(dims["y"], dims["x"], bgr=bgr, mean=mean,
                             dtype=dims.dtype)
    out = fn(torch.from_numpy(np.ascontiguousarray(imgs))
             .to(get_device(device)))
    return NDA(dims, out.cpu().numpy().reshape(dims.shape))
