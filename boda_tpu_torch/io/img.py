"""Image IO + host-side image ops.

Capability parity with the reference's img_io* (img_t RGBA images,
JPEG via turbojpeg / PNG via lodepng, resample_to_size / upsample_2x,
mean-subtract-and-copy-to-batch preprocessing, caffeif.H:13). Decode uses
PIL. The port's copy of boda_tpu/io/img.py.

Images are RGB uint8 numpy arrays shaped (y, x, 3) here; batch tensors are
NCHW float32 (the pipe's data layout).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

from ..core.dims import NDA, Dims
from ..core.error import RtErr

# caffe/BVLC conventional BGR mean (reference uses per-channel mean ~ imagenet)
DEFAULT_MEAN_BGR = (104.0, 117.0, 123.0)


def load_img(path: Union[str, Path]) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError:
        raise RtErr("image IO requires PIL (feature 'pil' disabled)")
    p = Path(path)
    if not p.exists():
        raise RtErr(f"image file not found: {p}")
    try:
        im = Image.open(p)
        im.load()
    except Exception as e:
        raise RtErr(f"failed to decode image '{p}': {e}")
    return np.asarray(im.convert("RGB"))


def decode_img_bytes(raw: bytes) -> np.ndarray:
    """Decode an encoded image (JPEG/PNG/...) from memory → RGB (y,x,3)."""
    try:
        from PIL import Image
    except ImportError:
        raise RtErr("image IO requires PIL (feature 'pil' disabled)")
    import io
    try:
        im = Image.open(io.BytesIO(raw))
        im.load()
    except Exception as e:
        raise RtErr(f"failed to decode image bytes: {e}")
    return np.asarray(im.convert("RGB"))


def save_img(path: Union[str, Path], img: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(np.asarray(img, np.uint8)).save(str(path))


def resample_to_size(img: np.ndarray, ysz: int, xsz: int) -> np.ndarray:
    """Bilinear resample (reference: resample_to_size timer tag)."""
    from PIL import Image
    im = Image.fromarray(np.asarray(img, np.uint8))
    return np.asarray(im.resize((xsz, ysz), Image.BILINEAR))


def upsample_2x(img: np.ndarray) -> np.ndarray:
    return resample_to_size(img, img.shape[0] * 2, img.shape[1] * 2)


def downsample_2x(img: np.ndarray) -> np.ndarray:
    return resample_to_size(img, img.shape[0] // 2, img.shape[1] // 2)


def img_to_chw(img: np.ndarray, bgr: bool = True,
               mean: Optional[tuple] = DEFAULT_MEAN_BGR) -> np.ndarray:
    """RGB (y,x,3) uint8 → (3,y,x) float32, channel-swapped + mean-subtracted
    (reference: subtract_mean_and_copy_img_to_batch caffeif.H:13)."""
    x = np.asarray(img, np.float32)
    if bgr:
        x = x[:, :, ::-1]
    if mean is not None:
        x = x - np.asarray(mean, np.float32)
    return np.ascontiguousarray(x.transpose(2, 0, 1))


def img_to_batch(img: np.ndarray, dims: Dims, bgr: bool = True,
                 mean: Optional[tuple] = DEFAULT_MEAN_BGR) -> NDA:
    """Resize + preprocess one image into a (img,chan,y,x) batch NDA
    (replicated across the batch dim if batch > 1)."""
    ysz, xsz = dims["y"], dims["x"]
    if img.shape[:2] != (ysz, xsz):
        img = resample_to_size(img, ysz, xsz)
    chw = img_to_chw(img, bgr=bgr, mean=mean)
    batch = np.broadcast_to(chw[None], dims.shape).copy()
    return NDA(dims, batch)


def make_test_pattern_img(ysz: int = 64, xsz: int = 64, mode: int = 0) -> np.ndarray:
    """Deterministic synthetic test image (reference: 'tpd' host test
    patterns, test_compute.cc:40-42)."""
    yy, xx = np.mgrid[0:ysz, 0:xsz]
    if mode == 0:
        r = (yy * 255 // max(ysz - 1, 1))
        g = (xx * 255 // max(xsz - 1, 1))
        b = ((yy + xx) * 255 // max(ysz + xsz - 2, 1))
    elif mode == 1:
        r = (yy // 8 + xx // 8) % 2 * 255
        g = r
        b = r
    else:
        r = (yy * 7 + xx * 13) % 256
        g = (yy * 13 + xx * 7) % 256
        b = (yy * 3 + xx * 29) % 256
    return np.stack([r, g, b], axis=-1).astype(np.uint8)
