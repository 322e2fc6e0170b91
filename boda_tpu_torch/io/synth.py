"""Procedural labeled-image synthesis: a deterministic, learnable
classification dataset at any resolution, generated locally.

Reference role: the reference's test fixtures came from downloaded
ImageNet/PASCAL archives plus generated test-pattern images
(img_io.cc:163 make_test_pattern); a TPU-VM build has no dataset
downloads, so this module fills the *trainable data* slot the same way
the test-pattern generator fills the *pixel-format* slot — but with
real class structure (10 shape classes under random pose/scale/color/
texture/background), so a net trained on it reaches genuine held-out
accuracy and its weights/activations exercise trained-network numerics
(saturation, outlier channels) that crc32-seeded random weights do not
(VERDICT r3 "Missing #1").

Determinism: every image is a pure function of (seed, index) via a
crc32 mix (Python hash() is process-salted — CLAUDE.md), so train/val
splits are index ranges and any process can regenerate the exact split.

The port's copy of boda_tpu/io/synth.py.
"""

from __future__ import annotations

import zlib

import numpy as np

from ..core.error import RtErr

NUM_SHAPE_CLASSES = 10

SHAPE_CLASS_NAMES = (
    "disk", "square", "triangle", "ring", "cross",
    "striped_disk", "checker_square", "diamond", "twin_disks", "crescent",
)

# Extended class set: label = shape + 10 * texture. Textures 1-3 paint the
# foreground with TWO colors (stripes / checker / concentric rings) instead
# of one; unlike classes 5/6 (whose pattern CUTS the mask, showing the
# background through), both texture colors are solid foreground — so all
# 40 (shape, texture) combinations are pairwise distinguishable. Texture 0
# renders byte-identically to the original 10-class set (golden stability).
NUM_TEXTURES = 4
TEXTURE_NAMES = ("solid", "striped", "checkered", "ringed")
MAX_SHAPE_CLASSES = NUM_SHAPE_CLASSES * NUM_TEXTURES


def _class_mask(label: int, u, v):
    """Boolean foreground mask for class `label` over rotated, scaled,
    centered coordinates (u, v) (unit-ish shape extent)."""
    r2 = u * u + v * v
    au, av = np.abs(u), np.abs(v)
    if label == 0:      # disk
        return r2 <= 1.0
    if label == 1:      # square
        return np.maximum(au, av) <= 0.8
    if label == 2:      # triangle (up-pointing before rotation)
        return (v > -0.6) & (1.2 * au < (0.9 - v))
    if label == 3:      # ring
        return (r2 <= 1.0) & (r2 >= 0.55 * 0.55)
    if label == 4:      # cross / plus
        return ((au <= 0.35) & (av <= 1.0)) | ((av <= 0.35) & (au <= 1.0))
    if label == 5:      # striped disk (1-d parity texture)
        return (r2 <= 1.0) & (np.sin(u * np.pi * 5.0) > 0)
    if label == 6:      # checkerboard square (2-d parity texture)
        par = (np.floor(u * 2.2) + np.floor(v * 2.2)).astype(np.int64)
        return (np.maximum(au, av) <= 0.9) & (par % 2 == 0)
    if label == 7:      # diamond
        return (au + av) <= 1.1
    if label == 8:      # twin disks
        return ((u - 0.55) ** 2 + v * v <= 0.45 ** 2) \
            | ((u + 0.55) ** 2 + v * v <= 0.45 ** 2)
    if label == 9:      # crescent (disk minus offset disk)
        return (r2 <= 1.0) & ((u - 0.45) ** 2 + v * v >= 0.55 ** 2)
    raise RtErr(f"shapes: no class {label} (have {NUM_SHAPE_CLASSES})")


def render_shape_img(ix: int, ysz: int, xsz: int,
                     num_classes: int = NUM_SHAPE_CLASSES,
                     seed: int = 0) -> tuple[np.ndarray, int]:
    """-> ((3,y,x) uint8 image, label). Pure function of (seed, ix):
    label = ix % num_classes; pose/scale/colors/noise drawn from a
    crc32-mixed RandomState. num_classes > 10 unlocks the extended
    (shape, texture) label space: label = shape + 10 * texture."""
    if not 1 <= num_classes <= MAX_SHAPE_CLASSES:
        raise RtErr(f"shapes: num_classes must be in "
                    f"[1,{MAX_SHAPE_CLASSES}], got {num_classes}")
    label = ix % num_classes
    rng = np.random.RandomState(
        zlib.crc32(f"shapes:{seed}:{ix}".encode()) % (2 ** 31))
    # normalized coords: [-1,1] over the short axis
    sc = 2.0 / min(ysz, xsz)
    yy = (np.arange(ysz, dtype=np.float32) - ysz / 2.0)[:, None] * sc
    xx = (np.arange(xsz, dtype=np.float32) - xsz / 2.0)[None, :] * sc
    # background: smooth 2-color gradient at a random angle + pixel noise
    c0 = rng.uniform(0, 255, 3).astype(np.float32)
    c1 = rng.uniform(0, 255, 3).astype(np.float32)
    ga = rng.uniform(0, 2 * np.pi)
    t = (np.cos(ga) * xx + np.sin(ga) * yy + 1.5) / 3.0  # ~[0,1]
    img = c0[:, None, None] * (1 - t) + c1[:, None, None] * t
    # foreground shape: random center / scale / rotation
    cy, cx = rng.uniform(-0.35, 0.35, 2)
    s = rng.uniform(0.3, 0.55)
    th = rng.uniform(0, 2 * np.pi)
    dx, dy = xx - cx, yy - cy
    u = (np.cos(th) * dx + np.sin(th) * dy) / s
    v = (-np.sin(th) * dx + np.cos(th) * dy) / s
    shape, texture = label % NUM_SHAPE_CLASSES, label // NUM_SHAPE_CLASSES
    m = _class_mask(shape, u, v).astype(np.float32)
    # fg color: random hue, contrast-shifted from the bg average so the
    # shape is never invisible
    fg = (0.5 * (c0 + c1) + 80.0 + rng.uniform(0, 96, 3)) % 256.0
    fg_px = fg[:, None, None]
    if texture:  # two-color fg paint (extra rng draw only when texture>0,
        # so texture-0 images stay byte-identical to the 10-class set)
        fg2 = (fg + 96.0 + rng.uniform(0, 64, 3)) % 256.0
        if texture == 1:    # diagonal two-color stripes
            mt = np.sin((u + v) * np.pi * 3.5) > 0
        elif texture == 2:  # two-color checkerboard
            par = (np.floor(u * 1.8) + np.floor(v * 1.8)).astype(np.int64)
            mt = par % 2 == 0
        else:               # concentric two-color rings
            mt = np.sin(np.sqrt(u * u + v * v) * np.pi * 4.0) > 0
        mt = mt.astype(np.float32)[None]
        fg_px = fg[:, None, None] * (1 - mt) + fg2[:, None, None] * mt
    img = img * (1 - m) + fg_px * m
    img = img + rng.randn(1, ysz, xsz).astype(np.float32) * 6.0
    return np.clip(img, 0, 255).astype(np.uint8), label


def render_shapes(ixs, ysz: int, xsz: int,
                  num_classes: int = NUM_SHAPE_CLASSES,
                  seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Batch renderer: -> ((N,3,y,x) uint8, (N,) int32 labels)."""
    imgs = np.empty((len(ixs), 3, ysz, xsz), np.uint8)
    labels = np.empty((len(ixs),), np.int32)
    for i, ix in enumerate(ixs):
        imgs[i], labels[i] = render_shape_img(int(ix), ysz, xsz,
                                              num_classes, seed)
    return imgs, labels
