"""Elementwise and data-movement templates: copy and split_copy (the
Concat and Split lowerings), relu, ZeroIfNonPos (ReLU's backward), eltwise
(SUM, MAX, PROD), scale (per-channel scale and bias), dropout (inference
and both train-mode masks), and dot (c = a * b, the kernel of the
rtc_test smoke mode).

Port of boda_tpu/ops/pallas/elementwise.py, which computes these outside
Pallas too. Each works on NCHW or NHWC storage alike, in the tensors' own
dtype (bf16 edges add in bf16 in both packages). `copy` writes into the
engine's concat buffer in place and returns it: JAX's dynamic_update_slice
is in place under jit, and a functional copy here would move the whole
concat once per member.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.error import RtErr
from ..op_base import OpBase
from ..registry import IN, INOUT, OUT, KernelTemplate, adecl, template
from .quantize import div_const, dtype_consts, f32_recip


@template
class Dot(KernelTemplate):
    """Backend smoke-test kernel (reference: rtc_test's dot.cucl,
    rtc_compute.cc:135): c = a * b elementwise over a 1-D index space."""

    name = "dot"
    args = [adecl("a", IN, "n"), adecl("b", IN, "n"), adecl("c", OUT, "n")]

    @classmethod
    def build(cls, rfs: OpBase):
        return torch.mul

    @classmethod
    def ref_impl(cls, rfs: OpBase, a, b):
        return np.asarray(a) * np.asarray(b)


def _chan_slice(t: torch.Tensor, start: int, n: int, nhwc: bool):
    """The channel slice [start, start + n) of a 4-D tensor: the last dim
    under NHWC storage, dim 1 otherwise."""
    return t[..., start:start + n] if nhwc else t[:, start:start + n]


@template
class Copy(KernelTemplate):
    """Copy `in` into the channel slice [ocix, ocix + C) of `out` (the
    Concat lowering: one call per member at its channel offset), in place:
    `out` is the buffer the engine owns (zero-filled at its first touch),
    and the call returns it."""

    name = "copy"
    args = [adecl("in", IN, "img chan y x"),
            adecl("out", INOUT, "img chan y x")]
    sig_nda_keys = ["ocix"]
    nhwc_ok = True

    @classmethod
    def build(cls, rfs: OpBase):
        ocix = rfs.get_u32_or("ocix", 0)
        cn = rfs.get_dims("in")["chan"]
        nhwc = rfs.str_vals.get("io_layout") == "nhwc"

        def fn(x, out):
            _chan_slice(out, ocix, cn, nhwc).copy_(x)
            return out
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, x, out):
        ocix = rfs.get_u32_or("ocix", 0)
        out = np.array(out)
        out[:, ocix:ocix + x.shape[1]] = x
        return out


@template
class SplitCopy(KernelTemplate):
    """Copy the channel slice [icix, icix + C) of `in` into `out` (the
    Split lowering), as a tensor of its own."""

    name = "split_copy"
    args = [adecl("in", IN, "img chan y x"),
            adecl("out", OUT, "img chan y x")]
    sig_nda_keys = ["icix"]
    nhwc_ok = True

    @classmethod
    def build(cls, rfs: OpBase):
        icix = rfs.get_u32_or("icix", 0)
        cn = rfs.get_dims("out")["chan"]
        nhwc = rfs.str_vals.get("io_layout") == "nhwc"

        def fn(x):
            return _chan_slice(x, icix, cn, nhwc).contiguous()
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, x):
        icix = rfs.get_u32_or("icix", 0)
        cn = rfs.get_dims("out")["chan"]
        return np.asarray(x)[:, icix:icix + cn]


@template
class Relu(KernelTemplate):
    """In-place ReLU at an unfused graph position."""

    name = "relu"
    args = [adecl("inout", INOUT, "img chan y x")]
    nhwc_ok = True  # elementwise: storage-layout agnostic

    @classmethod
    def build(cls, rfs: OpBase):
        return torch.relu

    @classmethod
    def ref_impl(cls, rfs: OpBase, x):
        return np.maximum(np.asarray(x), 0)


@template
class ZeroIfNonPos(KernelTemplate):
    """ReLU's backward: out = grad where in > 0, else 0 (a training plan's
    step)."""

    name = "ZeroIfNonPos"
    args = [adecl("in", IN, "img chan y x"),
            adecl("grad", IN, "img chan y x"),
            adecl("out", OUT, "img chan y x")]

    @classmethod
    def build(cls, rfs: OpBase):
        def fn(x, g):
            return torch.where(x > 0, g, torch.zeros((), dtype=g.dtype,
                                                     device=g.device))
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, x, g):
        return np.where(np.asarray(x) > 0, np.asarray(g), 0) \
            .astype(np.asarray(g).dtype)


_EW_NP = {"SUM": np.add, "MAX": np.maximum, "PROD": np.multiply}


@template
class Eltwise(KernelTemplate):
    """Binary eltwise (SUM/MAX/PROD over two inputs): caffe's Eltwise
    layer, the residual adds of a ResNet."""

    name = "eltwise"
    args = [adecl("a", IN, "img chan y x"), adecl("b", IN, "img chan y x"),
            adecl("out", OUT, "img chan y x")]
    sig_str_keys = ["ew_op"]
    nhwc_ok = True  # elementwise: storage-layout agnostic

    @classmethod
    def build(cls, rfs: OpBase):
        op = rfs.str_vals.get("ew_op", "SUM")
        fns = {"SUM": torch.add, "MAX": torch.maximum, "PROD": torch.mul}
        if op not in fns:
            raise RtErr(f"eltwise: unknown ew_op '{op}' "
                        f"(have: {','.join(fns)})")
        return fns[op]

    @classmethod
    def ref_impl(cls, rfs: OpBase, a, b):
        return _EW_NP[rfs.str_vals.get("ew_op", "SUM")](np.asarray(a),
                                                        np.asarray(b))


@template
class Scale(KernelTemplate):
    """Per-channel scale and optional bias (caffe's Scale layer), in x's
    dtype: y = x * s, then + b, each rounded to x's dtype."""

    name = "scale"
    args = [adecl("in", IN, "img chan y x"), adecl("scales", IN, "chan"),
            adecl("biases", IN, "chan", opt=True),
            adecl("out", OUT, "img chan y x")]
    nhwc_ok = True

    @classmethod
    def build(cls, rfs: OpBase):
        nhwc = rfs.str_vals.get("io_layout") == "nhwc"

        def per_chan(v, x):
            v = v.to(x.dtype)
            return v if nhwc else v[:, None, None]

        def fn(x, s, b=None):
            y = x * per_chan(s, x)
            return y if b is None else y + per_chan(b, x)
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, x, s, b=None):
        y = np.asarray(x) * np.asarray(s)[None, :, None, None]
        if b is not None:
            y = y + np.asarray(b)[None, :, None, None]
        return y


def _ratio(rfs: OpBase) -> float:
    r = rfs.nda_vals.get("dropout_ratio")
    return float(r.item()) if r is not None else 0.5


def _scale_kept(ratio: float):
    """fn(x, u) = x * (u >= ratio) / (1 - ratio) in x's dtype, as the JAX
    engine computes it: the constants in u's and x's dtypes (JAX's
    weak-typed numbers), the division a product with the f32 reciprocal
    XLA folds (quantize.div_const); the constants made once per dtype and
    device."""
    consts: dict = {}

    def fn(x, u):
        key = (x.dtype, u.dtype, x.device)
        if key not in consts:
            consts[key] = (dtype_consts(u, ratio)[0],
                           f32_recip(x, 1.0 - ratio))
        r, inv = consts[key]
        return div_const(x * (u >= r).to(x.dtype), inv)
    return fn


@template
class Dropout(KernelTemplate):
    """Dropout with deterministic seed control (reference: dropout.cucl +
    set_det_drop_seed rtc_fwd.cc:91-99). Inference mode is the identity;
    train mode keeps the units whose mask value u >= ratio and scales them
    by 1 / (1 - ratio), with a counter-based mask that every backend
    computes alike. Two masks, as in the JAX template:

    - `_mask`, static per signature: a uint64 LCG plus fmix on the flat
      index, keyed by det_drop_seed. Computed with numpy (the JAX
      template's own code) once per storage shape and uploaded.
    - `_mask32`, per step: a uint32 murmur3 fmix on (flat index, seed),
      the seed a fed input node (train_dropout lowering). It runs on the
      seed's device in int64: the index wrapped to 32 bits first, as the
      JAX template's uint32 arange wraps it, each product taken mod 2^32 in
      16-bit halves (no int64 overflow) and each shift of a non-negative
      value; `_mask32_np` is its numpy twin, the JAX template's.

    The flat index is the whole batch's: under a dp split
    (engine/mesh_fwd.py) a slot's rows start at row0 of the batch, and the
    train-mode functions take row0= (fn.takes_row0), so that a slot's mask
    is its rows of the whole batch's mask, as GSPMD computes the JAX
    template's over the global index (elementwise.py:223-270). Batch is
    dim 0 of the storage form, NCHW or NHWC alike.
    """

    name = "dropout"
    args = [adecl("seed", IN, "v", opt=True),
            adecl("inout", INOUT, "img chan y x")]
    nhwc_ok = True  # elementwise; the mask follows the storage index
    sig_nda_keys = ["dropout_ratio", "det_drop_seed"]
    sig_str_keys = ["drop_mode"]
    _FMIX = (2654435761, 0x9E3779B9, 0x85EB_CA6B, 0xC2B2_AE35)

    @staticmethod
    def _first_index(shape, row0: int) -> int:
        """The flat index of row row0's first element in a batch whose
        rows are shape[1:]."""
        return row0 * int(np.prod(shape[1:]))

    @classmethod
    def _mask(cls, rfs: OpBase, shape, row0: int = 0):
        seed = rfs.get_u32_or("det_drop_seed", 0)
        i0 = cls._first_index(shape, row0)
        idx = np.arange(i0, i0 + int(np.prod(shape)), dtype=np.uint64)
        h = (idx * np.uint64(6364136223846793005)
             + np.uint64(seed * 2654435761 + 1442695040888963407))
        h ^= h >> np.uint64(33)
        h *= np.uint64(0xff51afd7ed558ccd)
        h ^= h >> np.uint64(33)
        u = (h >> np.uint64(40)).astype(np.float64) / float(1 << 24)
        return u.reshape(shape)

    @classmethod
    def _mask32_np(cls, seed, shape):
        m = np.uint32
        c1, c2, c3, c4 = (m(v) for v in cls._FMIX)
        idx = np.arange(int(np.prod(shape)), dtype=np.uint32)
        with np.errstate(over="ignore"):
            h = idx * c1 + m(np.uint32(seed)) * c2
            h ^= h >> m(16)
            h *= c3
            h ^= h >> m(13)
            h *= c4
            h ^= h >> m(16)
        return ((h >> m(8)).astype(np.float64) / float(1 << 24)) \
            .reshape(shape)

    @classmethod
    def _mask32(cls, seed: torch.Tensor, shape,
                row0: int = 0) -> torch.Tensor:
        """The per-step mask (f32, values k / 2^24) on seed's device, of the
        rows from row0 on."""
        m32 = 0xFFFFFFFF
        c1, c2, c3, c4 = cls._FMIX

        def mul32(h, c):
            # h * c mod 2^32 for 0 <= h < 2^32: c's 16-bit halves keep every
            # product under 2^49
            return (h * (c & 0xFFFF)
                    + (((h * (c >> 16)) & 0xFFFF) << 16)) & m32
        idx = (torch.arange(int(np.prod(shape)), dtype=torch.int64,
                            device=seed.device)
               + cls._first_index(shape, row0)) & m32
        s = seed.reshape(()).to(torch.int64) & m32
        h = (mul32(idx, c1) + mul32(s, c2)) & m32
        h = h ^ (h >> 16)
        h = mul32(h, c3)
        h = h ^ (h >> 13)
        h = mul32(h, c4)
        h = h ^ (h >> 16)
        u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
        return u.reshape(shape)

    @classmethod
    def build(cls, rfs: OpBase):
        if rfs.str_vals.get("drop_mode", "infer") == "infer":
            return lambda x: x
        scale_kept = _scale_kept(_ratio(rfs))
        if "seed" in rfs.nda_vals:
            # per-step seeded mask; arg order is in_args then io_args
            def fn_seeded(seed, x, row0=0):
                return scale_kept(x, cls._mask32(seed, x.shape, row0))
            fn_seeded.takes_row0 = True
            return fn_seeded
        masks: dict = {}

        def fn(x, row0=0):
            # the static mask, in x's dtype as the JAX template bakes it,
            # made once per storage shape, first row, dtype and device
            key = (tuple(x.shape), row0, x.dtype, x.device)
            if key not in masks:
                masks[key] = torch.from_numpy(cls._mask(rfs, x.shape, row0)) \
                    .to(x.dtype).to(x.device)
            return scale_kept(x, masks[key])
        fn.takes_row0 = True
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, *a):
        if len(a) == 2:  # seeded train form: (seed, x)
            seed, x = a
            x = np.asarray(x)
            ratio = _ratio(rfs)
            u = cls._mask32_np(int(np.asarray(seed).reshape(())), x.shape)
            return x * (u >= ratio).astype(x.dtype) / (1.0 - ratio)
        x = np.asarray(a[0])
        if rfs.str_vals.get("drop_mode", "infer") == "infer":
            return x
        ratio = _ratio(rfs)
        u = cls._mask(rfs, x.shape)
        return x * (u >= ratio).astype(x.dtype) / (1.0 - ratio)
