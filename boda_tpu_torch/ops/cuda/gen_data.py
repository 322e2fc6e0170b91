"""The `gen_data` template: deterministic test patterns as tensors.

Port of boda_tpu/ops/pallas/gen_data.py. `_pattern_np` is a copy of the
JAX package's (a pure function of the flat index, in float64, cast to the
var's dtype on the host), so both packages feed the per-op runs the same
values bit for bit; `gen_test_nda` makes the same pattern for fixtures.

gen_data reads no tensor, so no input tells it where to put its output.
Its built function takes the device as the keyword `device`, and the
backend that compiles it binds its own device there (`takes_device`,
TorchBackend._compile_one): the output is made on the device of the var it
fills, and a CPU tensor never reaches a CUDA var.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.dims import Dims
from ..op_base import OpBase
from ..registry import OUT, KernelTemplate, adecl, takes_device, template


def _pattern_np(mode: int, n: int, scale: float) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    if mode == 0:      # small signed pseudo-random-ish ints, zero-mean
        v = ((i * 7.0 + (i // 13.0)) % 17.0) - 8.0
    elif mode == 1:    # all-ones
        v = np.ones_like(i)
    elif mode == 2:    # ramp
        v = i / max(n - 1, 1)
    elif mode == 3:    # alternating sign ramp
        v = (i % 11.0 - 5.0) * np.where(i % 2 == 0, 1.0, -1.0)
    elif mode == 4:    # sparse spikes
        v = np.where(i % 97 == 0, 10.0, 0.1)
    else:
        raise ValueError(f"unknown gen_data mode {mode}")
    return (v * scale)


def gen_test_nda(dims: Dims, mode: int = 0, scale: float = 1.0) -> np.ndarray:
    """Host-side helper producing the same pattern (for test fixtures)."""
    return _pattern_np(mode, dims.sz(), scale).astype(dims.dtype).reshape(dims.shape)


@template
class GenData(KernelTemplate):
    """Fill `out` with deterministic pattern #mode scaled by `scale`."""

    name = "gen_data"
    args = [adecl("out", OUT, "")]  # any-rank; dims taken from sig
    sig_nda_keys = ["out", "mode", "scale"]

    @classmethod
    def check_args(cls, op: OpBase) -> OpBase:
        rfs = OpBase({"func_name": cls.name})
        rfs.nda_vals["out"] = op.nda_vals["out"]
        for k in ("mode", "scale"):
            if k in op.nda_vals:
                rfs.nda_vals[k] = op.nda_vals[k]
        return rfs

    @classmethod
    def in_args(cls):
        return []

    @classmethod
    def out_args(cls):
        return ["out"]

    @classmethod
    def io_args(cls):
        return []

    @classmethod
    def _params(cls, rfs: OpBase):
        d = rfs.get_dims("out")
        mode = rfs.get_u32_or("mode", 0)
        sc = rfs.nda_vals.get("scale")
        scale = float(sc.item()) if sc is not None and sc.v is not None else 1.0
        return d, mode, scale

    @classmethod
    def ref_impl(cls, rfs: OpBase):
        d, mode, scale = cls._params(rfs)
        return _pattern_np(mode, d.sz(), scale).astype(d.dtype).reshape(d.shape)

    @classmethod
    def build(cls, rfs: OpBase):
        d, mode, scale = cls._params(rfs)
        host = torch.from_numpy(
            _pattern_np(mode, d.sz(), scale).astype(d.dtype).reshape(d.shape))

        @takes_device
        def fn(*, device: torch.device):
            return host.to(device, copy=True)
        return fn
