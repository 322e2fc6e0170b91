"""The `gen_data` template: deterministic test patterns as tensors.

Port of boda_tpu/ops/pallas/gen_data.py. The pattern is the JAX package's
own `_pattern_np` (a pure function of the flat index, in float64, cast to
the var's dtype on the host), so both packages feed the per-op runs the
same values bit for bit.

gen_data reads no tensor, so no input tells it where to put its output.
Its built function takes the device as the keyword `device`, and the
backend that compiles it binds its own device there (`takes_device`,
TorchBackend._compile_one): the output is made on the device of the var it
fills, and a CPU tensor never reaches a CUDA var.
"""

from __future__ import annotations

import torch

from boda_tpu.ops.op_base import OpBase
from boda_tpu.ops.pallas import gen_data as jgen_data
from boda_tpu.ops.pallas.gen_data import _pattern_np

from ..registry import takes_device, template


@template
class GenData(jgen_data.GenData):
    @classmethod
    def build(cls, rfs: OpBase):
        d, mode, scale = cls._params(rfs)
        host = torch.from_numpy(
            _pattern_np(mode, d.sz(), scale).astype(d.dtype).reshape(d.shape))

        @takes_device
        def fn(*, device: torch.device):
            return host.to(device, copy=True)
        return fn
