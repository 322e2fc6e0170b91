"""Interpreter/reference backend: numpy execution of template ref impls.

Plays the role the OpenCL backend played in the reference (ocl_util.cc:216):
a second, independent implementation of the full Backend contract that
proves the abstraction and provides the known-good comparison path for
cross-backend digest tests (test_compute semantics) without any device.

The port's copy of boda_tpu/backend/interp.py: be=interp, the known-good
second backend of the port's per-op modes.
"""

from __future__ import annotations

import numpy as np

from ..core.config import register
from ..core.dims import Dims
from ..core.error import RtErr
from .iface import Backend


@register(Backend, "interp", help="numpy reference backend")
class InterpBackend(Backend):
    kind = "ref"

    def get_plat_tag(self) -> str:
        return "interp:numpy"

    def _alloc(self, dims: Dims):
        dt = dims.dtype
        if dt is None:
            raise RtErr(f"can't allocate var with tn=none dims {dims}")
        return np.zeros(dims.shape, dtype=dt)

    def _to_device(self, v):
        return np.asarray(v)

    def _to_host(self, v):
        return np.asarray(v)
