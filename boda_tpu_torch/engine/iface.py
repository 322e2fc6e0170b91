"""Network execution engine interface: the has_conv_fwd_t equivalent.

Capability parity with has_conv_fwd.H: a 3-method engine —
init(pipe), run_fwd(to_set, to_get), get_info_log() — selected
polymorphically (reference engines: 'rtc' generated-kernel engine and
'caffe' known-good reference engine).

The port's copy of boda_tpu/engine/iface.py, with two engines: 'torch'
(engine/torch_fwd.py, the counterpart of the JAX package's 'rtc') and
'ref', the float64 numpy reference (engine/ref_fwd.py).
"""

from __future__ import annotations

from typing import Union

from ..core.config import Config
from ..core.dims import NDA
from ..graph.pipe import ConvPipe


class ConvFwd(Config):
    """Polymorphic base: select with engine=<type_id>."""

    TID_KEY = "engine"

    def init(self, pipe: ConvPipe) -> None:
        raise NotImplementedError

    def run_fwd(self, to_set: dict[str, NDA], to_get: list[str]) -> dict[str, NDA]:
        raise NotImplementedError

    def get_info_log(self) -> str:
        return ""

    def set_input_preproc(self, node: str, fn, wire_dims) -> None:
        """Put a device-side transform in front of input `node` (the torch
        fused executor only): the caller feeds `node` tensors of
        `wire_dims`, and fn turns them into the plan's input."""
        from ..core.error import RtErr
        raise RtErr(f"engine '{type(self).__name__}' does not support "
                    "device-side input preprocessing (rtc fused engine only)")


def make_engine(spec: Union[str, dict, None] = None) -> ConvFwd:
    from . import ref_fwd, torch_fwd  # noqa: F401  (register the engines)
    if spec is None:
        spec = "torch"
    if isinstance(spec, dict):
        from ..core.lexp import Lexp
        return ConvFwd.init_from_lexp(Lexp.from_obj(spec))
    if not spec.startswith("("):
        spec = f"(engine={spec})"
    return ConvFwd.init_from_lexp(spec)
