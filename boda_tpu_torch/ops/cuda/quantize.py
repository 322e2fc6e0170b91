"""The `quantize` template: clamp to +-max_val and keep keep_bits bits below
it, the engine's per-node quantize hook for accuracy studies.

Port of boda_tpu/ops/pallas/quantize.py (Quantize, :24-44), which the JAX
package computes outside Pallas too:
round(clip(x, -max_val, max_val) / max_val * 2^keep_bits)
* (max_val / 2^keep_bits), in the tensor's own dtype.

As the JAX engine computes it (its compiled HLO, checked bit for bit on
the CPU in tests/test_torch_engine_modes.py): its Python numbers are
weak-typed, hence constants of the array's dtype; every op rounds to that
dtype; and XLA compiles a division by a constant into a product with the
constant's reciprocal, which it keeps in f32 (div_const). The constants
are tensors on the tensor's device, so that torch neither divides on the
host nor forms its own reciprocal on a card. torch.round rounds half to
even, like jnp.round.
"""

from __future__ import annotations

import numpy as np
import torch

from ..op_base import OpBase
from ..registry import INOUT, KernelTemplate, adecl, template


def _params(rfs: OpBase):
    mv = rfs.nda_vals.get("max_val")
    kb = rfs.nda_vals.get("keep_bits")
    max_val = float(mv.item()) if mv is not None and mv.v is not None else 1.0
    keep_bits = int(kb.item()) if kb is not None and kb.v is not None else 8
    return max_val, keep_bits


def dtype_consts(x: torch.Tensor, *vals: float) -> list[torch.Tensor]:
    """`vals` as 0-dim tensors of x's dtype on x's device."""
    return [torch.tensor(v, dtype=x.dtype, device=x.device) for v in vals]


def f32_recip(x: torch.Tensor, v: float) -> torch.Tensor:
    """The f32 reciprocal XLA folds for a division by the constant v: v
    rounded to x's dtype, 1 / that in f32; on x's device."""
    c = torch.tensor(v, dtype=x.dtype).float()
    return (torch.tensor(1.0) / c).to(x.device)


def div_const(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """x / v as XLA compiles it: x * f32_recip(x, v) in f32, rounded to x's
    dtype."""
    return (x.float() * inv).to(x.dtype)


@template
class Quantize(KernelTemplate):
    name = "quantize"
    nhwc_ok = True  # elementwise: layout agnostic
    args = [adecl("inout", INOUT, "img chan y x")]
    sig_nda_keys = ["max_val", "keep_bits"]

    @classmethod
    def build(cls, rfs: OpBase):
        max_val, keep_bits = _params(rfs)
        levels = float(1 << keep_bits)
        consts: dict = {}

        def fn(x):
            key = (x.dtype, x.device)
            if key not in consts:
                consts[key] = dtype_consts(x, max_val, levels,
                                           max_val / levels) \
                    + [f32_recip(x, max_val)]
            mv, lv, step, inv_mv = consts[key]
            c = torch.minimum(torch.maximum(x, -mv), mv)
            return torch.round(div_const(c, inv_mv) * lv) * step
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, x):
        max_val, keep_bits = _params(rfs)
        levels = float(1 << keep_bits)
        c = np.clip(np.asarray(x, np.float64), -max_val, max_val)
        return (np.round(c / max_val * levels) * (max_val / levels)).astype(np.asarray(x).dtype)
