"""Shared helpers of the port's templates: the kernel dispatch rule, the
storage form of a step, and full-FP32 settings for plain references.

Counterpart of boda_tpu/ops/pallas/util.py. The JAX package picks a Pallas
mode (real / interpret / fallback) from the platform or an environment
variable; the port has one rule and no override: a wrapper given CPU
tensors runs its kernel's plain PyTorch version, a wrapper given CUDA
tensors launches the kernel or raises.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ...core.error import RtErr
from ..op_base import OpBase

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
}
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def torch_dtype(np_dtype) -> torch.dtype:
    """torch dtype of a node's numpy dtype (Dims.dtype)."""
    dt = _NP_TO_TORCH.get(np.dtype(np_dtype))
    if dt is None:
        raise RtErr(f"no torch dtype for node dtype {np_dtype}")
    return dt


def use_kernel(*tensors) -> bool:
    """The dispatch rule: False when every tensor lies on the CPU (run the
    plain version), True when every tensor lies on one CUDA device (launch
    the kernel). Anything else raises."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise RtErr(f"tensors on mixed devices {sorted(map(str, devs))}")
    (dev,) = devs
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        # the kernels launch on the calling thread's current device
        if dev.index != torch.cuda.current_device():
            raise RtErr(f"tensors on {dev} but the current CUDA device is "
                        f"{torch.cuda.current_device()} (use "
                        f"torch.cuda.device({dev.index}))")
        return True
    raise RtErr(f"no kernel for device '{dev}' (cuda or cpu)")


def storage_io(rfs: OpBase) -> tuple[bool, torch.dtype | None]:
    """(io_nhwc, edge dtype or None) of a reduced sig.

    The fused-storage lowering pass (engine/lower.py) marks every step of
    a plan io_layout=nhwc, plus edge_prec=bf16 under prec=bf16: the step
    then takes and returns NHWC tensors, stored in bf16 where edge_prec
    says so."""
    nhwc = rfs.str_vals.get("io_layout") == "nhwc"
    edt = torch.bfloat16 if rfs.str_vals.get("edge_prec") == "bf16" else None
    return nhwc, edt


def store_dtype(rfs: OpBase) -> torch.dtype:
    """Stored dtype of a step's "out": the edge dtype in storage form
    (where edge_prec sets one), else the node's dtype."""
    io_nhwc, edt = storage_io(rfs)
    odt = torch_dtype(rfs.get_dims("out").dtype)
    return (edt or odt) if io_nhwc else odt


def compute_dtype(rfs: OpBase) -> torch.dtype:
    """Operand dtype of a matrix product: bf16 under prec=bf16, else f32."""
    return torch.bfloat16 if rfs.str_vals.get("prec") == "bf16" \
        else torch.float32


@contextlib.contextmanager
def full_fp32():
    """Run f32 matmuls and cuDNN convs in full FP32, not TF32 (the port of
    the JAX package's Precision.HIGHEST), and sum bf16 matmuls in f32 (no
    reduced-precision reductions). Restores the previous settings."""
    mm = torch.backends.cuda.matmul
    prev = mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction
    mm.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction = prev


def check_operand(t: torch.Tensor, name: str, ndim: int,
                  dtypes=KERNEL_DTYPES) -> None:
    """Raise unless `t` is a contiguous tensor of rank `ndim` in `dtypes`."""
    if not isinstance(t, torch.Tensor):
        raise RtErr(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dim() != ndim:
        raise RtErr(f"{name}: expected {ndim}-d, got shape {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise RtErr(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise RtErr(f"{name}: must be contiguous")
