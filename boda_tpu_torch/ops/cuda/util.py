"""Shared helpers of the port's templates: the kernel dispatch rule, the
planner of the GEMM core's kernels, the storage form of a step, and
full-FP32 settings for plain references.

Counterpart of boda_tpu/ops/pallas/util.py. The JAX package picks a Pallas
mode (real / interpret / fallback) from the platform or an environment
variable; the port has one rule and no override: a wrapper given CPU
tensors runs its kernel's plain PyTorch version, a wrapper given CUDA
tensors launches the kernel or raises.
"""

from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass

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


def kernel_wrappers() -> dict:
    """Each hand kernel's wrapper by name; a wrapper's `launches` counts
    its kernel's launches ("quantize": sgemm_int8's quantize kernel;
    "act_quantize": qconv's; "absmax": its first pass alone, a dp slot's
    max; "cotangent_quantize": its per-channel form in the int8 weight
    gradient; "bconv": B7, the bf16 vendor conv)."""
    from .bconv import bconv
    from .qconv import absmax, act_quantize, cotangent_quantize, qconv
    from .qsgemm import quantize_operands, sgemm_int8
    from .resblock import resblock
    from .sgemm import matmul_ext
    from .stem import fused_stem
    from .tconv import tconv
    return {"matmul_ext": matmul_ext, "tconv": tconv,
            "fused_stem": fused_stem, "resblock": resblock,
            "sgemm_int8": sgemm_int8, "quantize": quantize_operands,
            "qconv": qconv, "act_quantize": act_quantize, "absmax": absmax,
            "cotangent_quantize": cotangent_quantize, "bconv": bconv}


def launch_counts(reset: bool = False) -> dict[str, int]:
    """Every hand kernel's launches in this process so far (zeroed after
    the read where reset): what the be=ipc worker reports to its master."""
    ws = kernel_wrappers()
    counts = {n: w.launches for n, w in ws.items()}
    if reset:
        for w in ws.values():
            w.launches = 0
    return counts


def forbid_autograd(name: str, *tensors) -> None:
    """The guard of an inference-only kernel's wrapper (ops/mxu_grad.
    INFERENCE_ONLY): raise where a forward under autograd reaches it, on the
    CPU as on the card. Its plain version would differentiate on the CPU,
    and the kernel's output has no grad_fn: either way the gradient would
    differ from the JAX package, which has no backward for it."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RtErr(f"{name}: an inference-only kernel reached under autograd "
                    f"(its tensors require grad); it has no backward")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device `index`, read once per process (the
    planners size their grids by it on every call)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


GEMM_TILE_M = 128            # block tile rows of the GEMM core
# K chunk of each route (bf16 and int8: 128 bytes on the tensor cores; f32:
# the FFMA tile's 8) and the elements of a 16-byte load
GEMM_BK = {torch.bfloat16: 64, torch.int8: 128, torch.float32: 8}
GEMM_VEC = {torch.bfloat16: 8, torch.int8: 16, torch.float32: 4}


@dataclass(frozen=True)
class GemmPlan:
    """How a kernel on the GEMM core of csrc/hopper_gemm.cuh runs one
    product: its route ("mma": bf16 or int8 on the tensor cores, "ffma":
    f32 on the CUDA cores), whether operands move in 16-byte loads, the block tile,
    the K chunk, and the number of K splits (1: no split-K)."""
    route: str
    vec: bool
    tile_m: int
    tile_n: int
    bk: int
    splits: int
    blocks: int              # tiles of the output, before the split


def gemm_plan(name: str, M: int, N: int, K: int, vec_extent: int,
              tile_n: int, dtype: torch.dtype, sms: int,
              rules: dict) -> GemmPlan:
    """The plan of an [M, N] output summed over K on the core, with
    128 x tile_n block tiles, on a card with `sms` SMs. Operands move in
    16-byte loads where `vec_extent` (the contiguous run the loader reads)
    is a whole number of them. `rules[dtype]` is the kernel's split-K rule
    (below, least, fill, min_chunks): a grid of fewer than `below` tiles
    per SM splits K into the smallest power of two of splits, from `least`,
    that puts `fill` blocks per SM on the card, then into as many splits as
    keep `min_chunks` K chunks each. `name` names the caller in errors."""
    if dtype not in GEMM_BK:
        raise RtErr(f"{name}: dtype {dtype} not f32/bf16/int8")
    blocks = math.ceil(M / GEMM_TILE_M) * math.ceil(N / tile_n)
    chunks = math.ceil(K / GEMM_BK[dtype])
    below, least, fill, min_chunks = rules[dtype]
    splits = 1
    if blocks < below * sms:
        splits = least
        while blocks * splits < fill * sms:
            splits *= 2
        per = max(min_chunks, math.ceil(chunks / splits))
        splits = math.ceil(chunks / per)
    return GemmPlan("ffma" if dtype == torch.float32 else "mma",
                    vec_extent % GEMM_VEC[dtype] == 0, GEMM_TILE_M, tile_n,
                    GEMM_BK[dtype], splits, blocks)


def cuda_stream(dev: torch.device) -> int:
    """The raw handle of dev's current CUDA stream, as
    torch.cuda.current_stream(dev).cuda_stream gives it, without making a
    Stream object on every launch."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


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
    reduced-precision reductions). cuDNN's benchmark and deterministic
    settings stay as the caller set them (the trainer asks for
    deterministic algorithms). Restores the previous settings."""
    mm = torch.backends.cuda.matmul
    prev = mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction
    mm.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    cudnn = torch.backends.cudnn
    try:
        with cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
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
