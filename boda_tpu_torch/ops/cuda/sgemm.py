"""matmul_ext (kernel B1), the `sgemm` template on it, and the vendor
`xla_sgemm` template on cuBLAS.

Port of boda_tpu/ops/pallas/sgemm.py. `matmul_ext` wraps the hand-written
CUDA kernel in csrc/sgemm.cu (see its header for what bounds it and how it
is built): bf16 on the tensor cores, f32 in full FP32 on FFMA, both on the
GEMM core of csrc/hopper_gemm.cuh. `matmul_plan` picks its tile width and
its K split; `matmul_ext_plain` is the same function in plain PyTorch. The
wrapper checks its operands, then runs the plain version for CPU tensors
and the kernel for CUDA tensors.

Differences from the Pallas version, by design: B arrives as (N, K), the
natural layout of a conv filter, and ragged edges are masked in the kernel
instead of padding A, B and bias in device memory (sgemm.py:184-197).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ...core.error import RtErr
from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template
from .build import check_launch, load_kernels
from .util import GemmPlan, check_operand, cuda_stream, full_fp32, \
    gemm_plan, sm_count, torch_dtype, use_kernel


GRID_Y = 65535               # CUDA's limit on grid.y (the N tiles)
# Split-K, by route, as util.gemm_plan reads it: (split grids of fewer than
# this many output tiles per SM, least split count, blocks per SM a split
# grid reaches, least K chunks a split sums). From the kernel timed alone by
# split count at the fc1000 and res4/res5 1x1 shapes of ResNet-50 (the
# `matmul splits` lines of chip_smoke.py; PERF.md). f32 (FFMA): fastest in
# 32 splits on the fc at
# M=1 and 32 (0.014-0.018 ms, 0.15-0.17 unsplit) and at res5a_branch2a at
# b1 (0.012-0.015 ms; 0.014-0.020 in 64 splits of 2 chunks), in 4 at
# res5a_branch2a at b32 (52 tiles: 0.070 ms, 0.132 unsplit); no faster
# split at res4b_branch2a b32 (98 tiles: 0.130-0.138 ms in 1-8) and slower
# at res5b_branch2c b32 (208 tiles: 0.122 unsplit, 0.152 in 4). bf16
# (wgmma) is short, and splits past half the SMs add only the workspace's
# round trip (res5a_branch2a b32: 0.0145-0.0158 ms in 2 splits, 0.016 in 1
# and in 4).
SPLIT = {torch.bfloat16: (0.5, 1, 0.5, 2), torch.float32: (0.5, 4, 1.5, 4)}


@functools.lru_cache(maxsize=4096)
def matmul_plan(M: int, N: int, K: int, dtype: torch.dtype,
                sms: int) -> GemmPlan:
    """The kernel's plan for a[M, K] . b[N, K]^T in dtype on a card with
    `sms` SMs. The block tile is 128 rows by 64 or 128 columns, whichever
    covers N with fewer columns (128 on a tie); K splits as the route's
    SPLIT rule says (util.gemm_plan)."""
    tile_n = 64 if math.ceil(N / 64) * 64 < math.ceil(N / 128) * 128 else 128
    return gemm_plan("matmul_plan", M, N, K, K, tile_n, dtype, sms, SPLIT)


def _check(a, b, bias, out_dtype):
    check_operand(a, "matmul_ext a", 2)
    check_operand(b, "matmul_ext b", 2)
    if b.dtype != a.dtype:
        raise RtErr(f"matmul_ext: a is {a.dtype} but b is {b.dtype}")
    (M, K), (N, Kb) = a.shape, b.shape
    if Kb != K:
        raise RtErr(f"matmul_ext: a {tuple(a.shape)} and b (N,K) "
                    f"{tuple(b.shape)} disagree on K")
    if min(M, N, K) < 1:
        raise RtErr(f"matmul_ext: empty product M={M} N={N} K={K}")
    # the kernel indexes in 64 bits: only each extent must fit an int, and
    # the N tiles of even the 64-wide tile grid.y
    if max(M, N, K) >= 2 ** 31 or N > GRID_Y * 64:
        raise RtErr(f"matmul_ext: extent over int32 or N over "
                    f"{GRID_Y * 64} (M={M} N={N} K={K})")
    if bias is not None:
        check_operand(bias, "matmul_ext bias", 1, (torch.float32,))
        if bias.shape[0] != N:
            raise RtErr(f"matmul_ext: bias length {bias.shape[0]} != N={N}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise RtErr(f"matmul_ext: output dtype {out_dtype} not f32/bf16")


def matmul_ext_plain(a, b, bias=None, relu=False, out_dtype=torch.float32):
    """Plain PyTorch matmul_ext: f32 matmul of the f32-cast operands (full
    FP32 on a card), + bias in f32, ReLU, one cast to out_dtype."""
    with full_fp32():
        c = torch.matmul(a.float(), b.float().t())
    if bias is not None:
        c = c + bias
    if relu:
        c = torch.relu(c)
    return c.to(out_dtype)


def matmul_ext(a, b, bias=None, relu=False, out_dtype=torch.float32):
    """C[M,N] = relu?(a[M,K] . b[N,K]^T + bias[N]) accumulated in f32.

    a and b: contiguous, both f32 or both bf16. bias: contiguous f32 [N] or
    None. Returns a new [M,N] tensor of out_dtype (f32 or bf16).

    A split-K plan (matmul_plan) adds an f32 workspace of splits x M x N
    for the partial sums and a second kernel that adds them; the call still
    counts one launch in matmul_ext.launches.

    On CUDA tensors the launches are asynchronous on the current stream; an
    input (or the workspace) freed after the call is reused only in that
    stream's order by torch's caching allocator, so no synchronisation is
    needed."""
    _check(a, b, bias, out_dtype)
    if not use_kernel(a, b, bias):
        return matmul_ext_plain(a, b, bias, relu, out_dtype)
    (M, K), N = a.shape, b.shape[0]
    plan = matmul_plan(M, N, K, a.dtype, sm_count(a.device.index))
    # torch allocations are 256-byte aligned; a view into one may not be
    vec = plan.vec and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    c = torch.empty((M, N), dtype=out_dtype, device=a.device)
    ws = torch.empty((plan.splits, M, N), dtype=torch.float32,
                     device=a.device) if plan.splits > 1 else None
    rc = load_kernels().boda_matmul_ext(
        a.data_ptr(), b.data_ptr(),
        bias.data_ptr() if bias is not None else None, c.data_ptr(),
        M, N, K, int(a.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), int(bool(relu)),
        ws.data_ptr() if ws is not None else None, plan.tile_n, plan.splits,
        int(vec), cuda_stream(a.device))
    check_launch(rc, "matmul_ext")
    matmul_ext.launches += 1
    return c


matmul_ext.launches = 0


def _mnk(rfs: OpBase) -> tuple[int, int, int]:
    a = rfs.get_dims("a")
    b = rfs.get_dims("b")
    return a["M"], b["N"], a["K"]


class _SgemmBase(KernelTemplate):
    """The sgemm family's metadata (boda_tpu/ops/pallas/sgemm.py:210-267):
    c[M,N] = a[M,K] . b[K,N], referenced in float64."""

    args = [adecl("a", IN, "M K"), adecl("b", IN, "K N"), adecl("c", OUT, "M N")]
    sig_str_keys = ["prec"]

    @classmethod
    def flops(cls, rfs: OpBase) -> int:
        M, N, K = _mnk(rfs)
        return 2 * M * N * K

    @classmethod
    def ref_impl(cls, rfs: OpBase, a, b):
        return np.asarray(a, np.float64) @ np.asarray(b, np.float64)


@template
class Sgemm(_SgemmBase):
    """c[M,N] = a[M,K] . b[K,N] on kernel B1 (JAX: Pallas sgemm)."""

    name = "sgemm"
    sig_nda_keys = ["work"]

    @classmethod
    def build(cls, rfs: OpBase):
        in_dt = torch.bfloat16 if rfs.str_vals.get("prec") == "bf16" \
            else torch_dtype(rfs.get_dims("a").dtype)
        out_dt = torch_dtype(rfs.get_dims("c").dtype)

        def fn(a, b):
            # the sig's b is (K, N); the kernel takes (N, K)
            return matmul_ext(a.to(in_dt).contiguous(),
                              b.to(in_dt).t().contiguous(), out_dtype=out_dt)
        return fn


@template
class XlaSgemm(_SgemmBase):
    """The vendor sgemm (cuBLAS's role; jnp.dot on XLA in the JAX package,
    sgemm.py:236-267), which ops_prof's kg tune (use_culibs=1) runs and
    checks every other tune against: torch.matmul in full FP32, or, under
    prec=bf16, the f32 product of the bf16-rounded operands, summed in f32
    and not rounded again (as jnp.dot with preferred_element_type=f32,
    sgemm.py:260). On the card that is cuBLAS's bf16 GEMM with an f32
    output (torch.mm's out_dtype); a torch without it raises."""

    name = "xla_sgemm"

    @classmethod
    def build(cls, rfs: OpBase):
        bf16 = rfs.str_vals.get("prec") == "bf16"
        out_dt = torch_dtype(rfs.get_dims("c").dtype)

        def fn(a, b):
            with full_fp32():
                if not bf16:
                    c = torch.matmul(a.float(), b.float())
                elif a.is_cuda:
                    c = torch.mm(a.bfloat16(), b.bfloat16(),
                                 out_dtype=torch.float32)
                else:
                    c = torch.matmul(a.bfloat16().float(),
                                     b.bfloat16().float())
                return c.to(out_dt)
        return fn
