"""matmul_ext (kernel B1), the `sgemm` template on it, and the vendor
`xla_sgemm` template on cuBLAS.

Port of boda_tpu/ops/pallas/sgemm.py. `matmul_ext` wraps the hand-written
CUDA kernel in csrc/sgemm.cu (see its header for what bounds it and how it
is built); `matmul_ext_plain` is the same function in plain PyTorch. The
wrapper checks its operands, then runs the plain version for CPU tensors
and the kernel for CUDA tensors.

Differences from the Pallas version, by design: B arrives as (N, K), the
natural layout of a conv filter, and ragged edges are masked in the kernel
instead of padding A, B and bias in device memory (sgemm.py:184-197).
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.error import RtErr
from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template
from .build import check_launch, load_kernels
from .util import check_operand, full_fp32, torch_dtype, use_kernel


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
    if max(M, N, K) >= 2 ** 31:
        raise RtErr(f"matmul_ext: extent over int32 (M={M} N={N} K={K})")
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

    On CUDA tensors the launch is asynchronous on the current stream; an
    input freed after the call is reused only in that stream's order by
    torch's caching allocator, so no synchronisation is needed."""
    _check(a, b, bias, out_dtype)
    if not use_kernel(a, b, bias):
        return matmul_ext_plain(a, b, bias, relu, out_dtype)
    (M, K), N = a.shape, b.shape[0]
    c = torch.empty((M, N), dtype=out_dtype, device=a.device)
    rc = load_kernels().boda_matmul_ext(
        a.data_ptr(), b.data_ptr(),
        bias.data_ptr() if bias is not None else None, c.data_ptr(),
        M, N, K, int(a.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), int(bool(relu)),
        torch.cuda.current_stream(a.device).cuda_stream)
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
    checks every other tune against: torch.matmul in full FP32, or on bf16
    operands under prec=bf16, summed in f32. A bf16 product comes out of
    cuBLAS rounded once to bf16, where XLA keeps it in f32."""

    name = "xla_sgemm"

    @classmethod
    def build(cls, rfs: OpBase):
        in_dt = torch.bfloat16 if rfs.str_vals.get("prec") == "bf16" \
            else torch.float32
        out_dt = torch_dtype(rfs.get_dims("c").dtype)

        def fn(a, b):
            with full_fp32():
                return torch.matmul(a.to(in_dt), b.to(in_dt)).to(out_dt)
        return fn
