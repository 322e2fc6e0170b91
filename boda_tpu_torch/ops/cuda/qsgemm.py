"""sgemm_int8 (kernel B3) and the `sgemm_int8` template.

Port of boda_tpu/ops/pallas/qsgemm.py. `sgemm_int8(a, b)` quantizes both
f32 operands symmetrically per tensor, exactly as the Pallas template's
`qsym` does (qsgemm.py:55-59), then multiplies the int8 values (int32 sums,
one f32 multiply by sa * sb). Both halves are hand-written CUDA kernels in
csrc/qsgemm.cu: `quantize_operands` (two launches: the amax of both
operands, then the scales and the int8 copies, B written transposed so that
both operands reach the product with K contiguous) and `int8_product`
(int8 wgmma on the GEMM core of csrc/hopper_gemm.cuh). The JAX package
computes `qsym` outside its Pallas kernel, as plain work; the port writes
it as a kernel because the call's time is what its users pay.
`quantize_operands_plain` and `sgemm_int8_plain` are the same functions in
plain PyTorch.

The integer sum is exact and the roundings are the same, so the kernels,
their plain versions and the Pallas body give bit-equal results. Each
wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.error import RtErr
from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template
from .build import check_launch, load_kernels
from .sgemm import _mnk
from .util import check_operand, cuda_stream, forbid_autograd, use_kernel

# the largest K for which no sum of K products of two values in [-127, 127]
# overflows the int32 accumulator
K_MAX = 2 ** 31 // 127 ** 2
_N_MAX = 65535 * 128  # the kernel's grid puts N / 128 tiles on gridDim.y


def quantize(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q, scale) with v ~ q * scale: the Pallas template's qsym. amax =
    max(|v|, 1e-30), scale = amax / 127 in f32, q = clip(round(v / scale),
    -127, 127) as int8, rounding half to even. scale is a 0-d tensor on v's
    device. Both divisions take a tensor divisor: torch multiplies by the
    reciprocal when the divisor is a Python number on a card, which can round
    differently from the division."""
    amax = v.abs().amax().clamp_min(1e-30)
    scale = amax / torch.full((), 127.0, device=v.device)
    q = torch.round(v / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def quantize_operands_plain(a: torch.Tensor, b: torch.Tensor):
    """The quantize pass of sgemm_int8(a[M,K], b[K,N]) in plain PyTorch:
    (qa int8 [M,K], qb int8 [N,K] (B transposed), sa * sb as an f32 [1]
    tensor)."""
    qa, sa = quantize(a)
    qb, sb = quantize(b)
    return qa, qb.t().contiguous(), (sa * sb).reshape(1)


def quantize_operands(a: torch.Tensor, b: torch.Tensor):
    """The quantize pass of sgemm_int8(a[M,K], b[K,N]), as
    quantize_operands_plain returns it: the plain version on CPU tensors,
    the two-launch kernel on CUDA tensors (counted once a call in
    quantize_operands.launches). a, b: contiguous f32."""
    check_operand(a, "sgemm_int8 a", 2, (torch.float32,))
    check_operand(b, "sgemm_int8 b", 2, (torch.float32,))
    (M, K), (Kb, N) = a.shape, b.shape
    if Kb != K:
        raise RtErr(f"sgemm_int8: a {tuple(a.shape)} and b (K,N) "
                    f"{tuple(b.shape)} disagree on K")
    if not use_kernel(a, b):
        return quantize_operands_plain(a, b)
    lib = load_kernels()
    qa = torch.empty((M, K), dtype=torch.int8, device=a.device)
    qb = torch.empty((N, K), dtype=torch.int8, device=a.device)
    ws = torch.empty(lib.boda_quantize_ws_floats(), dtype=torch.float32,
                     device=a.device)
    rc = lib.boda_quantize_int8(
        a.data_ptr(), b.data_ptr(), qa.data_ptr(), qb.data_ptr(),
        ws.data_ptr(), M, K, N, cuda_stream(a.device))
    check_launch(rc, "sgemm_int8 quantize")
    quantize_operands.launches += 1
    return qa, qb, ws[:1]


quantize_operands.launches = 0


def _check(a, b):
    check_operand(a, "sgemm_int8 a", 2, (torch.float32,))
    check_operand(b, "sgemm_int8 b", 2, (torch.float32,))
    (M, K), (Kb, N) = a.shape, b.shape
    if Kb != K:
        raise RtErr(f"sgemm_int8: a {tuple(a.shape)} and b (K,N) "
                    f"{tuple(b.shape)} disagree on K")
    if min(M, N, K) < 1:
        raise RtErr(f"sgemm_int8: empty product M={M} N={N} K={K}")
    if K > K_MAX:
        raise RtErr(f"sgemm_int8: K={K} > {K_MAX} could overflow the int32 "
                    f"accumulator")


def _product_plain(qa, qb, s):
    """The exact integer product qa . qb^T in plain PyTorch (int64 on the
    CPU; float64 on a card, exact because every sum is below 2^53), then
    the kernel's epilogue: one rounding to f32, times s in f32."""
    if qa.device.type == "cpu":
        acc = torch.matmul(qa.long(), qb.long().t())
    else:
        acc = torch.matmul(qa.double(), qb.double().t())
    return acc.to(torch.float32) * s


def sgemm_int8_plain(a, b):
    """Plain PyTorch sgemm_int8: the same quantize pass, the exact integer
    product and the same f32 dequant."""
    _check(a, b)
    return _product_plain(*quantize_operands_plain(a, b))


def int8_product(qa, qb, s):
    """The kernel's own part of sgemm_int8: f32(qa[M,K] . qb[N,K]^T) * s,
    on quantize_operands' outputs (contiguous int8, s an f32 [1] tensor).
    Plain PyTorch on CPU tensors, the kernel on CUDA tensors."""
    check_operand(qa, "sgemm_int8 qa", 2, (torch.int8,))
    check_operand(qb, "sgemm_int8 qb", 2, (torch.int8,))
    check_operand(s, "sgemm_int8 scale", 1, (torch.float32,))
    (M, K), N = qa.shape, qb.shape[0]
    if qb.shape[1] != K or s.numel() != 1 or K > K_MAX or M >= 2 ** 31 \
            or N > _N_MAX:
        raise RtErr(f"sgemm_int8: operands {tuple(qa.shape)}, "
                    f"{tuple(qb.shape)}, scale {tuple(s.shape)} (K <= {K_MAX}, "
                    f"N <= {_N_MAX})")
    if not use_kernel(qa, qb, s):
        return _product_plain(qa, qb, s)
    c = torch.empty((M, N), dtype=torch.float32, device=qa.device)
    rc = load_kernels().boda_sgemm_int8(
        qa.data_ptr(), qb.data_ptr(), s.data_ptr(), c.data_ptr(), M, N, K,
        cuda_stream(qa.device))
    check_launch(rc, "sgemm_int8")
    sgemm_int8.launches += 1
    return c


def sgemm_int8(a, b):
    """C[M,N] = f32(quant8(a)[M,K] . quant8(b)[K,N]) * (sa * sb).

    a, b: contiguous f32. Returns a new f32 [M,N] tensor. Raises for K over
    K_MAX, where the int32 sum could overflow. The product's launches are
    counted in sgemm_int8.launches, the quantize pass's in
    quantize_operands.launches.

    On CUDA tensors the quantize pass and the product are asynchronous on
    the current stream: the product reads sa * sb from device memory."""
    _check(a, b)
    forbid_autograd("sgemm_int8", a, b)
    use_kernel(a, b)  # raises for mixed or unsupported devices
    return int8_product(*quantize_operands(a, b))


sgemm_int8.launches = 0


def _quant_sym_np(v):
    """Symmetric max-abs quantization: (q, scale) with v ~ q * scale
    (boda_tpu/ops/pallas/qsgemm.py:21-26)."""
    amax = np.abs(v).max() or 1.0
    scale = amax / 127.0
    q = np.clip(np.round(v / scale), -127, 127).astype(np.int8)
    return q, np.float32(scale)


@template
class SgemmInt8(KernelTemplate):
    """c[M,N] = dequant(quant8(a) . quant8(b)) on kernel B3 (JAX: Pallas
    sgemm_int8). The `work` block shapes of the sig are not used."""

    name = "sgemm_int8"
    args = [adecl("a", IN, "M K"), adecl("b", IN, "K N"),
            adecl("c", OUT, "M N")]
    sig_nda_keys = ["work"]

    @classmethod
    def flops(cls, rfs: OpBase) -> int:
        M, N, K = _mnk(rfs)
        return 2 * M * N * K

    @classmethod
    def ref_impl(cls, rfs: OpBase, a, b):
        qa, sa = _quant_sym_np(np.asarray(a, np.float32))
        qb, sb = _quant_sym_np(np.asarray(b, np.float32))
        acc = qa.astype(np.int64) @ qb.astype(np.int64)
        return (acc.astype(np.float64) * (float(sa) * float(sb))) \
            .astype(np.float32)

    @classmethod
    def build(cls, rfs: OpBase):
        def fn(a, b):
            return sgemm_int8(a.float().contiguous(), b.float().contiguous())
        return fn
