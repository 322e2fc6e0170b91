"""tmpl.vendor_conv_ms (ms, device trace): device time per request of the
vendor library's conv kernels, which the templates' vendor convs
(`ops/cuda/conv.vendor_conv`, `conv2`, `ops/mxu_grad._conv_fwd`) launch:
cuDNN's own (`cudnn::*`, its layout transforms `nchwToNhwcKernel` and
`nhwcToNchwKernel`, `convolve_common_engine_*`, the FFT algorithm's
`fft2d_*`, `flip_filter` and `pointwise_mult_and_sum_complex`) and the
xmma/CUTLASS kernels it dispatches (`sm80_xmma_fprop_*`, the FFT's complex
`sm80_xmma_gemm_cf32*`). Names seen on an H100 with torch 2.11 + cu128."""

from benchmark.trace import kernel_kind

MARKS = ("cudnn", "xmma", "cutlass", "convolve", "fprop", "conv2d",
         "winograd", "nchwToNhwc", "nhwcToNchw", "fft", "flip_filter",
         "pointwise_mult_and_sum_complex")


def is_vendor_conv(name: str) -> bool:
    k = kernel_kind(name)
    return not k.startswith("at::") and any(m in k for m in MARKS)


def read(run):
    t = run.trace
    if t is None:
        return None
    s = t.seconds(is_vendor_conv)
    return 1e3 * s / t.n if s > 0 else None
