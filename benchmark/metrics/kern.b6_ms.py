"""kern.b6_ms (ms, device trace): device time per request of the port's int8
conv (kernel B6, csrc/qconv.cu: `qconv_kernel` and its split-K
`qconv_reduce`) and of its activation quantize (`act_quant_write`, and the
dynamic scale's `quant_amax`, `quant_amax_fold`). Nothing where the cell runs
no int8 site."""

from benchmark.trace import kernel_kind

KINDS = {"qconv_kernel", "qconv_reduce", "act_quant_write", "act_quant_xpose",
         "quant_amax", "quant_amax_fold", "quant_colmax"}


def read(run):
    t = run.trace
    if t is None:
        return None
    s = t.seconds(lambda n: kernel_kind(n).split("::")[-1] in KINDS)
    return 1e3 * s / t.n if s > 0 else None
