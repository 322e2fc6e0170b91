"""kern.b8_ms (ms, device trace): device time per request of the port's
grouped conv (kernel B8, csrc/gconv.cu: `gconv_kernel`), which the grouped
convs of xla_conv run on under prec=bf16 with NHWC storage. Nothing where the
program has no such kernel, or the cell no grouped conv."""

from benchmark.trace import kernel_kind


def read(run):
    t = run.trace
    if t is None:
        return None
    s = t.seconds(lambda n: kernel_kind(n).split("::")[-1] == "gconv_kernel")
    return 1e3 * s / t.n if s > 0 else None
