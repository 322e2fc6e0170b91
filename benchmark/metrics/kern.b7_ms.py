"""kern.b7_ms (ms, device trace): device time per request of the port's bf16
vendor conv (kernel B7, csrc/bconv.cu: `bconv_kernel` and its split-K
`bconv_reduce`), which the float convs of xla_conv, xla_conv2 and s2d_conv
run on under prec=bf16 with NHWC storage. Nothing where the program has no
such kernel."""

from benchmark.trace import kernel_kind

KINDS = {"bconv_kernel", "bconv_reduce"}


def read(run):
    t = run.trace
    if t is None:
        return None
    s = t.seconds(lambda n: kernel_kind(n).split("::")[-1] in KINDS)
    return 1e3 * s / t.n if s > 0 else None
