"""tmpl.elementwise_ms (ms, device trace): device time per request of
PyTorch's elementwise, copy and cast kernels (`at::native::*elementwise*`,
its concat copy `CatArrayBatchedCopy*`), which the templates launch around
the convs: casts to and from f32, bias adds, ReLUs, the wire's
preprocessing, concats and layout copies."""

from benchmark.trace import kernel_kind


def is_elementwise(name: str) -> bool:
    k = kernel_kind(name)
    return k.startswith("at::native::") and (
        "elementwise" in k or "CatArrayBatchedCopy" in k)


def read(run):
    t = run.trace
    if t is None:
        return None
    s = t.seconds(is_elementwise)
    return 1e3 * s / t.n if s > 0 else None
