"""io.memcpy_ms (ms, device trace): device time of the host-to-card and
card-to-host copies per request in the traced stretch: the u8 batch's upload
and the logits' readback in `run_fwd`."""


def read(run):
    t = run.trace
    if t is None:
        return None
    s = t.seconds(lambda n: "HtoD" in n or "DtoH" in n, cat="gpu_memcpy")
    return 1e3 * s / t.n if s > 0 else None
