"""engine.launches (count, device trace): kernels launched on the card per
request in the traced stretch, every kernel of the forward and of the wire's
preprocessing: what the engine and the lowering put on the card."""


def read(run):
    t = run.trace
    if t is None or not t.kernels():
        return None
    return len(t.kernels()) / t.n
