"""setup_s (s, host clock): from the start of the command's main to the end
of the warm-up: imports, the card's initialisation, weights, the request pool,
the int8 calibration, the engine's init (and in a checkout's first run the
kernels' build) and the warm-up requests."""


def read(run):
    return run.setup_s
