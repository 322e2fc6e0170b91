"""Runtime feature registry.

The port's copy of boda_tpu/core/features.py (the reference's compiled-in
feature list, build_info.cc / is_feature_enabled, which test_cmds' needs=
gating reads, test_nesi.cc:677-684). Features are probed at run time. The
platform probes are the port's (torch, cuda, nvcc, as core/device.py
answers them) in place of the JAX package's xla, jax, pallas and tpu; pil,
lmdb, protobuf, zmq, video and cpp are probed as the JAX package does, and
matplotlib (the plot modes') is the port's own.
"""

from __future__ import annotations

import importlib.util
from functools import lru_cache

_PLATFORM = ("torch", "cuda", "nvcc")


@lru_cache(maxsize=None)
def is_feature_enabled(name: str) -> bool:
    if name in _PLATFORM:
        from .device import is_feature_enabled as device_feature
        return device_feature(name)
    if name == "pil":
        return importlib.util.find_spec("PIL") is not None
    if name == "lmdb":
        # the pure-Python LMDB format layer (utils/lmdbmini.py) makes the
        # LMDB paths always available
        return True
    if name == "protobuf":
        return importlib.util.find_spec("google.protobuf") is not None
    if name == "zmq":
        return importlib.util.find_spec("zmq") is not None
    if name == "video":  # OpenCV VideoCapture/VideoWriter (ffmpeg role)
        return importlib.util.find_spec("cv2") is not None
    if name == "matplotlib":  # the plot modes (tune/plots.py)
        return importlib.util.find_spec("matplotlib") is not None
    if name == "cpp":  # the native host core builds (or is built) and loads
        from ..utils.cpplib import cpp_available
        return cpp_available()
    return False
