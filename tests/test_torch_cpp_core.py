"""The port's native host core (boda_tpu_torch/csrc/host, built at first
use by utils/cpplib) against the JAX package's (csrc/, build/
libboda_tpu_core.so) and against the port's Python paths: bottom-left-fill
placement, and the framed stream, whose native and Python sides
interoperate across the two packages. Skipped where there is no C++
compiler (or the JAX package's library is not built); decided in a
fixture, never at import.
"""

from __future__ import annotations

import os
import shutil
import socket

import numpy as np
import pytest

from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.core.geom import Pt

@pytest.fixture(scope="module")
def libs():
    """(the port's cpplib, the JAX package's cpplib), both loaded."""
    if shutil.which(os.environ.get("CXX") or "g++") is None:
        pytest.skip("no C++ compiler for the native host core")
    from boda_tpu.utils import cpplib as jcpp
    from boda_tpu_torch.utils import cpplib as pcpp
    assert pcpp.cpp_available(), "the port's host core did not build"
    if not jcpp.cpp_available():
        pytest.skip("the JAX package's native library is not built")
    return pcpp, jcpp


def test_library_is_built_under_build_host_core(libs):
    pcpp, _ = libs
    p = pcpp.library_path()
    assert p.exists() and p.parent.name == "host_core" \
        and p.parent.parent.name == "build"
    assert sorted(f.name for f in pcpp.CSRC.iterdir()) == [
        "blf_pack.cc", "stream.cc"]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_blf_place_matches_jax_and_python(libs, seed):
    pcpp, jcpp = libs
    from boda_tpu_torch.apps.pyra import blf_place
    rng = np.random.RandomState(seed)
    sizes = [(int(rng.randint(4, 120)), int(rng.randint(4, 120)))
             for _ in range(12)]
    assert pcpp.cpp_blf_place(sizes, (128, 128), (3, 5)) == \
        jcpp.cpp_blf_place(sizes, (128, 128), (3, 5))
    pts = [Pt(y, x) for y, x in sizes]
    assert blf_place(pts, Pt(128, 128), Pt(3, 5), impl="cpp") == \
        blf_place(pts, Pt(128, 128), Pt(3, 5), impl="py")
    with pytest.raises(RtErr, match="larger than bin"):
        blf_place([Pt(200, 4)], Pt(128, 128), Pt(0, 0), impl="cpp")


@pytest.mark.parametrize("port_side", ["writer", "reader"])
def test_stream_interoperates_with_jax(libs, port_side):
    """The port's native stream and the JAX package's native stream on the
    two ends of one socketpair."""
    pcpp, jcpp = libs
    a, b = socket.socketpair()
    fa, fb = os.dup(a.fileno()), os.dup(b.fileno())
    a.close()
    b.close()
    wmod, rmod = (pcpp, jcpp) if port_side == "writer" else (jcpp, pcpp)
    w = wmod.CppStream(f"fds:{fa}:{fa}")
    r = rmod.CppStream(f"fds:{fb}:{fb}")
    frames = [b"hello", b"", bytes(range(256)) * 100]  # fits the buffer
    for f in frames:
        w.write_frame(f)
    assert [r.read_frame() for _ in frames] == frames
    w.close()
    r.close()
