"""The native host core (boda_tpu_torch/csrc/host) and its typed wrappers.

The port's copy of boda_tpu/utils/cpplib.py, for the two host paths the
port can ask for natively: the framed stream transport (stream.cc) and
bottom-left-fill bin packing (blf_pack.cc). The JAX package's native lexp
parser and nda digest have no copy here: the port parses and digests in
Python, and nothing in it would call them. Where the JAX package loads a
library built beforehand (make -C csrc), the port builds its own copy of
the sources at first use, in the function that loads them: one host
compiler call per source ($CXX, else g++ on PATH), all started together,
then one link, into `build/host_core/` of the checkout, named by a hash of
the sources and flags, so a later process with the same sources loads the
existing library.

The Python paths stay the defaults. The native stream and placement are
asked for by name (impl='cpp' of make_stream and blf_place) and raise where
the library cannot be built; nothing switches between them on its own.
tests/test_torch_cpp_core.py holds the library to the JAX package's and
to the Python paths.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from ..core.error import RtErr

CSRC = Path(__file__).resolve().parents[1] / "csrc" / "host"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host_core"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra"]


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RtErr("the native host core needs a C++ compiler ($CXX or g++ "
                    "on PATH); none found")
    return cxx


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libboda_host_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the host core if this source hash has no library yet. The
    library is written to a temporary name and renamed into place, so a
    concurrent process never loads a half-written file."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = _compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = sorted(CSRC.glob("*.cc"))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [str(Path(tmpdir) / f"{p.stem}.o") for p in srcs]
        procs = [subprocess.Popen([cxx, *CXX_FLAGS, "-c", "-o", o, str(p)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for o, p in zip(objs, srcs)]
        outs = [p.communicate()[0] for p in procs]
        failed = [f"{s.name} -> {p.returncode}\n{o}"
                  for s, p, o in zip(srcs, procs, outs) if p.returncode]
        if failed:
            raise RtErr("host core build failed:\n" + "\n".join(failed))
        tmp = str(Path(tmpdir) / lib.name)
        r = subprocess.run([cxx, "-shared", "-o", tmp, *objs],
                           capture_output=True, text=True)
        if r.returncode:
            raise RtErr(f"host core link failed:\n{r.stdout}{r.stderr}")
        os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def load_cpp() -> ctypes.CDLL:
    """The host core of this checkout, built at first use and loaded once
    per process; raises where it cannot be built."""
    lib = ctypes.CDLL(str(build_library()))
    _declare(lib)
    return lib


@functools.lru_cache(maxsize=1)
def cpp_available() -> bool:
    """Whether the host core builds (or is built) and loads here."""
    try:
        load_cpp()
    except (RtErr, OSError):
        return False
    return True


def _declare(lib: ctypes.CDLL) -> None:
    lib.boda_stream_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_char_p, ctypes.c_int]
    lib.boda_stream_open.restype = ctypes.c_int
    lib.boda_stream_write_frame.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                            ctypes.c_int64]
    lib.boda_stream_write_frame.restype = ctypes.c_int
    lib.boda_stream_read_frame.argtypes = [ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_void_p)]
    lib.boda_stream_read_frame.restype = ctypes.c_int64
    lib.boda_stream_buf_free.argtypes = [ctypes.c_void_p]
    lib.boda_stream_close.argtypes = [ctypes.c_int]
    lib.boda_stream_close.restype = ctypes.c_int

    lib.boda_blf_place.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.boda_blf_place.restype = ctypes.c_int32


# ---- stream ----

class CppStream:
    """Framed stream over the native transport (same wire format as
    parallel/transport.py Stream)."""

    def __init__(self, addr: str, is_server: bool = False):
        self._lib = load_cpp()
        err = ctypes.create_string_buffer(512)
        self.h = self._lib.boda_stream_open(addr.encode(), int(is_server), err, 512)
        if self.h < 0:
            raise RtErr(err.value.decode())

    def write_frame(self, payload: bytes) -> None:
        if self._lib.boda_stream_write_frame(self.h, payload, len(payload)) != 0:
            raise RtErr("cpp stream: write failed")

    def read_frame(self) -> bytes:
        out = ctypes.c_void_p()
        n = self._lib.boda_stream_read_frame(self.h, ctypes.byref(out))
        if n < 0:
            raise RtErr("stream: EOF while reading")
        try:
            return ctypes.string_at(out, n)
        finally:
            self._lib.boda_stream_buf_free(out)

    def close(self) -> None:
        self._lib.boda_stream_close(self.h)


# ---- blf packing ----

def cpp_blf_place(sizes, bin_sz, pad):
    """sizes: list of (y,x); returns (n_bins, [(bin_ix, y0, x0), ...]) or
    raises on an oversized rect (mirrors blf_place's RtErr)."""
    lib = load_cpp()
    n = len(sizes)
    arr = (ctypes.c_int64 * (2 * n))()
    for i, (y, x) in enumerate(sizes):
        arr[2 * i] = int(y)
        arr[2 * i + 1] = int(x)
    out = (ctypes.c_int64 * (3 * n))()
    nb = lib.boda_blf_place(arr, n, int(bin_sz[0]), int(bin_sz[1]),
                            int(pad[0]), int(pad[1]), out)
    if nb < 0:
        raise RtErr(f"blf_place: rect larger than bin {bin_sz}")
    return nb, [(out[3 * i], out[3 * i + 1], out[3 * i + 2]) for i in range(n)]
