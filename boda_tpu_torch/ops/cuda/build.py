"""Build and load the port's hand-written CUDA kernels (boda_tpu_torch/csrc).

At first use, every `csrc/*.cu` is compiled by its own `nvcc` for sm_90a,
all started together, and the objects are linked into one shared library
with a plain C interface, under `build/torch_kernels/` of the checkout,
named by a hash of the sources and flags; a later process with the same
sources loads the existing library. The library is bound
with ctypes: every entry point gets explicit `argtypes`, with `c_void_p`
for pointers and the stream (a bare Python int would be cut to 32 bits).

No PyTorch header is compiled, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

from ...core.device import nvcc_path
from ...core.error import RtErr

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
# C entry point -> argtypes (each launcher returns its cudaGetLastError())
ENTRY_POINTS = {
    # A, B, bias, C, M, N, K, in_bf16, out_bf16, relu, ws, tile_n, splits,
    # vec, stream
    "boda_matmul_ext": [_P] * 4 + [_I] * 6 + [_P] + [_I] * 3 + [_P],
    # x, w, bias, out, ws, n, H, W, C, oc, ky, kx, py, px, in_bf16,
    # out_bf16, relu, splits, vec, stream
    "boda_tconv": [_P] * 5 + [_I] * 14 + [_P],
    # x, w, wk, bias, out, n, H, W, C, oc, ky, kx, sy, sx, py, px, pky, pkx,
    # psy, psx, oy, ox, ty, tx, mma, vec, Kp, blocks, in_bf16, out_bf16, relu,
    # stream
    "boda_fused_stem": [_P] * 5 + [_I] * 26 + [_P],
    # H, W, C, oc, ky, kx, sy, sx, py, px, pky, pkx, psy, psx, oy, ox, ty, tx,
    # mma, vec, Kp, in_bf16, out_bf16 -> a block's shared memory under that
    # plan, and the blocks of it one SM holds
    "boda_fused_stem_smem": [_I] * 23,
    "boda_fused_stem_blocks_per_sm": [_I] * 23,
    # x, w1, b1, w2, b2, w3, b3, out, n, H, W, C, Cm, ty, cluster, mma,
    # tile_m, tile_n, vec, in_bf16, out_bf16, relu_out, stream
    "boda_resblock": [_P] * 8 + [_I] * 14 + [_P],
    # H, W, C, Cm, ty, cluster, mma, tile_m, tile_n, vec, in_bf16, out_bf16
    # -> clusters of that plan resident on the card at once
    "boda_resblock_max_clusters": [_I] * 12,
    # A, B, scale, C, M, N, K, stream
    "boda_sgemm_int8": [_P] * 4 + [_I] * 3 + [_P],
    # a, b, qa, qb, ws, M, K, N, stream
    "boda_quantize_int8": [_P] * 5 + [_I] * 3 + [_P],
    # () -> floats of boda_quantize_int8's workspace
    "boda_quantize_ws_floats": [],
    # xq, wq, s_act, sws, bias, out, ws, n, H, W, C, oc, ky, kx, sy, sx, py,
    # px, relu, out_kind, out_q, va, vb, full, splits, grid, stream
    "boda_qconv": [_P] * 7 + [_I] * 13 + [_F] + [_I] * 5 + [_P],
    # x, xq, ws, amax, A, B, Cc, in_bf16, s_static, scale_from, transpose,
    # per_chan, stream
    "boda_act_quantize": [_P] * 4 + [_LL] * 3 + [_I, _F, _I, _I, _I, _P],
    # x, ws, n, in_bf16, stream
    "boda_act_absmax": [_P, _P, _LL, _I, _P],
    # A, B, Cc, per_chan -> floats of boda_act_quantize's workspace
    "boda_act_quantize_ws_floats": [_LL] * 3 + [_I],
    # x, w, ws, n, H, W, C, oc, ky, kx, sy, sx, py, px, tile_n, va, vb,
    # full, splits, grid, nmem, outs, biases, meta, q (host arrays), stream
    "boda_bconv": [_P] * 3 + [_I] * 18 + [_P] * 5,
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libboda_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands side by side; return their output, or raise with
    the output of each one that failed once all have ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [f"{' '.join(c)} -> {p.returncode}\n{o}"
              for c, p, o in zip(cmds, procs, outs) if p.returncode != 0]
    if failed:
        raise RtErr("nvcc failed:\n" + "\n".join(failed))
    return "".join(outs)


def build_library() -> tuple[Path, float, str]:
    """Compile the kernels if this source hash has no library yet: one
    nvcc per source, all at once, then one link.

    Returns (library path, seconds spent compiling, compiler log). The
    library is written to a temporary name and renamed into place, so a
    concurrent process never loads a half-written file."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    srcs = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [str(Path(tmpdir) / f"{p.stem}.o") for p in srcs]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)]
                        for o, p in zip(objs, srcs)])
        tmp = str(Path(tmpdir) / lib.name)
        log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, lib)
    return lib, time.perf_counter() - t0, log


@functools.lru_cache(maxsize=1)
def load_kernels() -> ctypes.CDLL:
    """The kernel library of this checkout, built at first use and loaded
    once per process."""
    path, _secs, _log = build_library()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


# codes from this value up: a TMA tensor map that cuTensorMapEncodeTiled
# refused, its CUresult added (csrc/tma_pipe.cuh kEncodeError)
ENCODE_ERROR = 10000


def check_launch(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code (a refused launch never
    runs, and only cudaGetLastError reports it), or an entry point could
    not encode a TMA tensor map."""
    if rc >= ENCODE_ERROR:
        raise RtErr(f"{what}: TMA tensor map encode failed with CUresult "
                    f"{rc - ENCODE_ERROR}")
    if rc != 0:
        raise RtErr(f"{what}: kernel launch failed with cudaError {rc}")
