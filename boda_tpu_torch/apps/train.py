"""The trained-weights artifact reader: `load_weights_into_pipe`.

The port's copy of the reader half of boda_tpu/apps/train.py
(read_weights_artifact, load_weights_into_pipe): a `.boda` artifact is
{param blob name: array} in the pipe's op_params layout, stored bf16 or
f32. bf16 values widen to f32 exactly by a 16-bit shift, so no bfloat16
numpy type is needed. The training driver (cnet_train), the artifact
writer and the solver snapshots run on JAX and are left out.
"""

from __future__ import annotations

import numpy as np

from ..core.dims import NDA
from ..core.error import RtErr
from ..core.lexp import parse_lexp

WTS_MAGIC = b"boda_tpu_trained_weights_v1\n"


def _bf16_bits_to_f32(raw: np.ndarray) -> np.ndarray:
    return (raw.astype(np.uint32) << 16).view(np.float32)


def read_weights_artifact(path) -> dict:
    """-> {name: f32 array}. Raises RtErr on bad magic / truncation."""
    buf = open(path, "rb").read()
    if not buf.startswith(WTS_MAGIC):
        raise RtErr(f"'{path}' is not a boda_tpu trained-weights artifact")
    try:
        off = len(WTS_MAGIC)
        eol = buf.index(b"\n", off)
        hdr = parse_lexp(buf[off:eol].decode())
        hdr.deep_inc_use_cnt()
        n = int(hdr.get_kid("n").leaf_val)
        dtype = hdr.get_kid("dtype").leaf_val
        off = eol + 1
        out = {}
        for _ in range(n):
            ln = int.from_bytes(buf[off:off + 4], "little")
            off += 4
            name = buf[off:off + ln].decode()
            off += ln
            nd = buf[off]
            off += 1
            shape = []
            for _d in range(nd):
                shape.append(int.from_bytes(buf[off:off + 4], "little"))
                off += 4
            cnt = int(np.prod(shape)) if shape else 1
            if dtype == "bf16":
                v = _bf16_bits_to_f32(np.frombuffer(buf, np.uint16, cnt, off))
                off += 2 * cnt
            else:
                v = np.frombuffer(buf, np.float32, cnt, off).copy()
                off += 4 * cnt
            out[name] = v.reshape(shape)
        return out
    except RtErr:
        raise
    except Exception as e:
        raise RtErr(f"trained-weights artifact '{path}' is truncated or "
                    f"corrupt: {type(e).__name__}: {e}")


def load_weights_into_pipe(pipe, path) -> None:
    """Apply a trained-weights artifact onto pipe.op_params (validating
    the name/shape sets match the pipe's parameter blobs)."""
    w = read_weights_artifact(path)
    missing = sorted(set(pipe.op_params) - set(w))[:4]
    if missing:
        raise RtErr(f"weights artifact '{path}' missing params {missing}")
    for name, v in w.items():
        nda = pipe.op_params.get(name)
        if nda is None:
            raise RtErr(f"weights artifact '{path}' has param '{name}' "
                        f"unknown to this net")
        if tuple(nda.dims.shape) != v.shape:
            raise RtErr(f"weights artifact '{path}': param '{name}' shape "
                        f"{v.shape} != net's {tuple(nda.dims.shape)}")
        pipe.op_params[name] = NDA(nda.dims, v.astype(nda.dims.dtype))
