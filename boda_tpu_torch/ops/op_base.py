"""Op signatures: the record type keyed on by codegen, tuning, and wisdom.

Capability parity with the reference's op_base_t (op_base.H:9-41): an op is
`str_vals: {str: str}` + `nda_vals: {str: NDA}` (dims, scalar params, and
metadata-only entries), with

  * total ordering + hashing → usable as dedup/cache key,
  * lexp text round-trip — this IS the `.txt` op-sig file format and the
    per-op record in wisdom files,
  * well-known keys `type` and `func_name`.

Two text forms are accepted (both appear in reference data files):
  compact:  (type=sgemm,dims_vals=(a=(K=128,M=128),...))      [op-sig files]
  full:     (str_vals=(type=...),nda_vals=(a=(dims=(...)),...)) [wisdom]
We write the full form by default, compact when only type+dims are present.

The port's copy of boda_tpu/ops/op_base.py.
"""

from __future__ import annotations

from typing import Iterable, Optional, Union

from ..core.dims import NDA, Dims
from ..core.error import RtErr
from ..core.lexp import Lexp, parse_lexp


class OpBase:
    __slots__ = ("str_vals", "nda_vals")

    def __init__(self, str_vals: Optional[dict[str, str]] = None,
                 nda_vals: Optional[dict[str, NDA]] = None):
        self.str_vals: dict[str, str] = dict(str_vals or {})
        self.nda_vals: dict[str, NDA] = dict(nda_vals or {})

    # -- well-known accessors --
    @property
    def type(self) -> str:
        return self.str_vals.get("type", "")

    @property
    def func_name(self) -> str:
        return self.str_vals.get("func_name", self.type)

    def set_func_name(self, fn: str) -> None:
        self.str_vals["func_name"] = fn

    def has(self, k: str) -> bool:
        return k in self.nda_vals or k in self.str_vals

    def get_dims(self, k: str) -> Dims:
        v = self.nda_vals.get(k)
        if v is None:
            raise RtErr(f"op '{self.type}' missing dims for arg '{k}'")
        return v.dims

    def get_dims_or_none(self, k: str) -> Optional[Dims]:
        v = self.nda_vals.get(k)
        return v.dims if v is not None else None

    def set_dims(self, k: str, dims: Dims) -> None:
        self.nda_vals[k] = NDA.dims_only(dims)

    def set_null_dims(self, k: str, **dims: int) -> None:
        """Metadata-only entry (tn=none), e.g. in_pad/stride/kern_sz."""
        self.nda_vals[k] = NDA(Dims(list(dims.items()), tn="none"), None)

    def get_u32(self, k: str) -> int:
        v = self.nda_vals.get(k)
        if v is None or v.v is None:
            raise RtErr(f"op '{self.type}' missing scalar '{k}'")
        return int(v.item())

    def get_u32_or(self, k: str, default: int) -> int:
        v = self.nda_vals.get(k)
        return int(v.item()) if v is not None and v.v is not None else default

    def set_u32(self, k: str, val: int) -> None:
        self.nda_vals[k] = NDA.scalar(val, "uint32_t")

    def copy(self) -> "OpBase":
        return OpBase(dict(self.str_vals), dict(self.nda_vals))

    # -- ordering / hashing --
    def _key(self):
        # scalar/small values participate in identity (act_scale, max_val,
        # gen-data mode...); big buffers hash by crc32 — a signature never
        # legitimately keys on megabytes of tensor content, and repr()ing
        # raw bytes into cache keys measured 0.8GB/key on b128 conv sigs
        def vk(v):
            if v is None:
                return None
            b = v.tobytes()
            if len(b) <= 1024:
                return b
            import zlib
            return ("crc32", v.shape, str(v.dtype), zlib.crc32(b))
        return (tuple(sorted(self.str_vals.items())),
                tuple(sorted((k, v.dims, vk(v.v))
                             for k, v in self.nda_vals.items())))

    def __eq__(self, o):
        return isinstance(o, OpBase) and self._key() == o._key()

    def __lt__(self, o):
        return self._key() < o._key()

    def __hash__(self):
        return hash(self._key())

    # -- lexp round-trip --
    def to_lexp(self) -> Lexp:
        l = Lexp.empty_list()
        sv = Lexp.empty_list()
        for k in sorted(self.str_vals):
            sv.add_key_val(k, self.str_vals[k])
        l.add_key_lexp("str_vals", sv)
        nv = Lexp.empty_list()
        for k in sorted(self.nda_vals):
            nv.add_key_lexp(k, self.nda_vals[k].to_lexp())
        l.add_key_lexp("nda_vals", nv)
        return l

    def to_compact_lexp(self) -> Lexp:
        """(type=...,dims_vals=(...)) form used by op-sig list files."""
        l = Lexp.empty_list()
        for k in sorted(self.str_vals):
            l.add_key_val(k, self.str_vals[k])
        dv = Lexp.empty_list()
        for k in sorted(self.nda_vals):
            nda = self.nda_vals[k]
            if nda.v is not None and nda.v.ndim == 0:
                l.add_key_lexp(k, nda.to_lexp())  # scalar stays full-form
            else:
                dl = Lexp.empty_list()
                for d in nda.dims.dims:
                    dl.add_key_val(d.name, str(d.sz))
                dv.add_key_lexp(k, dl)
        if dv.kids:
            l.add_key_lexp("dims_vals", dv)
        return l

    def __str__(self):
        return str(self.to_lexp())

    def __repr__(self):
        return f"OpBase({self})"

    @staticmethod
    def from_lexp(l: Union[Lexp, str]) -> "OpBase":
        if isinstance(l, str):
            l = parse_lexp(l)
        l.use_cnt += 1
        op = OpBase()
        for n, v in l.iter_kids():
            v.use_cnt += 1
            if n == "str_vals":
                for k, sv in v.iter_kids():
                    sv.deep_inc_use_cnt()
                    op.str_vals[k] = sv.leaf_val
            elif n == "nda_vals":
                for k, nv in v.iter_kids():
                    nv.deep_inc_use_cnt()
                    nv.use_cnt -= 1
                    op.nda_vals[k] = NDA.from_lexp(nv)
            elif n == "dims_vals":
                # compact form: each kid is a bare dims list
                for k, dl in v.iter_kids():
                    dl.deep_inc_use_cnt()
                    dims = Dims([(dn, int(dv2.leaf_val)) for dn, dv2 in dl.iter_kids()])
                    op.nda_vals[k] = NDA(dims)
            elif v.is_leaf:
                op.str_vals[n] = v.leaf_val
            else:
                # compact-form nested: scalar nda (tn=...,v=...) or dims
                v.deep_inc_use_cnt()
                v.use_cnt -= 1
                op.nda_vals[n] = NDA.from_lexp(v)
        return op


def read_op_sigs(path) -> list[OpBase]:
    """Read an op-sig list file: one lexp per non-empty line."""
    ops = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ops.append(OpBase.from_lexp(line))
    return ops


def write_op_sigs(path, ops: Iterable[OpBase], compact: bool = True) -> None:
    with open(path, "w") as f:
        for op in ops:
            f.write(str(op.to_compact_lexp() if compact else op.to_lexp()) + "\n")
