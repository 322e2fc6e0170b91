"""Named-dimension ND-array machinery: the load-bearing type of the framework.

Capability parity with the reference's dims_t/nda_t (boda_base.H:498,751):
a `Dims` is an ordered list of named dimensions (+ optional explicit strides
and a type name), used simultaneously as

  * runtime tensor metadata (shape/layout of device + host buffers),
  * the kernel-template type signature (templates declare the named dims
    they consume; see ops/registry.py),
  * the autotuning / codegen cache key (totally ordered + hashable),

Text (lexp) serialization is compatible with the reference's op-sig /wisdom
syntax: `(tn=float,dims=(img=1,chan=64,y=56,x=56))`, scalars as
`(tn=uint32_t,v=16)`, metadata-only dims as `(tn=none,dims=(y=1,x=1))`.

The port's copy of boda_tpu/core/dims.py.
"""

from __future__ import annotations

import struct
from typing import Iterable, Optional, Sequence, Union

import numpy as np

from .error import RtErr
from .lexp import Lexp, parse_lexp

# type-name (tn) registry: reference C type names <-> numpy dtypes.
# 'none' = metadata-only dims (no storage), as in the reference wisdom files.
_TN_TO_DTYPE = {
    "float": np.float32,
    "double": np.float64,
    "half": np.float16,
    "bf16": None,  # filled below (ml_dtypes)
    "uint32_t": np.uint32,
    "int32_t": np.int32,
    "uint16_t": np.uint16,
    "int16_t": np.int16,
    "uint8_t": np.uint8,
    "int8_t": np.int8,
    "int64_t": np.int64,
    "uint64_t": np.uint64,
}
try:  # a numpy bfloat16 exists only where ml_dtypes is installed
    import ml_dtypes
    _TN_TO_DTYPE["bf16"] = ml_dtypes.bfloat16
except ImportError:  # pragma: no cover
    del _TN_TO_DTYPE["bf16"]

_DTYPE_TO_TN = {np.dtype(v): k for k, v in _TN_TO_DTYPE.items() if v is not None}


def tn_to_dtype(tn: str):
    if tn == "none":
        return None
    d = _TN_TO_DTYPE.get(tn)
    if d is None:
        raise RtErr(f"unknown type name '{tn}'")
    return np.dtype(d)


def dtype_to_tn(dt) -> str:
    tn = _DTYPE_TO_TN.get(np.dtype(dt))
    if tn is None:
        raise RtErr(f"no type name registered for dtype {dt}")
    return tn


class Dim:
    """One named dimension: (name, sz, stride). stride==0 → dense/derived."""

    __slots__ = ("name", "sz", "stride")

    def __init__(self, name: str, sz: int, stride: int = 0):
        self.name = name
        self.sz = int(sz)
        self.stride = int(stride)

    def __eq__(self, o):
        return (isinstance(o, Dim) and self.name == o.name
                and self.sz == o.sz and self.stride == o.stride)

    def __hash__(self):
        return hash((self.name, self.sz, self.stride))

    def __repr__(self):
        s = f"{self.name}={self.sz}"
        if self.stride:
            s += f":{self.stride}"
        return s


class Dims:
    """Ordered named dims + type name. Immutable once constructed; hashable.

    Construct from pairs: Dims([("img",8),("chan",64),("y",56),("x",56)], tn="float")
    or via the kwargs helper: Dims.make(tn="float", img=8, chan=64, y=56, x=56).
    """

    __slots__ = ("dims", "tn", "_strides")

    def __init__(self, dims: Iterable[Union[Dim, tuple]] = (), tn: str = "float"):
        dd = []
        for d in dims:
            if isinstance(d, Dim):
                dd.append(d)
            else:
                dd.append(Dim(*d))
        self.dims: tuple[Dim, ...] = tuple(dd)
        self.tn = tn
        self._strides: Optional[tuple[int, ...]] = None

    @staticmethod
    def make(tn: str = "float", **kw: int) -> "Dims":
        return Dims([(k, v) for k, v in kw.items()], tn=tn)

    # -- basic accessors --
    def names(self) -> tuple[str, ...]:
        return tuple(d.name for d in self.dims)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(d.sz for d in self.dims)

    @property
    def dtype(self):
        return tn_to_dtype(self.tn)

    def __len__(self):
        return len(self.dims)

    def __iter__(self):
        return iter(self.dims)

    def __contains__(self, name: str) -> bool:
        return any(d.name == name for d in self.dims)

    def __getitem__(self, key: Union[str, int]) -> int:
        """dims['chan'] or dims[1] → size of that dim."""
        if isinstance(key, int):
            return self.dims[key].sz
        for d in self.dims:
            if d.name == key:
                return d.sz
        raise RtErr(f"no dim named '{key}' in {self}")

    def get(self, name: str, default: Optional[int] = None) -> Optional[int]:
        for d in self.dims:
            if d.name == name:
                return d.sz
        return default

    def ix(self, name: str) -> int:
        """index (axis number) of named dim."""
        for i, d in enumerate(self.dims):
            if d.name == name:
                return i
        raise RtErr(f"no dim named '{name}' in {self}")

    def sz(self) -> int:
        n = 1
        for d in self.dims:
            n *= d.sz
        return n

    def bytes_sz(self) -> int:
        dt = self.dtype
        return self.sz() * (dt.itemsize if dt is not None else 0)

    def strides(self) -> tuple[int, ...]:
        """Element strides; explicit where set, dense row-major otherwise."""
        if self._strides is None:
            st = [0] * len(self.dims)
            acc = 1
            for i in range(len(self.dims) - 1, -1, -1):
                st[i] = self.dims[i].stride if self.dims[i].stride else acc
                acc = st[i] * self.dims[i].sz
            self._strides = tuple(st)
        return self._strides

    # -- functional updates (Dims is immutable) --
    def with_tn(self, tn: str) -> "Dims":
        return Dims(self.dims, tn=tn)

    def with_dim(self, name: str, sz: int) -> "Dims":
        """Return Dims with named dim resized (must exist)."""
        self.ix(name)
        return Dims([Dim(d.name, sz if d.name == name else d.sz, 0) for d in self.dims], tn=self.tn)

    def drop(self, *names: str) -> "Dims":
        return Dims([d for d in self.dims if d.name not in names], tn=self.tn)

    def prepend(self, name: str, sz: int) -> "Dims":
        return Dims([Dim(name, sz)] + list(self.dims), tn=self.tn)

    def append(self, name: str, sz: int) -> "Dims":
        return Dims(list(self.dims) + [Dim(name, sz)], tn=self.tn)

    def reorder(self, names: Sequence[str]) -> "Dims":
        if sorted(names) != sorted(self.names()):
            raise RtErr(f"reorder names {names} don't match dims {self.names()}")
        return Dims([Dim(n, self[n]) for n in names], tn=self.tn)

    # -- template matching (reference: dims_t::matches_template boda_base.H:524) --
    def matches_template(self, tmpl: "Dims") -> bool:
        """True if self has the same dim names in order as tmpl, where tmpl
        sizes of 0 are wildcards, and type names match (tmpl tn 'any' wild)."""
        if len(self.dims) != len(tmpl.dims):
            return False
        if tmpl.tn not in ("any", self.tn):
            return False
        for a, t in zip(self.dims, tmpl.dims):
            if a.name != t.name:
                return False
            if t.sz and a.sz != t.sz:
                return False
        return True

    # -- ordering / hashing: usable as cache key --
    def _key(self):
        return (self.tn, tuple((d.name, d.sz, d.stride) for d in self.dims))

    def __eq__(self, o):
        return isinstance(o, Dims) and self._key() == o._key()

    def __lt__(self, o):
        return self._key() < o._key()

    def __hash__(self):
        return hash(self._key())

    # -- lexp round-trip --
    def to_lexp(self) -> Lexp:
        l = Lexp.empty_list()
        if self.tn != "float":
            l.add_key_val("tn", self.tn)
        dl = Lexp.empty_list()
        for d in self.dims:
            dl.add_key_val(d.name, str(d.sz) if not d.stride else f"{d.sz}:{d.stride}")
        l.add_key_lexp("dims", dl)
        return l

    @staticmethod
    def from_lexp(l: Union[Lexp, str]) -> "Dims":
        if isinstance(l, str):
            l = parse_lexp(l)
        l.use_cnt += 1
        if l.is_leaf:
            raise RtErr(f"expected dims list lexp, got leaf '{l.leaf_val}'")
        tn = "float"
        dims: list[Dim] = []
        for n, v in l.iter_kids():
            v.use_cnt += 1
            if n == "tn":
                tn = v.leaf_val
            elif n == "dims":
                for dn, dv in v.iter_kids():
                    dv.use_cnt += 1
                    txt = dv.leaf_val
                    if ":" in txt:
                        sz, st = txt.split(":", 1)
                        dims.append(Dim(dn, int(sz), int(st)))
                    else:
                        dims.append(Dim(dn, int(txt)))
            elif n == "v":
                pass  # scalar value handled by NDA.from_lexp
            else:
                raise RtErr(f"unknown key '{n}' in dims lexp")
        return Dims(dims, tn=tn)

    def __str__(self):
        return str(self.to_lexp())

    def __repr__(self):
        body = ",".join(repr(d) for d in self.dims)
        return f"Dims({self.tn};{body})"

    def pretty(self) -> str:
        """Human/pipe-dump format: chan:64,y:56,x:56 style."""
        return ",".join(f"{d.name}:{d.sz}" for d in self.dims)


class NDA:
    """Dims + host buffer (numpy). Device arrays live in backends keyed by name.

    Mirrors nda_t (boda_base.H:751): typed, named-dim host tensor with binary
    serialization (bwrite/bread style) used by digest streams and the IPC
    wire protocol.
    """

    __slots__ = ("dims", "v")

    def __init__(self, dims: Dims, v: Optional[np.ndarray] = None):
        self.dims = dims
        if v is None:
            dt = dims.dtype
            if dt is None:
                self.v = None  # metadata-only (tn=none)
                return
            v = np.zeros(dims.shape, dtype=dt)
        else:
            v = np.asarray(v)
            if dims.dtype is not None and v.dtype != dims.dtype:
                v = v.astype(dims.dtype)
            if tuple(v.shape) != dims.shape:
                if v.size == dims.sz():
                    v = v.reshape(dims.shape)
                else:
                    raise RtErr(f"NDA value shape {v.shape} doesn't match dims {dims.shape}")
        self.v = v

    @staticmethod
    def scalar(val, tn: str = "uint32_t") -> "NDA":
        return NDA(Dims((), tn=tn), np.asarray(val, dtype=tn_to_dtype(tn)))

    @staticmethod
    def dims_only(dims: Dims) -> "NDA":
        """Metadata-only NDA (v=None) even for typed dims — op SIGNATURES
        declare shapes, they don't carry buffers (a b128 conv sig would
        otherwise pin ~200MB of zeros and make signature keys hash the
        buffer bytes)."""
        nda = NDA.__new__(NDA)
        nda.dims = dims
        nda.v = None
        return nda

    @staticmethod
    def from_array(v: np.ndarray, names: Sequence[str]) -> "NDA":
        v = np.asarray(v)
        if len(names) != v.ndim:
            raise RtErr(f"{len(names)} dim names for {v.ndim}-d array")
        dims = Dims(list(zip(names, v.shape)), tn=dtype_to_tn(v.dtype))
        return NDA(dims, v)

    @property
    def shape(self):
        return self.dims.shape

    def item(self):
        return self.v.item()

    # -- lexp round-trip: (tn=...,dims=(...)) or (tn=uint32_t,v=16) --
    def to_lexp(self, include_data: bool = False) -> Lexp:
        l = Lexp.empty_list()
        if self.dims.tn != "float":
            l.add_key_val("tn", self.dims.tn)
        if len(self.dims):
            dl = Lexp.empty_list()
            for d in self.dims.dims:
                dl.add_key_val(d.name, str(d.sz))
            l.add_key_lexp("dims", dl)
        if self.v is not None and (include_data or self.v.ndim == 0):
            if self.v.ndim == 0:
                l.add_key_val("v", _fmt_scalar(self.v.item()))
            else:
                vl = Lexp.empty_list()
                for x in self.v.reshape(-1):
                    vl.add_key_lexp("_", Lexp.leaf(_fmt_scalar(x.item())))
                l.add_key_lexp("v", vl)
        return l

    @staticmethod
    def from_lexp(l: Union[Lexp, str]) -> "NDA":
        if isinstance(l, str):
            l = parse_lexp(l)
        dims = Dims.from_lexp(l)
        vk = l.get_kid("v")
        if vk is None:
            return NDA(dims) if dims.dtype is not None else NDA(dims, None)
        vk.deep_inc_use_cnt()
        dt = dims.dtype
        if dt is None:
            raise RtErr("nda lexp has value 'v' but tn=none")
        if vk.is_leaf:
            return NDA(dims, np.asarray(_parse_scalar(vk.leaf_val, dt), dtype=dt))
        vals = np.asarray([_parse_scalar(v.leaf_val, dt) for _, v in vk.iter_kids()], dtype=dt)
        return NDA(dims, vals.reshape(dims.shape))

    def __str__(self):
        return str(self.to_lexp())

    # -- binary serialization (IPC wire + digest streams) --
    def bwrite(self) -> bytes:
        dims_txt = str(self.to_lexp()).encode()
        data = self.v.tobytes() if self.v is not None else b""
        return struct.pack("<II", len(dims_txt), len(data)) + dims_txt + data

    @staticmethod
    def bread(buf: bytes, off: int = 0) -> tuple["NDA", int]:
        ld, lv = struct.unpack_from("<II", buf, off)
        off += 8
        dims_txt = buf[off:off + ld].decode()
        off += ld
        nda = NDA.from_lexp(dims_txt)
        if lv:
            nda_v = np.frombuffer(buf[off:off + lv], dtype=nda.dims.dtype).reshape(nda.dims.shape).copy()
            nda = NDA(nda.dims, nda_v)
        off += lv
        return nda, off


def _fmt_scalar(x) -> str:
    if isinstance(x, float):
        return repr(x)
    return str(x)


def _parse_scalar(s: str, dt: np.dtype):
    if np.issubdtype(dt, np.floating):
        return float(s)
    return int(s)
