"""The port's kernel-template engine: the template registry (template
name -> class), the template base, and the Codegen.

The port's copy of boda_tpu/ops/registry.py (rtc_func_gen's role: typed
named-dim args, check_args reducing an op signature to what a template
uses, a reduced-signature instance cache, batch compile, run by instance
name). A template's build() returns a function on torch tensors
(ops/cuda/*); a backend of kind "ref" (be=interp) binds the template's
numpy ref_impl instead. The declared args, check_args, ref_impl and flops
are the JAX package's, so reduced signatures, instance names and wisdom
keys are the same in both packages. The registry holds only the templates
the port has.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Optional

from ..backend.iface import Backend, CompiledFunc, RtcFuncCall
from ..core.dims import NDA, Dims
from ..core.error import RtErr
from ..core.timers import timer
from .op_base import OpBase

IN, OUT, INOUT, REF = "IN", "OUT", "INOUT", "REF"


class ArgDecl:
    """One declared template argument: io kind + named-dims template.

    `tmpl` sizes of 0 are wildcards; tn 'any' matches any dtype. REF args
    contribute dims to the signature but are not runtime buffers (mirrors
    CUCL REF, e.g. out_ref for xpose kernels).
    """

    __slots__ = ("name", "kind", "tmpl", "opt")

    def __init__(self, name: str, kind: str, tmpl: Dims, opt: bool = False):
        assert kind in (IN, OUT, INOUT, REF)
        self.name = name
        self.kind = kind
        self.tmpl = tmpl
        self.opt = opt


def adecl(name: str, kind: str, dim_names: str, tn: str = "any", opt: bool = False) -> ArgDecl:
    """Shorthand: adecl('a', IN, 'M K') declares dims (M,K) any-size."""
    tmpl = Dims([(n, 0) for n in dim_names.split()], tn=tn)
    return ArgDecl(name, kind, tmpl, opt=opt)


class KernelTemplate:
    """Base class for kernel templates. Subclasses set `name`, `args`,
    optionally `sig_nda_keys` / `sig_str_keys`, and implement build()
    (torch path) and ref_impl() (numpy reference path)."""

    name: str = "?"
    args: list[ArgDecl] = []
    sig_nda_keys: list[str] = []   # extra nda_vals kept in reduced sig (scalars, work dims)
    sig_str_keys: list[str] = []   # extra str_vals kept in reduced sig
    # template consumes/produces NHWC-storage tensors when the fused-program
    # storage pass (engine/lower.py lower_pipe(fused_storage=1)) sets
    # io_layout=nhwc on its sig; templates that never saw the pass keep the
    # default and the pass disables itself for the whole plan
    nhwc_ok: bool = False

    # ---- signature reduction (reference: check_args rtc_func_gen.cc:126) ----
    @classmethod
    def check_args(cls, op: OpBase) -> OpBase:
        rfs = OpBase()
        rfs.str_vals["func_name"] = cls.name
        for a in cls.args:
            nda = op.nda_vals.get(a.name)
            if nda is None:
                if a.opt:
                    continue
                raise RtErr(f"template '{cls.name}': op missing required arg '{a.name}' "
                            f"(op sig: {op.to_compact_lexp()})")
            dims = nda.dims
            if dims.names() != a.tmpl.names():
                if sorted(dims.names()) == sorted(a.tmpl.names()):
                    dims = dims.reorder(a.tmpl.names())  # accept permuted sig-file order
                else:
                    raise RtErr(f"template '{cls.name}' arg '{a.name}': dims "
                                f"({','.join(dims.names())}) don't match declared "
                                f"({','.join(a.tmpl.names())})")
            if not dims.matches_template(a.tmpl):
                raise RtErr(f"template '{cls.name}' arg '{a.name}': dims {dims} "
                            f"don't match template {a.tmpl}")
            rfs.nda_vals[a.name] = NDA.dims_only(dims)
        for k in cls.sig_nda_keys:
            if k in op.nda_vals:
                rfs.nda_vals[k] = op.nda_vals[k]
        # io_layout/edge_prec are framework-level storage keys (set by the
        # fused-storage lowering pass) — always part of the reduced sig
        for k in cls.sig_str_keys + ["io_layout", "edge_prec"]:
            if k in op.str_vals:
                rfs.str_vals[k] = op.str_vals[k]
        return rfs

    # ---- build hooks ----
    @classmethod
    def build(cls, rfs: OpBase) -> Callable:
        """Return a fn on torch tensors taking IN+INOUT args (declared
        order) and returning OUT+INOUT args (declared order)."""
        raise NotImplementedError(f"template '{cls.name}' has no device build")

    @classmethod
    def ref_impl(cls, rfs: OpBase, *args):
        """Numpy reference with the same calling convention as build()."""
        raise NotImplementedError(f"template '{cls.name}' has no reference impl")

    @classmethod
    def flops(cls, rfs: OpBase) -> int:
        return 0

    # ---- call-plan helpers ----
    @classmethod
    def in_args(cls) -> list[str]:
        return [a.name for a in cls.args if a.kind == IN]

    @classmethod
    def out_args(cls) -> list[str]:
        return [a.name for a in cls.args if a.kind == OUT]

    @classmethod
    def io_args(cls) -> list[str]:
        return [a.name for a in cls.args if a.kind == INOUT]


_TEMPLATES: dict[str, type[KernelTemplate]] = {}


def template(cls: type[KernelTemplate]) -> type[KernelTemplate]:
    """Decorator: register a kernel template by its `name`."""
    if cls.name in _TEMPLATES:
        raise RtErr(f"duplicate kernel template '{cls.name}'")
    _TEMPLATES[cls.name] = cls
    return cls


def takes_device(fn):
    """Mark a built function that reads no tensor (gen_data): it takes the
    device to make its output on as the keyword `device`, which the backend
    compiling it binds to its own device."""
    fn.takes_device = True
    return fn


def _load_templates() -> None:
    from .cuda import (bck, bwai, conv, conv2, elementwise,  # noqa: F401
                       gen_data, lrn, pool, qsgemm, quantize, reduce,
                       resblock, sgemm, softmax, stem, tconv, var_stats,
                       xpose)


def all_templates() -> dict[str, type[KernelTemplate]]:
    _load_templates()
    return dict(_TEMPLATES)


def get_template(name: str) -> type[KernelTemplate]:
    _load_templates()
    t = _TEMPLATES.get(name)
    if t is None:
        raise RtErr(f"the torch port has no kernel template '{name}' "
                    f"(it has: {','.join(sorted(_TEMPLATES))})")
    return t


class Codegen:
    """Generate + cache + compile + run kernel instances against a backend.

    Mirrors rtc_codegen_t (rtc_func_gen.H:170): reduced-signature dedup map,
    deferred batch compile, run-by-instance-name, GC.
    """

    def __init__(self, backend: Backend):
        self.backend = backend
        self.sig_cache: dict[tuple, str] = {}    # reduced-sig key -> instance name
        self.instances: dict[str, tuple[type[KernelTemplate], OpBase]] = {}
        self.compile_pend_list: list[CompiledFunc] = []

    def gen_func(self, op: OpBase, func_name: Optional[str] = None) -> str:
        """Reduce op to its signature; return the (possibly cached)
        instance name."""
        tname = func_name or op.func_name
        tmpl = get_template(tname)
        rfs = tmpl.check_args(op)
        key = (tname, rfs._key())
        hit = self.sig_cache.get(key)
        if hit is not None:
            return hit
        # content-hash instance names: stable across Codegen objects sharing
        # one backend (a counter would collide with previously-compiled funcs)
        inst = f"{tname}__{hashlib.sha256(repr(key).encode()).hexdigest()[:12]}"
        with timer("gen_func"):
            fn = bind_template(tmpl, rfs, self.backend)
        cf = CompiledFunc(inst, fn, tmpl.in_args(), tmpl.out_args(),
                          tmpl.io_args(), flops=tmpl.flops(rfs))
        cf.sig_meta = (tname, rfs)
        cf.present_args = {a.name for a in tmpl.args if a.name in rfs.nda_vals}
        self.compile_pend_list.append(cf)
        self.sig_cache[key] = inst
        self.instances[inst] = (tmpl, rfs)
        return inst

    def compile_pend(self) -> None:
        if not self.compile_pend_list:
            return
        pend, self.compile_pend_list = self.compile_pend_list, []
        with timer("rtc_compile"):
            for i, cf in enumerate(pend):
                try:
                    self.backend.compile([cf])
                except Exception:
                    # purge the failed instance so it can't poison later
                    # compiles or be run_func'd; the caller sees the error
                    # attributed to this op (tune sweeps record it and
                    # continue — reference OOM-tagging behavior). The
                    # REMAINING pend entries stay queued: their sig_cache
                    # entries are alive, so dropping them would leave
                    # cached-but-never-compiled instances that every later
                    # run_func trips over ('unknown function')
                    self.sig_cache = {k: v for k, v in self.sig_cache.items()
                                      if v != cf.name}
                    self.instances.pop(cf.name, None)
                    self.compile_pend_list = pend[i + 1:] + self.compile_pend_list
                    raise

    def run_func(self, call: RtcFuncCall) -> int:
        if not self.backend.func_exists(call.func_name):
            self.compile_pend()
        with timer("run_func"):
            return self.backend.run(call)

    def gen_and_run(self, op: OpBase, args: dict, call_tag: str = "") -> int:
        inst = self.gen_func(op)
        return self.run_func(RtcFuncCall(inst, args, call_tag))

    def gc_clear(self) -> None:
        self.sig_cache.clear()
        self.instances.clear()
        self.compile_pend_list = []

    def sig_key_str(self, op: OpBase) -> str:
        tmpl = get_template(op.func_name)
        rfs = tmpl.check_args(op)
        h = hashlib.sha256(str(rfs).encode()).hexdigest()[:12]
        return f"{op.func_name}:{h}"


def bind_template(tmpl: type[KernelTemplate], rfs: OpBase, backend: Backend):
    """The function a backend runs for one instance: the template's numpy
    ref_impl on a backend of kind "ref" (be=interp), nothing on a remote
    one (be=ipc: its worker binds the template for its own backend), else
    the template's build (the torch function)."""
    if backend.kind == "ref":
        def fn(*args):
            return tmpl.ref_impl(rfs, *args)
        return fn
    if backend.kind == "remote":
        return None
    return tmpl.build(rfs)
