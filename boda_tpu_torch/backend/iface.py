"""Backend abstraction: the rtc_compute_t equivalent.

Capability parity with the reference's rtc_compute_t (rtc_compute.H:35): a
"runtime-compiled kernel device" with five required verbs —

  * named device vars with Dims (create_var_with_dims :48, reshaped views :49),
  * batch compile of generated functions (compile :55),
  * launch by name with an arg map of var-names or by-value NDAs (run :103-126),
  * sync (finish_and_sync :60),
  * per-call event timing (get_dur(b,e) :70),

plus host<->device copies (incl. whole-map variants :79-94) and a platform tag used as the wisdom/tuning-record key (get_plat_tag).

Concrete backends (selected polymorphically by `be=`, like the reference's
NESI factory): `torch` (one torch device — backend/torch_be.py), `interp`
(numpy reference — backend/interp.py) and `ipc` (a worker process running
one of those — backend/ipc.py).

The port's copy of boda_tpu/backend/iface.py, without the XLA backend
(be=xla) and its options (gen_src, the profiler hooks, and the _block_on
hook that waits for an asynchronous XLA result: be=interp runs
synchronously, and be=torch times with CUDA events).
"""

from __future__ import annotations

import time
from typing import Any, Optional, Union

from ..core.config import Config
from ..core.dims import NDA, Dims
from ..core.error import RtErr


class RtcFuncCall:
    """One kernel launch: function instance name + arg map.

    Arg values are device var names (str) or by-value NDAs (scalars/dynamic
    dims), mirroring rtc_arg_t (rtc_compute.H:103-126).
    """

    __slots__ = ("func_name", "args", "call_tag", "call_id")

    def __init__(self, func_name: str, args: dict[str, Union[str, NDA]],
                 call_tag: str = ""):
        self.func_name = func_name
        self.args = args
        self.call_tag = call_tag or func_name
        self.call_id: Optional[int] = None

    def __repr__(self):
        return f"RtcFuncCall({self.func_name},{self.args})"


class CompiledFunc:
    """A function instance held by a backend: callable + arg plan.

    `in_specs` ((name, Dims) for IN+INOUT args, call order) is attached by
    the codegen engine so backends can AOT-compile against fixed shapes.
    """

    __slots__ = ("name", "fn", "in_args", "out_args", "io_args", "flops",
                 "in_specs", "sig_meta", "present_args")

    def __init__(self, name: str, fn, in_args: list[str], out_args: list[str],
                 io_args: list[str], flops: int = 0):
        self.name = name
        self.fn = fn
        self.in_args = in_args    # read-only args, in call order
        self.out_args = out_args  # outputs returned by fn, in return order
        self.io_args = io_args    # read-write args (both passed and returned)
        self.flops = flops
        self.in_specs: list[tuple[str, Dims]] = []
        self.sig_meta = None  # (template name, reduced sig) for remote compile
        # arg names actually PRESENT in this instance's reduced sig —
        # declared-optional args absent from the sig are skipped by run()
        # (None: every declared arg required, the pre-opt behavior)
        self.present_args: Optional[set] = None


class _Var:
    __slots__ = ("dims", "v")

    def __init__(self, dims: Dims, v: Any):
        self.dims = dims
        self.v = v


class Backend(Config):
    """Polymorphic base: select with be=<type_id>."""

    TID_KEY = "be"
    kind = "torch"  # 'torch' = device build path; 'ref' = numpy reference path

    def base_setup(self):
        self._vars: dict[str, _Var] = {}
        self._views: dict[str, tuple[str, Dims]] = {}  # name → (src var, dims)
        self._funcs: dict[str, CompiledFunc] = {}
        self._events: list[tuple[float, float]] = []  # (begin, end) per call
        self._initialized = False

    # ---- lifecycle ----
    def init(self) -> None:
        self._initialized = True

    def ensure_init(self) -> None:
        if not self._initialized:
            self.init()

    def get_plat_tag(self) -> str:
        return "unknown"

    # ---- named variable store ----
    def create_var_with_dims(self, name: str, dims: Dims) -> None:
        if name in self._vars or name in self._views:
            raise RtErr(f"duplicate var '{name}'")
        self.ensure_init()
        self._vars[name] = _Var(dims, self._alloc(dims))

    def create_var_with_dims_as_reshaped_view_of_var(self, name: str, dims: Dims,
                                                     src: str) -> None:
        sd = self.get_var_dims(src)
        if dims.sz() != sd.sz():
            raise RtErr(f"view '{name}' size {dims.sz()} != src '{src}' size {sd.sz()}")
        if name in self._vars or name in self._views:
            raise RtErr(f"duplicate var '{name}'")
        base = self._views[src][0] if src in self._views else src
        self._views[name] = (base, dims)

    def _resolve(self, name: str) -> tuple[str, Optional[Dims]]:
        if name in self._views:
            base, vdims = self._views[name]
            if base not in self._vars:
                # the base was release_var'd out from under the view —
                # raise the backend's error, not a raw KeyError downstream
                raise RtErr(f"view '{name}' refers to released var '{base}'")
            return base, vdims
        if name not in self._vars:
            raise RtErr(f"no var '{name}'")
        return name, None

    def get_var_dims(self, name: str) -> Dims:
        src, vdims = self._resolve(name)
        return vdims if vdims is not None else self._vars[src].dims

    def var_exists(self, name: str) -> bool:
        return name in self._vars or name in self._views

    def release_var(self, name: str) -> None:
        if name in self._views:
            del self._views[name]
        elif name in self._vars:
            del self._vars[name]
        else:
            raise RtErr(f"no var '{name}'")

    def release_all_vars(self) -> None:
        self._vars.clear()
        self._views.clear()

    def var_names(self) -> list[str]:
        return list(self._vars) + list(self._views)

    # ---- copies ----
    def copy_nda_to_var(self, name: str, nda: NDA) -> None:
        src, _ = self._resolve(name)
        var = self._vars[src]
        if nda.dims.sz() != var.dims.sz():
            raise RtErr(f"copy to var '{name}': size mismatch "
                        f"{nda.dims.sz()} != {var.dims.sz()}")
        v = nda.v.reshape(var.dims.shape)
        if var.dims.dtype is not None and v.dtype != var.dims.dtype:
            v = v.astype(var.dims.dtype)
        var.v = self._to_device(v)

    def copy_var_to_nda(self, name: str) -> NDA:
        src, vdims = self._resolve(name)
        var = self._vars[src]
        host = self._to_host(var.v)
        dims = vdims if vdims is not None else var.dims
        return NDA(dims, host.reshape(dims.shape))

    def copy_ndas_to_vars(self, ndas: dict[str, NDA]) -> None:
        for k, v in ndas.items():
            self.copy_nda_to_var(k, v)

    def copy_vars_to_ndas(self, names: list[str]) -> dict[str, NDA]:
        return {n: self.copy_var_to_nda(n) for n in names}

    # ---- compile / run / timing ----
    def compile(self, funcs: list[CompiledFunc]) -> None:
        self.ensure_init()
        for f in funcs:
            self._compile_one(f)
            self._funcs[f.name] = f

    def _compile_one(self, f: CompiledFunc) -> None:
        pass

    def func_exists(self, name: str) -> bool:
        return name in self._funcs

    def run(self, call: RtcFuncCall) -> int:
        f = self._funcs.get(call.func_name)
        if f is None:
            raise RtErr(f"no compiled func '{call.func_name}'")
        pres = f.present_args
        in_vals = []
        for an in f.in_args + f.io_args:
            if pres is not None and an not in pres:
                continue  # optional arg not in this instance's sig
            av = call.args.get(an)
            if av is None:
                raise RtErr(f"call to '{call.func_name}' missing arg '{an}'")
            if isinstance(av, NDA):
                in_vals.append(self._to_device(av.v))
            else:
                src, vdims = self._resolve(av)
                x = self._vars[src].v
                if vdims is not None:
                    x = x.reshape(vdims.shape)
                in_vals.append(x)
        t0 = time.perf_counter()
        outs = f.fn(*in_vals)
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        t1 = time.perf_counter()
        out_names = [an for an in f.out_args + f.io_args
                     if pres is None or an in pres]
        if len(outs) != len(out_names):
            raise RtErr(f"func '{call.func_name}' returned {len(outs)} values, "
                        f"expected {len(out_names)}")
        for an, ov in zip(out_names, outs):
            av = call.args.get(an)
            if av is None:
                raise RtErr(f"call to '{call.func_name}' missing output arg '{an}'")
            if isinstance(av, NDA):
                raise RtErr(f"output arg '{an}' of '{call.func_name}' must be a var name")
            src, _ = self._resolve(av)
            var = self._vars[src]
            want_dt = var.dims.dtype
            # strict on device backends only: the interp/ref backend runs
            # ref_impls in float64 on purpose (higher-precision known-good
            # path; its goldens pin the f64 values)
            if want_dt is not None and self.kind != "ref" \
                    and getattr(ov, "dtype", None) is not None \
                    and ov.dtype != want_dt:
                raise RtErr(f"func '{call.func_name}' output '{an}': dtype "
                            f"{ov.dtype} != var '{av}' dtype {want_dt} — a "
                            f"template returned the wrong precision")
            var.v = ov.reshape(var.dims.shape)
        self._events.append((t0, t1))
        call.call_id = len(self._events) - 1
        return call.call_id

    def finish_and_sync(self) -> None:
        pass

    def get_dur(self, b: int, e: int) -> float:
        """Seconds from begin of call b to end of call e."""
        return self._events[e][1] - self._events[b][0]

    def var_device_value(self, name: str):
        """The var's backing device value (for timing harnesses that build
        chained-dispatch programs over stored args)."""
        src, vdims = self._resolve(name)
        x = self._vars[src].v
        if vdims is not None:
            x = x.reshape(vdims.shape)
        return x

    # ---- impl hooks ----
    def _alloc(self, dims: Dims) -> Any:
        raise NotImplementedError

    def _to_device(self, v) -> Any:
        raise NotImplementedError

    def _to_host(self, v):
        raise NotImplementedError


def make_backend(spec: Union[str, dict, None] = None) -> Backend:
    """Factory: make_backend('torch') or make_backend('(be=torch,device=cpu)')."""
    from . import interp, ipc, torch_be  # noqa: F401  (register backends)
    if spec is None:
        spec = "torch"
    if isinstance(spec, dict):
        from ..core.lexp import Lexp
        return Backend.init_from_lexp(Lexp.from_obj(spec))
    if not spec.startswith("("):
        spec = f"(be={spec})"
    return Backend.init_from_lexp(spec)
