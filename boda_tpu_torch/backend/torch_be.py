"""The port's Backend: `be=torch`, one torch device as a boda backend.

Port of boda_tpu/backend/xla.py on the contract of backend/iface.py (named
device vars and reshaped views, host<->device copies, compile, run by
instance name with var-name or by-value NDA args, sync, per-call timing).
`Attr(Backend)` fields and `rtcs=(t=(be=torch))` parse it. The per-op
modes run on it, and so does engine=torch's per-call mode (fuse=0), which
keeps every node of the plan in a var and runs each step as one call.

Vars are torch tensors on `device` (default cuda, through core/device's
get_device: asking for cuda without a card raises, nothing falls back to
the CPU). run() keeps the base contract (views, present_args, by-value NDA
args, the missing-arg errors) with two changes:

- every output must be a torch tensor on this backend's device in
  torch_dtype(var.dims.dtype); the base compares a numpy dtype with the
  output's dtype, which a torch dtype never equals;
- each call is timed by two CUDA events recorded on the current stream
  around it, so get_dur(b, e) is device time from the start of call b to
  the end of call e (read after finish_and_sync). The base times the host
  around a blocking wait, which on a card measures the launch, not the
  kernel. On the CPU, where torch runs synchronously, the host clock times
  the call.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..core.config import Attr, register
from ..core.device import get_device, plat_tag
from ..core.dims import NDA, Dims
from ..core.error import RtErr
from ..ops.cuda.util import torch_dtype
from .iface import Backend, CompiledFunc, RtcFuncCall


@register(Backend, "torch", help="PyTorch on one device (default cuda) "
                                 "with the port's templates")
class TorchBackend(Backend):
    kind = "torch"
    device = Attr(str, default="cuda", help="torch device: cuda[:i] or cpu")

    def init(self) -> None:
        self._device = get_device(self.device)
        self._initialized = True

    @property
    def dev(self) -> torch.device:
        self.ensure_init()
        return self._device

    def get_plat_tag(self) -> str:
        return plat_tag(self.dev)

    def device_kind(self) -> str:
        """The device's name, as the machine model (core/machine.py) keys
        its peaks: torch.cuda.get_device_name, or 'cpu'."""
        dev = self.dev
        return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    # ---- impl hooks ----
    def _alloc(self, dims: Dims) -> torch.Tensor:
        if dims.dtype is None:
            raise RtErr(f"can't allocate var with tn=none dims {dims}")
        return torch.zeros(dims.shape, dtype=torch_dtype(dims.dtype),
                           device=self.dev)

    def _to_device(self, v) -> torch.Tensor:
        return torch.tensor(np.asarray(v), device=self.dev)

    def _to_host(self, v: torch.Tensor) -> np.ndarray:
        return v.detach().cpu().numpy()

    def _compile_one(self, f: CompiledFunc) -> None:
        if getattr(f.fn, "takes_device", False):
            f.fn = functools.partial(f.fn, device=self.dev)

    # ---- run / timing ----
    def _inputs(self, f: CompiledFunc, call: RtcFuncCall) -> list:
        vals = []
        for an in f.in_args + f.io_args:
            if f.present_args is not None and an not in f.present_args:
                continue  # optional arg not in this instance's sig
            av = call.args.get(an)
            if av is None:
                raise RtErr(f"call to '{call.func_name}' missing arg '{an}'")
            vals.append(self._to_device(av.v) if isinstance(av, NDA)
                        else self.var_device_value(av))
        return vals

    def run(self, call: RtcFuncCall) -> int:
        f = self._funcs.get(call.func_name)
        if f is None:
            raise RtErr(f"no compiled func '{call.func_name}'")
        in_vals = self._inputs(f, call)
        dev = self.dev
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                outs = f.fn(*in_vals)
                t1.record()
        else:
            t0 = time.perf_counter()
            outs = f.fn(*in_vals)
            t1 = time.perf_counter()
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        out_names = [an for an in f.out_args + f.io_args
                     if f.present_args is None or an in f.present_args]
        if len(outs) != len(out_names):
            raise RtErr(f"func '{call.func_name}' returned {len(outs)} values, "
                        f"expected {len(out_names)}")
        for an, ov in zip(out_names, outs):
            av = call.args.get(an)
            if av is None:
                raise RtErr(f"call to '{call.func_name}' missing output arg "
                            f"'{an}'")
            if isinstance(av, NDA):
                raise RtErr(f"output arg '{an}' of '{call.func_name}' must be "
                            f"a var name")
            src, _ = self._resolve(av)
            var = self._vars[src]
            if not isinstance(ov, torch.Tensor) or ov.device != dev:
                where = ov.device if isinstance(ov, torch.Tensor) \
                    else type(ov).__name__
                raise RtErr(f"func '{call.func_name}' output '{an}' is on "
                            f"{where}, not on the backend's device {dev}")
            if var.dims.dtype is not None \
                    and ov.dtype != torch_dtype(var.dims.dtype):
                raise RtErr(f"func '{call.func_name}' output '{an}': dtype "
                            f"{ov.dtype} != var '{av}' dtype "
                            f"{torch_dtype(var.dims.dtype)} — a template "
                            f"returned the wrong precision")
            var.v = ov.reshape(var.dims.shape)
        self._events.append((t0, t1))
        call.call_id = len(self._events) - 1
        return call.call_id

    def finish_and_sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def get_dur(self, b: int, e: int) -> float:
        """Seconds from the start of call b to the end of call e."""
        t0, t1 = self._events[b][0], self._events[e][1]
        if isinstance(t0, float):
            return t1 - t0
        t1.synchronize()
        return t0.elapsed_time(t1) * 1e-3
