"""The port's kernel-template registry (template name -> class) and its
Codegen.

Each port template subclasses its JAX template (boda_tpu/ops/pallas/*) and
overrides only build(), which returns a function on torch tensors. It
inherits args, check_args, ref_impl, flops and nhwc_ok, so the lowering
(boda_tpu/engine/lower.py, which reads JAX template metadata) and the
reduced signatures are the same in both packages. The JAX @template
registry is left alone; this one holds only the templates the port has.

`Codegen` is the JAX package's Codegen (boda_tpu/ops/registry.py:178-274:
reduced-signature cache, batch compile, run by instance name) resolving
templates here instead: a backend of kind "ref" (be=interp) binds each
template's numpy ref_impl, any other backend its torch build(). The
reduced signatures, hence instance names and sig_key_str, are the JAX
package's, since check_args is inherited.
"""

from __future__ import annotations

import hashlib
from typing import Optional

from boda_tpu.backend.iface import CompiledFunc
from boda_tpu.core.error import RtErr
from boda_tpu.core.timers import timer
from boda_tpu.ops import registry as jregistry
from boda_tpu.ops.op_base import OpBase
from boda_tpu.ops.registry import KernelTemplate

_TEMPLATES: dict[str, type[KernelTemplate]] = {}


def template(cls: type[KernelTemplate]) -> type[KernelTemplate]:
    """Decorator: register a port template under its `name`."""
    if cls.name in _TEMPLATES:
        raise RtErr(f"duplicate port template '{cls.name}'")
    _TEMPLATES[cls.name] = cls
    return cls


def takes_device(fn):
    """Mark a built function that reads no tensor (gen_data): it takes the
    device to make its output on as the keyword `device`, which the backend
    compiling it binds to its own device."""
    fn.takes_device = True
    return fn


def _load_templates() -> None:
    from .cuda import (conv, elementwise, gen_data, pool,  # noqa: F401
                       qsgemm, resblock, sgemm, softmax, stem, tconv)


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


class Codegen(jregistry.Codegen):
    """Generate, cache, compile and run the port's template instances on a
    backend; compile_pend, run_func and gen_and_run are the JAX ones."""

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
        inst = f"{tname}__{hashlib.sha256(repr(key).encode()).hexdigest()[:12]}"
        with timer("gen_func"):
            if self.backend.kind == "ref":
                fn = jregistry._bind_ref(tmpl, rfs)
            else:
                fn = tmpl.build(rfs)
        cf = CompiledFunc(inst, fn, tmpl.in_args(), tmpl.out_args(),
                          tmpl.io_args(), flops=tmpl.flops(rfs))
        cf.sig_meta = (tname, rfs)
        cf.present_args = {a.name for a in tmpl.args if a.name in rfs.nda_vals}
        self.compile_pend_list.append(cf)
        self.sig_cache[key] = inst
        self.instances[inst] = (tmpl, rfs)
        return inst
