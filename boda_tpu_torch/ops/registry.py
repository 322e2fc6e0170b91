"""The port's kernel-template registry: template name -> class.

Each port template subclasses its JAX template (boda_tpu/ops/pallas/*) and
overrides only build(), which returns a function on torch tensors. It
inherits args, check_args, ref_impl, flops and nhwc_ok, so the lowering
(boda_tpu/engine/lower.py, which reads JAX template metadata) and the
reduced signatures are the same in both packages. The JAX @template
registry is left alone; this one holds only the templates the port has.
"""

from __future__ import annotations

from boda_tpu.core.error import RtErr
from boda_tpu.ops.registry import KernelTemplate

_TEMPLATES: dict[str, type[KernelTemplate]] = {}


def template(cls: type[KernelTemplate]) -> type[KernelTemplate]:
    """Decorator: register a port template under its `name`."""
    if cls.name in _TEMPLATES:
        raise RtErr(f"duplicate port template '{cls.name}'")
    _TEMPLATES[cls.name] = cls
    return cls


def _load_templates() -> None:
    from .cuda import (conv, elementwise, pool, resblock,  # noqa: F401
                       sgemm, softmax, stem, tconv)


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
