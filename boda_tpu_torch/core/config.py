"""Config / reflection / mode-dispatch: the NESI-equivalent layer.

Capability parity with the reference's NESI system (nesi.cc, nesi_gen.py,
has_main.{H,cc}): declarative typed fields on config structs, initialized
uniformly from lexp trees (CLI args, XML-ish test specs, nested config), with

  * polymorphic instantiation by type-id field (`mode=`, `be=`, ... —
    reference tid_vn dispatch),
  * required/default/help metadata per field and hierarchical --help,
  * unused-argument errors via lexp use-counts (nesi_init_and_check_unused),
  * %(var) string interpolation against a scope chain (global config vars
    merge in as the outermost scope, like lib/boda_cfg.xml in has_main.cc:24),
  * scope-chained lookup so outer vars can satisfy inner fields.

No build-time codegen is needed (Python introspection replaces nesi_gen.py),
but the user-visible capabilities are the same.

The port's copy of boda_tpu/core/config.py.
"""

from __future__ import annotations

import typing
from typing import Any, Optional, Type, Union

from .dims import NDA, Dims
from .error import RtErr
from .lexp import Lexp, NameValScope, parse_lexp, str_format_from_nvm

_REQUIRED = object()
_NO_DEFAULT = object()


class Attr:
    """One declared config field: type, default/required, help text."""

    def __init__(self, ty, default: Any = _NO_DEFAULT, req: bool = False, help: str = ""):
        self.ty = ty
        self.default = default
        self.req = req
        self.help = help
        self.name: str = "?"

    def __repr__(self):
        return f"Attr({self.name}:{_ty_name(self.ty)})"


def _ty_name(ty) -> str:
    if hasattr(ty, "__name__"):
        return ty.__name__
    return str(ty)


class ConfigMeta(type):
    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        attrs: dict[str, Attr] = {}
        for b in reversed(cls.__mro__):
            for k, v in vars(b).items():
                if isinstance(v, Attr):
                    v.name = k
                    attrs[k] = v
        cls._attrs = attrs
        return cls


class Config(metaclass=ConfigMeta):
    """Base for all typed-config structs.

    Subclasses declare fields as class attributes of type Attr. Polymorphic
    bases set TID_KEY (the lexp key selecting the concrete type, e.g. 'mode'
    or 'be') and concrete types register with @register(base, 'type_id').
    """

    TID_KEY: Optional[str] = None  # set on polymorphic base classes
    TYPE_ID: Optional[str] = None  # set by @register on concrete classes
    HELP: str = ""

    _attrs: dict[str, Attr] = {}
    _registry: dict[type, dict[str, type]] = {}

    # ---- registry ----
    @classmethod
    def register(cls, base: type, type_id: str, help: str = ""):
        def deco(sub: type):
            sub.TYPE_ID = type_id
            if help:
                sub.HELP = help
            Config._registry.setdefault(base, {})[type_id] = sub
            return sub
        return deco

    @classmethod
    def registered(cls, base: type) -> dict[str, type]:
        return Config._registry.get(base, {})

    # ---- instantiation from lexp ----
    @classmethod
    def init_from_lexp(cls, l: Union[Lexp, str, None], parent: Optional[NameValScope] = None,
                       check_unused: bool = True) -> "Config":
        if isinstance(l, str):
            l = parse_lexp(l)
        if l is None:
            l = Lexp.empty_list()
        obj = _init_config(cls, l, parent)
        if check_unused:
            bad = l.check_unused()
            if bad:
                raise RtErr("unused config value(s): " + " ".join(sorted(bad)))
        return obj

    @classmethod
    def from_kwargs(cls, **kw) -> "Config":
        return cls.init_from_lexp(Lexp.from_obj(kw))

    # ---- help ----
    @classmethod
    def help_str(cls, depth: int = 0, seen: Optional[set] = None) -> str:
        seen = seen if seen is not None else set()
        pad = "  " * depth
        out = [f"{pad}{cls.__name__}" + (f" (type_id={cls.TYPE_ID})" if cls.TYPE_ID else "")
               + (f": {cls.HELP}" if cls.HELP else "")]
        if cls in seen:
            return out[0] + f"{pad}  ... (see above)\n"
        seen.add(cls)
        for name, a in cls._attrs.items():
            d = "" if a.default is _NO_DEFAULT else f" default={a.default!r}"
            r = " REQUIRED" if a.req else ""
            out.append(f"{pad}  --{name} <{_ty_name(a.ty)}>{r}{d}  {a.help}")
        subs = Config.registered(cls)
        if subs:
            out.append(f"{pad}  concrete types (select with {cls.TID_KEY}=):")
            for tid, sub in sorted(subs.items()):
                out.append(sub.help_str(depth + 2, seen).rstrip("\n"))
        return "\n".join(out) + "\n"

    def __repr__(self):
        kv = ",".join(f"{k}={getattr(self, k, None)!r}" for k in self._attrs)
        return f"{type(self).__name__}({kv})"


def register(base: type, type_id: str, help: str = ""):
    return Config.register(base, type_id, help)


def _resolve_concrete(cls: Type[Config], l: Lexp, scope: NameValScope) -> Type[Config]:
    """Resolve the concrete class for a possibly-polymorphic base."""
    subs = Config.registered(cls)
    if not subs:
        if cls.TID_KEY is not None and cls.TYPE_ID is None:
            raise RtErr(f"no concrete types registered for polymorphic base "
                        f"{cls.__name__} (selector '{cls.TID_KEY}='); missing import?")
        return cls
    tid_key = cls.TID_KEY or "type"
    tid_l = scope.find(tid_key)
    if tid_l is None:
        if cls.TYPE_ID is not None:
            return cls  # already concrete
        raise RtErr(f"missing required type-selector '{tid_key}=' for {cls.__name__}; "
                    f"valid values: {','.join(sorted(subs))}")
    tid_l.use_cnt += 1
    if not tid_l.is_leaf:
        raise RtErr(f"type-selector '{tid_key}' must be a leaf value")
    tid = tid_l.leaf_val
    sub = subs.get(tid)
    if sub is None:
        raise RtErr(f"unknown {tid_key} '{tid}' for {cls.__name__}; "
                    f"valid values: {','.join(sorted(subs))}")
    return sub


def _init_config(cls: Type[Config], l: Lexp, parent: Optional[NameValScope]) -> Config:
    if l.is_leaf:
        # leaf shorthand for polymorphic struct: 'be=xla' ≡ 'be=(be=xla)'
        tid_key = cls.TID_KEY or "type"
        ll = Lexp.empty_list()
        ll.add_key_val(tid_key, l.leaf_val)
        l.use_cnt += 1
        l = ll
        l.deep_inc_use_cnt()
        # note: fabricated nodes pre-marked used
        for _, v in l.iter_kids():
            v.use_cnt = 1
        l.use_cnt = 1
    l.use_cnt += 1
    scope = NameValScope(l, parent)
    concrete = _resolve_concrete(cls, l, scope)
    obj = concrete.__new__(concrete)
    obj._scope = scope
    for name, a in concrete._attrs.items():
        v = scope.find(name)
        if v is None:
            if a.req:
                raise RtErr(f"missing required value for '{name}' of {concrete.__name__}")
            dv = None if a.default in (_NO_DEFAULT, _REQUIRED) else a.default
            if isinstance(dv, str) and (a.ty is not str or "%(" in dv):
                # string default for a non-str field: parse like a lexp
                # value; str defaults with %(var) refs interpolate against
                # the scope chain (a literal '%(boda_test_dir)' path once
                # silently created a directory of that name)
                setattr(obj, name, _coerce(a.ty, parse_lexp(dv) if dv.startswith("(")
                                           else Lexp.leaf(dv), scope, name))
            else:
                setattr(obj, name, dv)
            continue
        v.use_cnt += 1
        setattr(obj, name, _coerce(a.ty, v, scope, name))
    if hasattr(obj, "base_setup"):
        obj.base_setup()
    return obj


def _needs_struct_default(ty) -> bool:
    return isinstance(ty, type) and issubclass(ty, (Config, Dims, NDA))


def _coerce(ty, l: Lexp, scope: NameValScope, name: str):
    origin = typing.get_origin(ty)
    if origin is Union:  # Optional[X]
        args = [a for a in typing.get_args(ty) if a is not type(None)]
        if len(args) != 1:
            raise RtErr(f"unsupported Union type for field '{name}'")
        return _coerce(args[0], l, scope, name)
    if origin in (list, tuple):
        (ety,) = typing.get_args(ty) or (str,)
        if l.is_leaf:
            # colon- or space-separated shorthand for scalar lists: '8 8'/'8:8'
            parts = l.leaf_val.replace(":", " ").split()
            out = [_coerce(ety, Lexp.leaf(p), scope, name) for p in parts]
        else:
            out = [_coerce(ety, v, scope, name) for _n, v in l.iter_kids()
                   if _mark(v)]
        return tuple(out) if origin is tuple else out
    if origin is dict:
        kty, vty = typing.get_args(ty) or (str, str)
        if l.is_leaf:
            raise RtErr(f"field '{name}' expects a map, got leaf '{l.leaf_val}'")
        return {n: _coerce(vty, v, scope, name) for n, v in l.iter_kids() if _mark(v)}
    if isinstance(ty, type) and issubclass(ty, Config):
        return _init_config(ty, l, scope)
    if ty is Dims:
        _deep(l)
        return Dims.from_lexp(l)
    if ty is NDA:
        _deep(l)
        return NDA.from_lexp(l)
    # scalar leaf types
    if not l.is_leaf:
        if ty is str:  # nested lexp as string value: round-trip to text
            _deep(l)
            l.use_cnt += 1
            return str(l)
        raise RtErr(f"field '{name}' expects a {_ty_name(ty)} leaf value, got a list")
    s = l.leaf_val
    if isinstance(s, str) and "%(" in s:
        s = str_format_from_nvm(s, scope)
    if ty is str:
        return s
    if ty is bool:
        if s in ("1", "true", "True"):
            return True
        if s in ("0", "false", "False"):
            return False
        raise RtErr(f"field '{name}': can't parse '{s}' as bool (expected 0/1)")
    if ty is int:
        try:
            return int(s, 0)
        except ValueError:
            raise RtErr(f"field '{name}': can't parse '{s}' as int")
    if ty is float:
        try:
            return float(s)
        except ValueError:
            raise RtErr(f"field '{name}': can't parse '{s}' as float")
    raise RtErr(f"field '{name}': unsupported config field type {_ty_name(ty)}")


def _mark(v: Lexp) -> bool:
    v.use_cnt += 1
    return True


def _deep(l: Lexp) -> None:
    l.deep_inc_use_cnt()
    l.use_cnt -= 1  # caller already counted the root
