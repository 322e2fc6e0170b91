"""lexp: the framework's tiny uniform config language.

Capability parity with the reference's lexp (lexp.H:89, lexp.cc): one text
syntax `(k=v,k2=(a=1,b=2))` used everywhere — CLI args, test specs, op
signatures, wisdom files — with:

  * backslash escaping of the special chars `,()=\\` in leaf values,
  * use-count tracking so unconsumed fields become errors (lexp.H:74,101),
  * `%(var)` string interpolation against a name/value scope chain
    (str_format_from_nvm, lexp.H:104),
  * round-tripping: printing a parsed lexp re-escapes minimally.

The syntax itself is the compatibility surface (op-sig `.txt` files and
wisdom files are written in it), so this is a fresh implementation of the
same grammar, not a translation of lexp.cc.

The port's copy of boda_tpu/core/lexp.py, without the switch to the native
parser for long inputs: the port parses in Python.
"""

from __future__ import annotations

from typing import Iterator, Optional, Union

from .error import RtErr

_SPECIAL = set(",()=\\")


def lexp_escape(s: str) -> str:
    """Minimally escape a leaf value for embedding in lexp text."""
    out = []
    for c in s:
        if c in _SPECIAL:
            out.append("\\")
        out.append(c)
    return "".join(out)


class Lexp:
    """A lexp node: either a leaf (string value) or a list of (name, Lexp) kids.

    `use_cnt` is incremented whenever a client consumes this node; after
    config-initialization, nodes with use_cnt == 0 produce unused-argument
    errors (mirrors lexp_t::use_cnt, lexp.H:74).
    """

    __slots__ = ("leaf_val", "kids", "use_cnt", "src")

    def __init__(self, leaf_val: Optional[str] = None,
                 kids: Optional[list[tuple[str, "Lexp"]]] = None,
                 src: Optional[str] = None):
        if (leaf_val is not None) and (kids is not None):
            raise RtErr("internal: lexp node cannot be both leaf and list")
        self.leaf_val = leaf_val
        self.kids: list[tuple[str, Lexp]] = kids if kids is not None else ([] if leaf_val is None else None)
        self.use_cnt = 0
        self.src = src

    # -- construction helpers --
    @staticmethod
    def leaf(v: str) -> "Lexp":
        return Lexp(leaf_val=str(v))

    @staticmethod
    def empty_list() -> "Lexp":
        return Lexp(kids=[])

    @staticmethod
    def from_obj(o) -> "Lexp":
        """Build a lexp from nested python dicts/lists/scalars."""
        if isinstance(o, Lexp):
            return o
        if isinstance(o, dict):
            return Lexp(kids=[(str(k), Lexp.from_obj(v)) for k, v in o.items()])
        if isinstance(o, (list, tuple)):
            return Lexp(kids=[("_", Lexp.from_obj(v)) for v in o])
        if isinstance(o, bool):
            return Lexp.leaf("1" if o else "0")
        return Lexp.leaf(str(o))

    # -- predicates / access --
    @property
    def is_leaf(self) -> bool:
        return self.leaf_val is not None

    def get_kid(self, name: str) -> Optional["Lexp"]:
        for n, v in self.kids or ():
            if n == name:
                return v
        return None

    def add_key_val(self, k: str, v: str) -> None:
        assert not self.is_leaf
        self.kids.append((k, Lexp.leaf(v)))

    def add_key_lexp(self, k: str, v: "Lexp") -> None:
        assert not self.is_leaf
        self.kids.append((k, v))

    def iter_kids(self) -> Iterator[tuple[str, "Lexp"]]:
        return iter(self.kids or ())

    def deep_inc_use_cnt(self) -> None:
        self.use_cnt += 1
        if not self.is_leaf:
            for _, v in self.kids:
                v.deep_inc_use_cnt()

    # -- conversion --
    def to_obj(self) -> Union[str, dict, list]:
        """Lossy-ish convenience: leaf→str; list→dict (or list if all names '_')."""
        if self.is_leaf:
            return self.leaf_val
        if self.kids and all(n == "_" for n, _ in self.kids):
            return [v.to_obj() for _, v in self.kids]
        return {n: v.to_obj() for n, v in self.kids}

    def __str__(self) -> str:
        if self.is_leaf:
            return lexp_escape(self.leaf_val)
        parts = []
        for n, v in self.kids:
            if n == "_":
                parts.append(str(v))
            else:
                parts.append(f"{n}={v}")
        return "(" + ",".join(parts) + ")"

    def __repr__(self) -> str:
        return f"Lexp({self})"

    def check_unused(self, path: str = "") -> list[str]:
        """Return paths of nodes never consumed (use_cnt==0) under this node."""
        bad = []
        if self.use_cnt == 0:
            bad.append(path or "<root>")
            return bad  # parent unused implies kids unused; report once
        if not self.is_leaf:
            for n, v in self.kids:
                bad.extend(v.check_unused(f"{path}.{n}" if path else n))
        return bad


class _Parser:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def err(self, msg: str):
        raise RtErr(f"lexp parse error at char {self.i} of '{self.s}': {msg}")

    def peek(self) -> Optional[str]:
        return self.s[self.i] if self.i < len(self.s) else None

    def parse_value(self) -> Lexp:
        if self.peek() == "(":
            return self.parse_list()
        return self.parse_leaf()

    def parse_leaf(self, terminators: str = ",)") -> Lexp:
        out = []
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            if c == "\\":
                if self.i + 1 >= len(self.s):
                    self.err("unexpected end of input after escape char '\\' (expected char)")
                out.append(self.s[self.i + 1])
                self.i += 2
                continue
            if c == "%" and self.i + 1 < len(self.s) and self.s[self.i + 1] == "(":
                # %(var) interpolation refs pass through leaf values verbatim
                j = self.s.find(")", self.i + 2)
                if j == -1:
                    self.err("unterminated %(var reference in leaf value")
                out.append(self.s[self.i:j + 1])
                self.i = j + 1
                continue
            if c in terminators:
                break
            if c == "(":
                self.err("unexpected '(' inside leaf value (escape it as '\\(' if intended)")
            out.append(c)
            self.i += 1
        return Lexp(leaf_val="".join(out), src=self.s[start:self.i])

    def parse_name(self) -> str:
        out = []
        while self.i < len(self.s):
            c = self.s[self.i]
            if c == "=":
                return "".join(out)
            if c in ",()\\":
                break
            out.append(c)
            self.i += 1
        self.err("expected '=' after name in list element")

    def parse_list(self) -> Lexp:
        assert self.peek() == "("
        start = self.i
        self.i += 1
        kids: list[tuple[str, Lexp]] = []
        if self.peek() == ")":
            self.i += 1
            return Lexp(kids=kids, src=self.s[start:self.i])
        while True:
            if self.peek() is None:
                self.err("unexpected end of input inside list (expected ')')")
            if self.peek() == ")":  # trailing comma case
                self.i += 1
                break
            # element: name=value, or positional value
            save = self.i
            name = "_"
            # scan ahead for an unescaped '=' before any of ',()' → named
            j = self.i
            named = False
            while j < len(self.s):
                c = self.s[j]
                if c == "\\":
                    j += 2
                    continue
                if c == "=":
                    named = True
                    break
                if c in ",()":
                    break
                j += 1
            if named:
                name = self.parse_name()
                if name == "":
                    self.i = save
                    self.err("empty name in list element")
                assert self.peek() == "="
                self.i += 1
            val = self.parse_value()
            kids.append((name, val))
            c = self.peek()
            if c == ",":
                self.i += 1
            elif c == ")":
                self.i += 1
                break
            elif c is None:
                self.err("unexpected end of input inside list (expected ',' or ')')")
            else:
                self.err(f"expected ',' or ')' after list element, saw '{c}'")
        return Lexp(kids=kids, src=self.s[start:self.i])


def _parse_lexp_py(s: str) -> Lexp:
    p = _Parser(s)
    v = p.parse_value()
    if p.i != len(s):
        p.err(f"trailing characters after lexp: '{s[p.i:]}'")
    return v


def parse_lexp(s: str) -> Lexp:
    """Parse a lexp string. A leading '(' means list; otherwise whole-string leaf."""
    return _parse_lexp_py(s)


def parse_lexp_leaf_str(s: str) -> Lexp:
    """Treat the entire string as a raw (unescaped) leaf value."""
    return Lexp(leaf_val=s, src=s)


# -- %(var) interpolation (reference: str_format_from_nvm, lexp.H:104) --

class NameValScope:
    """Chain of name→Lexp scopes for %(var) interpolation and field lookup.

    Mirrors lexp_name_val_map_t (lexp.H:50): child scopes shadow parents;
    find() walks up the parent chain.
    """

    def __init__(self, l: Optional[Lexp] = None, parent: Optional["NameValScope"] = None):
        self.l = l
        self.parent = parent
        self.nvm: dict[str, Lexp] = {}
        if l is not None and not l.is_leaf:
            for n, v in l.iter_kids():
                self.nvm[n] = v  # last-wins like a map insert-overwrite

    def insert_leaf(self, n: str, v: str, inc_use_cnt: bool = True) -> None:
        lf = Lexp.leaf(v)
        if inc_use_cnt:
            lf.use_cnt += 1
        self.nvm[n] = lf

    def insert_leafs_from(self, kvs: dict) -> None:
        for k, v in kvs.items():
            self.insert_leaf(str(k), str(v))

    def find(self, n: str) -> Optional[Lexp]:
        s: Optional[NameValScope] = self
        while s is not None:
            if n in s.nvm:
                return s.nvm[n]
            s = s.parent
        return None


def str_format_from_nvm(fmt: str, nvm: NameValScope) -> str:
    """Expand %(var) references in fmt from the scope chain; %% → literal %."""
    out = []
    i = 0
    while i < len(fmt):
        c = fmt[i]
        if c != "%":
            out.append(c)
            i += 1
            continue
        if i + 1 < len(fmt) and fmt[i + 1] == "%":
            out.append("%")
            i += 2
            continue
        if i + 1 >= len(fmt) or fmt[i + 1] != "(":
            raise RtErr(f"bad %-escape in format string '{fmt}' at pos {i}: expected '%%' or '%(var)'")
        j = fmt.find(")", i + 2)
        if j == -1:
            raise RtErr(f"unterminated %(var reference in format string '{fmt}' at pos {i}")
        ref = fmt[i + 2:j]
        v = nvm.find(ref)
        if v is None:
            raise RtErr(f"couldn't find ref '{ref}' to expand in format string '{fmt}'")
        if not v.is_leaf:
            raise RtErr(f"ref '{ref}' in format string '{fmt}' is a list, expected leaf value")
        v.use_cnt += 1
        out.append(v.leaf_val)
        i = j + 1
    return "".join(out)


def str_format_find_all_refs(fmt: str) -> list[str]:
    refs = []
    i = 0
    while i < len(fmt):
        if fmt[i] == "%":
            if i + 1 < len(fmt) and fmt[i + 1] == "%":
                i += 2
                continue
            if i + 1 < len(fmt) and fmt[i + 1] == "(":
                j = fmt.find(")", i + 2)
                if j != -1:
                    refs.append(fmt[i + 2:j])
                    i = j + 1
                    continue
        i += 1
    return refs


def get_lexp_from_argv(argv: list[str]) -> tuple[Lexp, list[str]]:
    """Convert CLI argv (after mode name) into a list lexp + positional args.

    `--a-b=v` → key a_b with leaf value v (parsed as lexp if it starts with '(');
    `--flag` → flag=1; bare words are returned as positional args.
    Mirrors get_lexp_from_argv / add_argv_options_to_lexp (boda.cc:93-99).
    """
    l = Lexp.empty_list()
    pos: list[str] = []
    for a in argv:
        if a.startswith("--"):
            body = a[2:]
            if "=" in body:
                k, v = body.split("=", 1)
            else:
                k, v = body, "1"
            k = k.replace("-", "_")
            if v.startswith("("):
                l.add_key_lexp(k, parse_lexp(v))
            else:
                l.add_key_lexp(k, parse_lexp_leaf_str(v))
        else:
            pos.append(a)
    return l, pos
