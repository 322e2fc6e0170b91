"""Generic protobuf text-format parser/printer (schema-less).

Role parity: the reference links protobuf and vendored caffe.proto to read
prototxt (caffepb.cc:329). This build parses the text format directly into
a schema-less tree (PbNode), so no generated proto code is needed; the
caffe-specific interpretation lives in caffe_io.py.

Grammar subset (covers caffe prototxt):
  message := (field)*
  field   := name ':' scalar | name '{' message '}' | name ':' '{' message '}'
  scalar  := number | 'true' | 'false' | ENUM_NAME | "string" | 'string'
Repeated fields accumulate in order. '#' comments are stripped.

The port's copy of boda_tpu/graph/pbtext.py.
"""

from __future__ import annotations

from typing import Iterator, Union

from ..core.error import RtErr

Scalar = Union[str, int, float, bool]


class PbNode:
    """Schema-less message node: field name → list of scalar-or-PbNode."""

    __slots__ = ("fields",)

    def __init__(self):
        self.fields: dict[str, list] = {}

    def add(self, name: str, v) -> None:
        self.fields.setdefault(name, []).append(v)

    def get(self, name: str, default=None):
        vs = self.fields.get(name)
        return vs[0] if vs else default

    def get_all(self, name: str) -> list:
        return self.fields.get(name, [])

    def has(self, name: str) -> bool:
        return name in self.fields

    def __repr__(self):
        return f"PbNode({list(self.fields)})"


def _tokenize(s: str) -> Iterator[str]:
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c in " \t\r\n,":
            i += 1
        elif c == "#":
            j = s.find("\n", i)
            i = n if j == -1 else j
        elif c in "{}:":
            yield c
            i += 1
        elif c in "\"'":
            j = i + 1
            out = []
            while j < n and s[j] != c:
                if s[j] == "\\" and j + 1 < n:
                    out.append(s[j + 1])
                    j += 2
                else:
                    out.append(s[j])
                    j += 1
            if j >= n:
                raise RtErr("prototxt: unterminated string literal")
            yield '"' + "".join(out)
            i = j + 1
        else:
            j = i
            while j < n and s[j] not in " \t\r\n,{}:#\"'":
                j += 1
            yield s[i:j]
            i = j


def _parse_scalar(tok: str) -> Scalar:
    if tok.startswith('"'):
        return tok[1:]
    if tok in ("true", "True"):
        return True
    if tok in ("false", "False"):
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok  # enum name


def parse_pbtext(s: str) -> PbNode:
    toks = list(_tokenize(s))
    pos = 0

    def parse_msg(depth: int) -> PbNode:
        nonlocal pos
        node = PbNode()
        while pos < len(toks):
            t = toks[pos]
            if t == "}":
                if depth == 0:
                    raise RtErr("prototxt: unmatched '}'")
                pos += 1
                return node
            if t in ("{", ":"):
                raise RtErr(f"prototxt: unexpected '{t}'")
            name = t
            pos += 1
            if pos >= len(toks):
                raise RtErr(f"prototxt: unexpected end after field name '{name}'")
            if toks[pos] == ":":
                pos += 1
                if pos < len(toks) and toks[pos] == "{":
                    pos += 1
                    node.add(name, parse_msg(depth + 1))
                else:
                    if pos >= len(toks):
                        raise RtErr(f"prototxt: missing value for field '{name}'")
                    node.add(name, _parse_scalar(toks[pos]))
                    pos += 1
            elif toks[pos] == "{":
                pos += 1
                node.add(name, parse_msg(depth + 1))
            else:
                raise RtErr(f"prototxt: expected ':' or '{{' after field '{name}'")
        if depth != 0:
            raise RtErr("prototxt: missing '}'")
        return node

    return parse_msg(0)


def print_pbtext(node: PbNode, indent: int = 0) -> str:
    pad = "  " * indent
    out = []
    for name, vals in node.fields.items():
        for v in vals:
            if isinstance(v, PbNode):
                out.append(f"{pad}{name} {{\n{print_pbtext(v, indent + 1)}{pad}}}\n")
            elif isinstance(v, bool):
                out.append(f"{pad}{name}: {'true' if v else 'false'}\n")
            elif isinstance(v, str) and not _is_enumish(v):
                out.append(f'{pad}{name}: "{v}"\n')
            else:
                out.append(f"{pad}{name}: {v}\n")
    return "".join(out)


def _is_enumish(s: str) -> bool:
    return s.isupper() and s.replace("_", "").isalnum() and not s[0].isdigit()
