"""2-D integer point/box primitives (reference: geom_prim.H u32_pt_t /
i32_box_t): elementwise ops, ceil/floor div, box algebra with half-open
pixel-coverage semantics. Points are (y, x) ordered, matching the named-dims
convention used across the framework (note: the reference stores (x, y) in
.d[0]/.d[1]; this build uses (y, x) uniformly and converts at the caffe pb
boundary).

The port's copy of boda_tpu/core/geom.py.
"""

from __future__ import annotations

from typing import Iterator


class Pt:
    """2-D integer point (y, x) with elementwise arithmetic."""

    __slots__ = ("y", "x")

    def __init__(self, y: int = 0, x: int = 0):
        self.y = int(y)
        self.x = int(x)

    @staticmethod
    def of(v) -> "Pt":
        if isinstance(v, Pt):
            return v
        if isinstance(v, (tuple, list)):
            return Pt(v[0], v[1])
        return Pt(v, v)

    def __add__(self, o):
        o = Pt.of(o)
        return Pt(self.y + o.y, self.x + o.x)

    def __sub__(self, o):
        o = Pt.of(o)
        return Pt(self.y - o.y, self.x - o.x)

    def __mul__(self, o):
        o = Pt.of(o)
        return Pt(self.y * o.y, self.x * o.x)

    def ceil_div(self, o) -> "Pt":
        o = Pt.of(o)
        return Pt(-(-self.y // o.y), -(-self.x // o.x))

    def floor_div(self, o) -> "Pt":
        o = Pt.of(o)
        return Pt(self.y // o.y, self.x // o.x)

    def rshift1_ceilish(self) -> "Pt":
        return Pt(self.y >> 1, self.x >> 1)

    def max_eq(self, o) -> "Pt":
        o = Pt.of(o)
        return Pt(max(self.y, o.y), max(self.x, o.x))

    def min_eq(self, o) -> "Pt":
        o = Pt.of(o)
        return Pt(min(self.y, o.y), min(self.x, o.x))

    def both_ge(self, o) -> bool:
        o = Pt.of(o)
        return self.y >= o.y and self.x >= o.x

    def both_gt(self, o) -> bool:
        o = Pt.of(o)
        return self.y > o.y and self.x > o.x

    def both_lt(self, o) -> bool:
        o = Pt.of(o)
        return self.y < o.y and self.x < o.x

    def both_nonzero(self) -> bool:
        return self.y != 0 and self.x != 0

    def is_zeros(self) -> bool:
        return self.y == 0 and self.x == 0

    def dims_max(self) -> int:
        return max(self.y, self.x)

    def __eq__(self, o):
        o = Pt.of(o)
        return self.y == o.y and self.x == o.x

    def __hash__(self):
        return hash((self.y, self.x))

    def __iter__(self) -> Iterator[int]:
        return iter((self.y, self.x))

    def __repr__(self):
        return f"({self.y},{self.x})"


class Box:
    """2-D box [p0, p1) in half-open pixel-coverage semantics (after
    conversion; some intermediate math uses closed boxes, as in the
    reference conv_common.cc)."""

    __slots__ = ("p0", "p1")

    def __init__(self, p0: Pt, p1: Pt):
        self.p0 = Pt.of(p0)
        self.p1 = Pt.of(p1)

    @staticmethod
    def from_yxhw(y: int, x: int, h: int, w: int) -> "Box":
        return Box(Pt(y, x), Pt(y + h, x + w))

    def sz(self) -> Pt:
        return self.p1 - self.p0

    def area(self) -> int:
        s = self.sz()
        return max(s.y, 0) * max(s.x, 0)

    def is_strictly_normalized(self) -> bool:
        return self.p1.both_gt(self.p0)

    def contains(self, o: "Box") -> bool:
        return o.p0.both_ge(self.p0) and self.p1.both_ge(o.p1)

    def clip_to(self, o: "Box") -> "Box":
        return Box(self.p0.max_eq(o.p0).min_eq(o.p1), self.p1.min_eq(o.p1).max_eq(o.p0))

    def __add__(self, o):
        if isinstance(o, Box):
            return Box(self.p0 + o.p0, self.p1 + o.p1)
        return Box(self.p0 + o, self.p1 + o)

    def __sub__(self, o):
        if isinstance(o, Box):
            return Box(self.p0 - o.p0, self.p1 - o.p1)
        return Box(self.p0 - o, self.p1 - o)

    def scale(self, o) -> "Box":
        return Box(self.p0 * o, self.p1 * o)

    def __eq__(self, o):
        return isinstance(o, Box) and self.p0 == o.p0 and self.p1 == o.p1

    def __repr__(self):
        return f"[{self.p0}:{self.p1}]"
