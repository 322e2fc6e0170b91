"""Kernel B7 (ops/cuda/bconv.py), the bf16 form of the vendor conv, on the
CPU: its plan at the benchmark cells' shapes; the route rule of the vendor
conv templates (which steps take B7, which keep the vendor conv or take
B6); bconv_plain bit-equal to the vendor arithmetic the templates ran
before B7 (xla_conv, s2d_conv and xla_conv2: each member into its own
output with its own ReLU and bf16, f32 or int8-edge store); the wrapper's
refusals; the filter cache; the `route` of the forward's step spans; and
the kernel against its plain version where a card is present (skipped
here: B7 is CUDA C++ with no CPU form).

Tolerances: the plain version is held bit-equal (torch.equal) to the vendor
path, since both run the same FP32 conv on the same rounded operands; the
card case at the repo's bf16 gate, mrd 5e-3.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from boda_tpu_torch.core.dims import NDA
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.core.timers import global_timer_log
from boda_tpu_torch.engine.iface import make_engine
from boda_tpu_torch.models.zoo import build_model
from boda_tpu_torch.ops.cuda import bconv as B
from boda_tpu_torch.ops.cuda import conv as C
from boda_tpu_torch.ops.cuda.conv import conv_route, make_conv_op, \
    make_deconv_op, vendor_conv, vendor_store
from boda_tpu_torch.ops.cuda.util import copy_width
from boda_tpu_torch.ops.op_base import OpBase
from boda_tpu_torch.ops.registry import get_template

HEADLINE = "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,fuse_siblings=1)"
NHWC_BF16 = dict(prec="bf16", io_layout="nhwc", edge_prec="bf16")
H100_SMS = 132

# (n, H, C, oc, k, stride, pad) of the cells' B7 steps at b128: ResNet-50's
# and GoogLeNet's conv1, a res2 pair, res2-res5 3x3 and 1x1, the fc, an
# inception trio, a 5x5 at C = 24 and the fc of GoogLeNet
CELL_SHAPES = [
    (128, 224, 3, 64, 7, 2, 3),
    (128, 56, 64, 320, 1, 1, 0),
    (128, 56, 64, 64, 3, 1, 1),
    (128, 56, 256, 64, 1, 1, 0),
    (128, 56, 256, 640, 1, 2, 0),
    (128, 28, 128, 128, 3, 1, 1),
    (128, 14, 256, 256, 3, 1, 1),
    (128, 7, 512, 512, 3, 1, 1),
    (128, 7, 2048, 512, 1, 1, 0),
    (128, 1, 2048, 1000, 1, 1, 0),
    (128, 28, 192, 176, 1, 1, 0),
    (128, 14, 24, 64, 5, 1, 2),
    (128, 1, 1024, 1000, 1, 1, 0),
]


def _plan(n, H, C_, oc, k, s, p, sms=H100_SMS):
    return B.bconv_plan(n, H, H, C_, oc, k, k, (s, s), (p, p), sms)


@pytest.mark.parametrize("shape", CELL_SHAPES,
                         ids=[f"{s[4]}x{s[4]}s{s[5]}-{s[2]}-{s[3]}-{s[1]}"
                              for s in CELL_SHAPES])
def test_bconv_plan_at_the_cells_shapes(shape):
    n, H, C_, oc, k, s, p = shape
    plan = _plan(*shape)
    oy = (H + 2 * p - k) // s + 1
    M, K = n * oy * oy, k * k * C_
    # the N tile: 64 only where all of oc fits one, so no 128-wide tile is
    # three-quarters zeros and no wider N stages A twice as often
    assert plan.tile_n == (64 if oc <= 64 else 128)
    tiles_n = -(-oc // plan.tile_n)
    assert plan.blocks == -(-M // 128) * tiles_n
    assert plan.chunks == -(-K // 64)
    # whole tiles fill whole rows of tiles; the split units fit one wave
    assert plan.full % tiles_n == 0 and 0 <= plan.full <= plan.blocks
    units = plan.full + (plan.blocks - plan.full) * plan.splits
    assert plan.grid == min(units, H100_SMS)
    if plan.splits > 1:
        assert (plan.blocks - plan.full) * plan.splits <= H100_SMS
        assert plan.chunks // plan.splits >= 1
    # the copies: 16 bytes where C is a multiple of 8, element by element
    # at C = 3 (the wrapper widens it first: thin_pad)
    assert plan.copy == copy_width(2 * C_, 0, B.COPY_WIDTHS)
    assert plan.tma_a == (plan.copy == 16 and k == 1 and s == 1 and p == 0)
    assert plan.tma_b == (2 * K % 16 == 0)


def test_bconv_plan_splits_where_the_tiles_do_not_fill_the_card():
    # res5's 3x3 at b1: 1 row of 4 tiles over 72 chunks
    small = _plan(1, 7, 512, 512, 3, 1, 1)
    assert small.blocks == 4 and small.full == 0
    assert small.splits > 1 and small.grid == 4 * small.splits <= H100_SMS
    # res3's 3x3 at b128: 784 tiles run whole, in waves
    big = _plan(128, 28, 128, 128, 3, 1, 1)
    assert big.splits == 1 and big.full == big.blocks == 784
    assert big.grid == H100_SMS


@pytest.mark.parametrize("C_,extra,width", [(3, 1, 2), (4, 0, 8), (6, 2, 4),
                                            (8, 0, 16), (12, 0, 8),
                                            (24, 0, 16), (20, 0, 8),
                                            (17, 0, 2)])
def test_thin_pad_and_copy_width(C_, extra, width):
    assert B.thin_pad(C_) == extra
    assert copy_width(2 * C_, 0, B.COPY_WIDTHS) == width
    if extra:
        assert copy_width(2 * (C_ + extra), 0, B.COPY_WIDTHS) >= 8
    # an address that is not 16-byte aligned narrows the copy
    assert copy_width(16, 8, B.COPY_WIDTHS) == 8
    assert copy_width(16, 2, B.COPY_WIDTHS) == 2


# ------------------------------------------------------------- the routes

def _conv_op(func="xla_conv", prec="bf16", nhwc=True, **kw):
    op = make_conv_op(2, 8, 9, 9, 16, 3, 3, 2, 2, 1, 1, func_name=func,
                      relu=True)
    if prec:
        op.str_vals["prec"] = prec
    if nhwc:
        op.str_vals.update(io_layout="nhwc")
        if prec == "bf16":
            op.str_vals["edge_prec"] = "bf16"
    for k, v in kw.items():
        op.set_u32(k, v)
    return op


def _group_op(prec="bf16", nhwc=True, quant8=False):
    """An xla_conv2 sig of three members (a 1x1 trio at stride 1), as the
    sibling-fusion lowering writes it."""
    from boda_tpu_torch.core.dims import Dims
    op = OpBase({"type": "Convolution", "func_name": "xla_conv2"})
    op.set_dims("in", Dims.make(img=2, chan=24, y=7, x=5))
    for t, oc in zip("abc", (8, 12, 4)):
        op.set_dims(f"filts_{t}", Dims.make(out_chan=oc, in_chan=24, y=1,
                                            x=1))
        op.set_dims(f"biases_{t}", Dims.make(out_chan=oc))
        op.set_dims(f"out_{t}", Dims.make(img=2, chan=oc, y=7, x=5))
        op.set_u32(f"relu_{t}", int(t != "b"))
    op.set_null_dims("in_pad", y=0, x=0)
    op.set_null_dims("stride", y=1, x=1)
    op.set_null_dims("kern_sz", y=1, x=1)
    if prec:
        op.str_vals["prec"] = prec
    if nhwc:
        op.str_vals["io_layout"] = "nhwc"
        if prec == "bf16":
            op.str_vals["edge_prec"] = "bf16"
    if quant8:
        op.set_u32("quant8", 1)
    return op


def _grouped_op(prec="bf16", nhwc=True, groups=16, edge_prec=None):
    """A grouped xla_conv sig: 64 channels in `groups` groups, 3x3/s2."""
    op = make_conv_op(2, 64, 9, 9, 64, 3, 3, 2, 2, 1, 1, relu=True,
                      groups=groups)
    if prec:
        op.str_vals["prec"] = prec
    if nhwc:
        op.str_vals["io_layout"] = "nhwc"
        ep = edge_prec if edge_prec is not None else prec
        if ep:
            op.str_vals["edge_prec"] = ep
    return op


def _deconv_op():
    op = make_deconv_op(2, 8, 5, 5, 4, 4, 4, 2, 2, 1, 1)
    op.str_vals.update(NHWC_BF16)
    return op


ROUTES = {
    # xla_conv and s2d_conv
    "xla_conv-bf16-nhwc": (lambda: _conv_op("xla_conv"), "b7"),
    "s2d_conv-bf16-nhwc": (lambda: _conv_op("s2d_conv"), "b7"),
    "xla_conv-f32": (lambda: _conv_op("xla_conv", ""), "vendor"),
    "s2d_conv-f32": (lambda: _conv_op("s2d_conv", ""), "vendor"),
    "xla_conv-nchw": (lambda: _conv_op("xla_conv", nhwc=False), "vendor"),
    "s2d_conv-nchw": (lambda: _conv_op("s2d_conv", nhwc=False), "vendor"),
    "xla_conv-quant8": (lambda: _conv_op(quant8=1), "b6"),
    # xla_conv2: every member in one launch
    "xla_conv2-bf16-nhwc": (lambda: _group_op(), "b7"),
    "xla_conv2-f32": (lambda: _group_op(""), "vendor"),
    "xla_conv2-nchw": (lambda: _group_op(nhwc=False), "vendor"),
    "xla_conv2-quant8": (lambda: _group_op(quant8=True), "b6"),
    # a deconv keeps the vendor conv
    "deconv": (_deconv_op, "vendor"),
    # a grouped conv: B8 within its widths, else the vendor conv in groups
    "grouped-bf16-nhwc": (lambda: _grouped_op(), "b8"),
    "grouped-f32": (lambda: _grouped_op(prec=""), "vendor"),
    "grouped-nchw": (lambda: _grouped_op(nhwc=False), "vendor"),
    # f32 edges: B8 stores bf16
    "grouped-f32-edges": (lambda: _grouped_op(edge_prec="f32"), "vendor"),
    # groups of 2: no instance
    "grouped-cg2": (lambda: _grouped_op(groups=32), "vendor"),
    "grouped-ungrouped": (lambda: _grouped_op(groups=1), "b7"),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_route_of_the_conv_templates(case):
    make, route = ROUTES[case]
    op = make()
    t = get_template(op.func_name)
    rfs = t.check_args(op)
    assert conv_route(rfs) == route
    assert t.build(rfs).route == route


def _operands(op, rng):
    ind, fd = op.get_dims("in"), op.get_dims("filts")
    n, cin, h, w = ind.shape
    x = torch.from_numpy(rng.randn(n, h, w, cin).astype(np.float32))
    wt = torch.from_numpy(rng.randn(*fd.shape).astype(np.float32) * 0.3)
    b = torch.from_numpy(rng.randn(fd["out_chan"]).astype(np.float32))
    return x.bfloat16(), wt, b


def test_b7_route_under_autograd_runs_the_vendor_conv(monkeypatch):
    op = _conv_op()
    t = get_template("xla_conv")
    fn = t.build(t.check_args(op))
    x, w, b = _operands(op, np.random.RandomState(1))
    calls = []
    real = C.bconv

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(C, "bconv", spy)
    want = fn(x, w, b)
    assert calls == [1] and not want.requires_grad
    wg = w.clone().requires_grad_(True)
    got = fn(x, wg, b)
    assert calls == [1], "a recorded forward reached B7"
    assert got.requires_grad
    assert torch.equal(got, want)
    got.float().sum().backward()
    assert wg.grad is not None and wg.grad.shape == w.shape
    # the same forward without recording takes B7 again
    with torch.no_grad():
        fn(x, wg, b)
    assert calls == [1, 1]


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    seen = []
    real = B.bconv_plain

    def spy(*a, **k):
        seen.append(1)
        return real(*a, **k)
    monkeypatch.setattr(B, "bconv_plain", spy)
    op = _conv_op()
    t = get_template("xla_conv")
    x, w, b = _operands(op, np.random.RandomState(2))
    before = B.bconv.launches
    t.build(t.check_args(op))(x, w, b)
    assert seen == [1] and B.bconv.launches == before


# ------------------------------------------ the plain version, bit for bit

def _vendor(x, w, b, stride, pad, relu, odt, out_absmax=0.0):
    """The vendor path of a float step as the templates ran it before B7."""
    y = vendor_conv(stride, pad, torch.bfloat16, True)(x, w, b)
    return vendor_store(y, relu, odt, True, out_absmax)


@pytest.mark.parametrize("case", [
    # (n, cin, h, cout, k, s, p, relu, out dtype, out_absmax, bias)
    (2, 8, 9, 16, 3, 2, 1, True, torch.bfloat16, 0.0, True),
    (2, 3, 16, 8, 7, 2, 3, True, torch.bfloat16, 0.0, True),   # conv1
    (1, 24, 7, 12, 5, 1, 2, False, torch.float32, 0.0, True),
    (2, 16, 6, 8, 1, 1, 0, True, torch.int8, 2.5, True),       # int8 edge
    (2, 16, 6, 8, 1, 1, 0, False, torch.int8, 1.5, False),
    (2, 64, 6, 64, 1, 1, 0, False, torch.bfloat16, 0.0, False),
], ids=["3x3s2", "conv1-c3", "5x5-f32", "int8-relu", "int8-nobias",
        "1x1-nobias"])
def test_plain_is_the_vendor_arithmetic(case):
    n, cin, h, cout, k, s, p, relu, odt, amax, has_b = case
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(n, h, h, cin).astype(np.float32)) \
        .bfloat16()
    w = torch.from_numpy(rng.randn(cout, cin, k, k).astype(np.float32) * 0.3)
    b = torch.from_numpy(rng.randn(cout).astype(np.float32)) if has_b \
        else None
    want = _vendor(x, w, b, (s, s), (p, p), relu, odt, amax)
    (got,) = B.bconv_plain(x, B.ohwi_bf16(w), (b,),
                           (B.Member(cout, relu, odt, amax),), (s, s), (p, p))
    assert got.dtype == want.dtype and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("func", ["xla_conv", "s2d_conv"])
def test_template_on_the_b7_route_equals_the_vendor_path(func):
    op = make_conv_op(2, 6, 12, 12, 8, 3, 3, 2, 2, 1, 1, func_name=func,
                      relu=True)
    op.str_vals.update(NHWC_BF16)
    x, w, b = _operands(op, np.random.RandomState(4))
    t = get_template(func)
    got = t.build(t.check_args(op))(x, w, b)
    assert torch.equal(got, _vendor(x, w, b, (2, 2), (1, 1), True,
                                    torch.bfloat16))


def test_xla_conv2_members_into_their_own_outputs():
    # a 1x1 embedded in its 3x3 partner, one member without a bias, one
    # without a ReLU: B7's one conv over the concatenated, center-embedded
    # filters against the vendor path's per-member slices of one conv
    from boda_tpu_torch.core.dims import Dims
    op = OpBase({"type": "Convolution", "func_name": "xla_conv2"})
    op.set_dims("in", Dims.make(img=2, chan=16, y=8, x=8))
    specs = {"a": (8, 1, True, True), "b": (12, 3, False, True),
             "c": (4, 3, True, False)}
    for t, (oc, k, relu, bias) in specs.items():
        op.set_dims(f"filts_{t}", Dims.make(out_chan=oc, in_chan=16, y=k,
                                            x=k))
        if bias:
            op.set_dims(f"biases_{t}", Dims.make(out_chan=oc))
        op.set_dims(f"out_{t}", Dims.make(img=2, chan=oc, y=8, x=8))
        op.set_u32(f"relu_{t}", int(relu))
    op.set_null_dims("in_pad", y=1, x=1)
    op.set_null_dims("stride", y=1, x=1)
    op.set_null_dims("kern_sz", y=3, x=3)
    op.str_vals.update(NHWC_BF16)
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 8, 8, 16).astype(np.float32)) \
        .bfloat16()
    args, ws, bs = [x], [], []
    for t, (oc, k, relu, bias) in specs.items():
        w = torch.from_numpy(rng.randn(oc, 16, k, k).astype(np.float32)
                             * 0.2)
        args.append(w)
        ws.append(F.pad(w, (1, 1, 1, 1)) if k == 1 else w)
        b = torch.from_numpy(rng.randn(oc).astype(np.float32))
        if bias:
            args.append(b)
        bs.append(b if bias else torch.zeros(oc))
    tmpl = get_template("xla_conv2")
    fn = tmpl.build(tmpl.check_args(op))
    assert fn.route == "b7"
    got = fn(*args)
    y = vendor_conv((1, 1), (1, 1), torch.bfloat16, True)(
        x, torch.cat(ws), torch.cat(bs))
    off = 0
    for g, (oc, k, relu, bias) in zip(got, specs.values()):
        want = vendor_store(y[:, off:off + oc], relu, torch.bfloat16, True)
        assert g.shape == (2, 8, 8, oc) and g.is_contiguous()
        assert torch.equal(g, want)
        off += oc


# ----------------------------------------------------------- the refusals

def _ok():
    x = torch.zeros(2, 5, 5, 8, dtype=torch.bfloat16)
    w = torch.zeros(16, 3, 3, 8, dtype=torch.bfloat16)
    return dict(x=x, w=w, biases=(torch.zeros(16),),
                members=(B.Member(16, True),), stride=(1, 1), pad=(1, 1))


REFUSALS = {
    "f32 x": dict(x=torch.zeros(2, 5, 5, 8)),
    "3-d x": dict(x=torch.zeros(5, 5, 8, dtype=torch.bfloat16)),
    "strided x": dict(x=torch.zeros(2, 5, 5, 16, dtype=torch.bfloat16)
                      [..., ::2]),
    "f32 w": dict(w=torch.zeros(16, 3, 3, 8)),
    "channels apart": dict(w=torch.zeros(16, 3, 3, 4, dtype=torch.bfloat16)),
    "members short": dict(members=(B.Member(8),)),
    "five members": dict(members=(B.Member(4),) * 4 + (B.Member(0),),
                         biases=(None,) * 5),
    "biases short": dict(biases=()),
    "bias length": dict(biases=(torch.zeros(15),)),
    "bf16 bias": dict(biases=(torch.zeros(16, dtype=torch.bfloat16),)),
    "f16 out": dict(members=(B.Member(16, dtype=torch.float16),)),
    "int8 without absmax": dict(members=(B.Member(16, dtype=torch.int8),)),
    "stride 0": dict(stride=(0, 1)),
    "negative pad": dict(pad=(-1, 0)),
    "empty output": dict(pad=(0, 0), x=torch.zeros(2, 2, 2, 8,
                                                   dtype=torch.bfloat16)),
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_bconv_refuses(what):
    kw = {**_ok(), **REFUSALS[what]}
    with pytest.raises(RtErr, match="bconv"):
        B.bconv(**kw)
    with pytest.raises(RtErr, match="bconv"):
        B.bconv_plain(**kw)


def test_bconv_takes_the_checked_operands():
    (out,) = B.bconv(**_ok())
    assert out.shape == (2, 5, 5, 16) and out.dtype == torch.bfloat16


# -------------------------------------------------------- the filter cache

def test_filter_cache_makes_a_filter_once_per_weights():
    made = []

    def make(*ws):
        made.append(1)
        return B.ohwi_bf16(torch.cat(ws))
    cache = B.FilterCache(make)
    w1, w2 = torch.randn(4, 3, 1, 1), torch.randn(2, 3, 1, 1)
    a = cache(w1, w2)
    assert cache(w1, w2) is a and made == [1]
    w1.mul_(2)   # an in-place update bumps the version: made again
    b = cache(w1, w2)
    assert made == [1, 1] and torch.equal(b[:4], B.ohwi_bf16(w1))
    cache(w1.clone(), w2)   # another tensor: made again
    assert made == [1, 1, 1]
    with torch.inference_mode():
        wi = torch.randn(4, 3, 1, 1)
    cache(wi, w2)
    cache(wi, w2)   # no version counter: made at every call
    assert len(made) == 5


def test_b6_filter_is_made_once_per_weights(monkeypatch):
    # an int8 xla_conv step whose weights arrive float: B6's filter (the
    # weight quantize and its OHWI reorder) is made once per set of
    # weights, again after an in-place update, and gives what a new step
    # gives
    op = _conv_op(quant8=1)
    t = get_template("xla_conv")
    fn = t.build(t.check_args(op))
    x, w, b = _operands(op, np.random.RandomState(6))
    x = x.float()
    calls = []
    real = C.quantize_filter

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(C, "quantize_filter", spy)
    first = fn(x, w, b)
    assert torch.equal(fn(x, w, b), first) and calls == [1]
    w.mul_(0.5)
    got = fn(x, w, b)
    assert calls == [1, 1]
    assert torch.equal(got, t.build(t.check_args(op))(x, w, b))


# ---------------------------------------------------- the forward's routes

def _profiled_engine(tune):
    pipe = build_model("mini", batch=2)
    eng = make_engine(f"(engine=torch,device=cpu,op_tune={tune})")
    eng.init(pipe)
    d = pipe.get_data_img_dims()
    x = NDA(d, np.random.RandomState(0).randn(*d.shape).astype(np.float32))
    global_timer_log.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        eng.run_fwd({pipe.data_img_node_names[0]: x}, ["prob"])
    steps = [s for s in global_timer_log.spans if s[0] == "fwd.step"]
    global_timer_log.clear()
    return eng, steps


@pytest.mark.parametrize("tune,route", [
    (HEADLINE, "b7"), ("(use_culibs=1,fuse_siblings=1,s2d=0)", "vendor")])
def test_step_spans_carry_the_conv_route(tune, route):
    eng, steps = _profiled_engine(tune)
    convs = [s for s in steps if s[5]["func_name"] in ("xla_conv",
                                                       "xla_conv2")]
    assert convs and all(s[5]["route"] == route for s in convs)
    assert all("route" not in s[5] for s in steps if s not in convs)
    assert eng.fwd.conv_routes == {
        s[5]["call_tag"]: route for s in convs}


# ----------------------------------------------------------- on the card

def test_b7_against_its_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("B7 is CUDA C++ with no CPU form: needs a card "
                    "(chip_smoke.py --phases env,build,vendor holds it at "
                    "the cells' shapes)")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2, 14, 14, 64, device=dev, generator=g).bfloat16()
    w = (torch.randn(80, 3, 3, 64, device=dev, generator=g) / 24).bfloat16()
    bs = (torch.randn(16, device=dev, generator=g), None)
    mems = (B.Member(16, True), B.Member(64, False, torch.float32))
    got = B.bconv(x, w, bs, mems, (1, 1), (1, 1))
    want = B.bconv_plain(x, w, bs, mems, (1, 1), (1, 1))
    for a, b in zip(got, want):
        d = (a.double() - b.double()).abs().max()
        assert float(d / b.double().abs().max()) <= 5e-3
