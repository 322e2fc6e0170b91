"""Grouped convolutions in the port, on the CPU: kernel B8's plain version
(ops/cuda/gconv.py) against per-group convs of channel slices, its plan and
its refusals; a grouped conv step on B8 bit-equal to the vendor conv in
groups (tests/test_torch_bconv.py holds its route); the IR's and the
importer's groups; the lowering (no sibling fusion, fused stem or resblock
takes a grouped conv, quant8 at a grouped site raises); engine=ref against the port on a small grouped net; the step spans'
route and groups; and the kernel against its plain version where a card is
present (skipped here: B8 is CUDA C++ with no CPU form).

Tolerances: B8's plain version stores one bf16 rounding of f32 sums of bf16
products, each within half a bf16 step (2^-8 of the value) of the f32 sums
of the per-group convs, plus 1e-5 for their other order; the plain version
is held bit-equal to the vendor path, which runs the same FP32 conv on the
same rounded operands; f32 engines against the float64 engine=ref at 1e-4,
the repo's f32 gate for sums of a few hundred products.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from boda_tpu_torch.core.dims import NDA, Dims
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.core.timers import global_timer_log
from boda_tpu_torch.engine.iface import make_engine
from boda_tpu_torch.engine.lower import lower_pipe
from boda_tpu_torch.graph import caffe_io
from boda_tpu_torch.graph.pbtext import parse_pbtext
from boda_tpu_torch.models.zoo import NetBuilder
from boda_tpu_torch.ops.cnn_variants import make_op_tune
from boda_tpu_torch.ops.cuda import conv as C
from boda_tpu_torch.ops.cuda import gconv as G
from boda_tpu_torch.ops.cuda.conv import conv_flops, make_conv_op, \
    vendor_conv, vendor_store
from boda_tpu_torch.ops.registry import get_template
from boda_tpu_torch.tune import wisdom

HEADLINE = "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,fuse_siblings=1)"
NHWC_BF16 = dict(prec="bf16", io_layout="nhwc", edge_prec="bf16")


def _operands(n, H, C_, cg, seed=0, bias=True):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, H, H, C_, generator=g).bfloat16()
    w = (torch.randn(C_, 3, 3, cg, generator=g) * (9 * cg) ** -0.5) \
        .bfloat16()
    b = torch.randn(C_, generator=g) if bias else None
    return x, w, b


def _per_group(x, w, b, groups, stride, relu):
    """f32 convs of each group's channel slices, concatenated, NHWC."""
    xc = x.permute(0, 3, 1, 2).float()
    wc = w.permute(0, 3, 1, 2).float()
    ci, co = xc.shape[1] // groups, wc.shape[0] // groups
    y = torch.cat([F.conv2d(xc[:, j * ci:(j + 1) * ci],
                            wc[j * co:(j + 1) * co],
                            None if b is None else b[j * co:(j + 1) * co],
                            stride, 1) for j in range(groups)], dim=1)
    return (torch.relu(y) if relu else y).permute(0, 2, 3, 1)


# ------------------------------------------------------- B8's plain version

@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cg", [4, 8, 16, 32])
def test_plain_is_the_per_group_convs(cg, stride):
    """64 groups of cg channels (ResNeXt-101 (64x4d)'s res2-res5 widths),
    bias and ReLU: each stored value one bf16 rounding of its f32 sum."""
    x, w, b = _operands(2, 9, 64 * cg, cg, seed=cg + stride)
    got = G.gconv(x, w, b, 64, (stride, stride), (1, 1), relu=True)
    want = _per_group(x, w, b, 64, (stride, stride), True)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert got.shape == want.shape
    assert bool(((got.float() - want).abs()
                 <= 2 ** -8 * want.abs() + 1e-5).all())
    assert G.gconv.launches == 0  # CPU tensors: the plain version


def test_plain_without_bias_or_relu():
    x, w, _ = _operands(1, 7, 128, 8, seed=3, bias=False)
    got = G.gconv(x, w, None, 16, (1, 1), (1, 1))
    want = _per_group(x, w, None, 16, (1, 1), False)
    assert bool(((got.float() - want).abs()
                 <= 2 ** -8 * want.abs() + 1e-5).all())
    assert bool((got < 0).any())


@pytest.mark.parametrize("cin,cout,groups,taps,fits", [
    (256, 256, 64, 9, True), (512, 512, 64, 9, True),
    (2048, 2048, 64, 9, True), (128, 128, 2, 9, True), (64, 64, 16, 1, True),
    (256, 512, 64, 9, False),   # groups of 4 in, 8 out
    (128, 128, 64, 9, False),   # groups of 2
    (96, 96, 24, 9, False),     # C not a whole number of 64-channel slabs
    (256, 256, 64, 25, False),  # 5x5: the filter slab would not fit
    (256, 256, 1, 9, False), (250, 250, 64, 9, False)])
def test_gconv_fits(cin, cout, groups, taps, fits):
    assert G.gconv_fits(cin, cout, groups, taps) == fits


# ResNeXt-101 (64x4d)'s grouped 3x3s at b128 (oy, stride), and an output
# wider than 32 whose halo at stride 2 cuts the tile's rows
OUTPUTS = [(56, 1), (28, 2), (28, 1), (14, 2), (14, 1), (7, 2), (7, 1),
           (90, 2)]


@pytest.mark.parametrize("oy,stride", OUTPUTS)
def test_gconv_plan_covers_the_output(oy, stride):
    p = G.gconv_plan(128, oy, oy, 256, 4, 3, 3, (stride, stride), 132)
    assert p.tx <= 32 and p.tiles_x * p.tx >= oy > (p.tiles_x - 1) * p.tx
    assert p.tiles_y * p.ty >= oy > (p.tiles_y - 1) * p.ty
    assert p.ty * p.tx <= G.TILE_PIXELS
    halo_x = (p.tx - 1) * stride + 3
    assert p.hy == (p.ty - 1) * stride + 3
    assert p.hy * halo_x * G.PIXEL_BYTES <= G.HALO_BYTES
    # the box: the halo, widened at stride 1 across the whole width so that
    # its rows are as many as the tile's modulo 8 (the extra columns past
    # the image)
    if stride == 1 and p.tiles_x == 1:
        assert halo_x <= p.hx < halo_x + 8 and (p.hx - p.tx) % 8 == 0
    else:
        assert p.hx == halo_x


def test_gconv_plan_of_res2():
    # 56 columns in two tiles of 28, four rows: 112 pixels, 7 mma rows of
    # 16, from a 6 x 30 halo (two tiles across: not widened); three halos
    # in the ring, two blocks an SM,
    # 66 blocks on each of the 4 slabs (264 = 132 x 2), 3584 tiles a slab
    p = G.gconv_plan(128, 56, 56, 256, 4, 3, 3, (1, 1), 132)
    assert (p.ty, p.tx, p.tiles_y, p.tiles_x, p.hy, p.hx) == \
        (4, 28, 14, 2, 6, 30)
    assert (p.stages, p.per_sm, p.slabs, p.tiles, p.per_slab, p.grid) == \
        (3, 2, 4, 3584, 66, 264)


# (n, H, W, C, cg, k, stride, pad): ResNeXt-101 (64x4d)'s seven grouped
# 3x3s at b128, then edges: groups of 64, 1x1, pad 0, odd H and W, stride 2
# on odd sizes, one image, an output of 91 columns in three tiles
PLAN_SHAPES = [
    (128, 56, 56, 256, 4, 3, 1, 1), (128, 56, 56, 512, 8, 3, 2, 1),
    (128, 28, 28, 512, 8, 3, 1, 1), (128, 28, 28, 1024, 16, 3, 2, 1),
    (128, 14, 14, 1024, 16, 3, 1, 1), (128, 14, 14, 2048, 32, 3, 2, 1),
    (128, 7, 7, 2048, 32, 3, 1, 1),
    (2, 9, 9, 128, 64, 3, 1, 1), (2, 9, 9, 4096, 64, 3, 2, 1),
    (2, 9, 9, 256, 16, 1, 1, 0), (1, 37, 37, 64, 16, 3, 1, 0),
    (3, 13, 17, 256, 4, 3, 1, 1), (3, 15, 11, 128, 8, 3, 2, 1),
    (1, 14, 14, 1024, 16, 3, 1, 1), (1, 181, 181, 64, 4, 3, 2, 1)]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n,H,W,C,cg,k,st,pd", PLAN_SHAPES)
def test_gconv_plan_walks_each_tile_once_and_fits(n, H, W, C, cg, k, st, pd,
                                                  sms):
    """The persistent walk covers every (slab, image, tile) once; the ring,
    the staging, the rows' table and the barriers fit an SM's shared
    memory, as many blocks as the plan puts on it; the grid is no larger
    than the work; each TMA box is within 256 a dimension."""
    oy, ox = (H + 2 * pd - k) // st + 1, (W + 2 * pd - k) // st + 1
    p = G.gconv_plan(n, oy, ox, C, cg, k, k, (st, st), sms)
    seen = [t for b in range(p.grid) for t in p.walk(b)]
    want = {(s, i, ty, tx) for s in range(C // G.SLAB) for i in range(n)
            for ty in range(p.tiles_y) for tx in range(p.tiles_x)}
    assert len(seen) == len(want) and set(seen) == want
    assert p.slabs == C // G.SLAB and p.tiles == n * p.tiles_y * p.tiles_x
    assert p.tiles_y * p.ty >= oy and p.tiles_x * p.tx >= ox
    assert p.smem == G.block_smem(p.hy, p.hx, p.ty, p.tx, p.stages, cg)
    assert p.smem <= G.BLOCK_SMEM
    assert p.per_sm * (p.smem + 1024) <= G.SM_SMEM
    assert 1 <= p.per_sm <= G.BLOCKS_PER_SM
    assert G.MIN_STAGES <= p.stages <= G.MAX_STAGES
    assert p.grid <= p.slabs * p.tiles and p.per_slab <= p.tiles
    assert p.grid <= max(p.slabs, sms * p.per_sm)
    assert max(p.hy, p.hx, p.ty, p.tx) <= 256
    assert p.hy == (p.ty - 1) * st + k
    halo_x = (p.tx - 1) * st + k
    assert p.hy * halo_x * G.PIXEL_BYTES <= G.HALO_BYTES
    assert halo_x <= p.hx < halo_x + 8
    # widened only where the extra columns lie past the image
    assert p.hx == halo_x or (st == 1 and p.tiles_x == 1
                              and (p.hx - p.tx) % 8 == 0)


def _unpack(wp, C, cg):
    """pack_filter's inverse, from its layout: [C, 9 taps, cp] with k =
    tap * cp + c, the unit's channels at each tap."""
    cp = max(cg, 8)
    ks = wp.shape[2]
    k = wp.reshape(C // 64, 8, ks, 8, 4, 2, 2).permute(0, 1, 3, 2, 5, 4, 6)
    return k.reshape(C, ks * 16 // cp, cp)


@pytest.mark.parametrize("cg,k", [(4, 3), (8, 3), (16, 3), (32, 3), (64, 3),
                                  (4, 1), (16, 1), (32, 1)])
def test_pack_filter_unpacks_to_the_ohwi_filter(cg, k):
    """Each output's row of the packed filter is its OHWI filter at its own
    group's channels of the unit, zero at the other group of a pair (cg =
    4) and past its taps."""
    C = 128
    w = torch.randn(C, k, k, cg,
                    generator=torch.Generator().manual_seed(cg + k)).bfloat16()
    wp = G.pack_filter(w, C // cg)
    cp, taps = max(cg, 8), k * k
    assert wp.dtype == torch.bfloat16 and wp.is_contiguous()
    assert wp.shape == (C // 64, 8, G.filter_steps(cg), 32, 4)
    got = _unpack(wp, C, cg)
    assert got.shape[1] * cp == G.filter_steps(cg) * 16
    want = torch.zeros_like(got)
    for o in range(C):
        j = (o % cp) // cg  # o's group within its unit
        want[o, :taps, j * cg:(j + 1) * cg] = w[o].reshape(taps, cg)
    assert torch.equal(got, want)
    if cg == 4:
        # the pair's off-diagonal blocks: outputs 0-3 read channels 4-7 as 0
        assert not got.view(C // 8, 2, 4, -1, 2, 4)[:, 0, :, :, 1].any()
        assert not got.view(C // 8, 2, 4, -1, 2, 4)[:, 1, :, :, 0].any()


@pytest.mark.parametrize("what", ["dtype", "width", "bias", "noncontig"])
def test_gconv_refuses(what):
    x, w, b = _operands(1, 5, 64, 4)
    if what == "dtype":
        x = x.float()
    elif what == "width":
        w = w[:, :, :, :2].contiguous()
    elif what == "bias":
        b = b[:10]
    else:
        x = x.transpose(1, 2)
    with pytest.raises(RtErr, match="gconv"):
        G.gconv(x, w, b, 16)


# ------------------------------------------------------------- the routes

def _gop(prec="bf16", nhwc=True, groups=16, cin=64, edge_prec=None):
    op = make_conv_op(2, cin, 9, 9, cin, 3, 3, 2, 2, 1, 1, relu=True,
                      groups=groups)
    if prec:
        op.str_vals["prec"] = prec
    if nhwc:
        op.str_vals["io_layout"] = "nhwc"
        ep = edge_prec if edge_prec is not None else prec
        if ep:
            op.str_vals["edge_prec"] = ep
    return op


def _build(op):
    t = get_template(op.func_name)
    return t.build(t.check_args(op))


def test_b8_step_is_the_vendor_path_bit_for_bit():
    op = _gop()
    fn = _build(op)
    x, _, b = _operands(2, 9, 64, 4, seed=5)
    w = torch.randn(64, 4, 3, 3, generator=torch.Generator().manual_seed(6))
    got = fn(x, w, b)
    y = vendor_conv((2, 2), (1, 1), torch.bfloat16, True, groups=16)(x, w, b)
    want = vendor_store(y, True, torch.bfloat16, True)
    assert torch.equal(got, want) and got.is_contiguous()


def test_b8_step_under_autograd_runs_the_vendor_conv(monkeypatch):
    calls = []
    real = C.gconv
    monkeypatch.setattr(C, "gconv", lambda *a, **k: calls.append(1) or
                        real(*a, **k))
    fn = _build(_gop())
    x, _, b = _operands(2, 9, 64, 4, seed=7)
    w = torch.randn(64, 4, 3, 3, requires_grad=True)
    y = fn(x, w, b)
    assert not calls and y.grad_fn is not None
    y.float().sum().backward()
    # the VJP in groups: dW against autograd through F.conv2d's f32 conv
    # of the rounded operands
    wr = w.detach().bfloat16().float().requires_grad_()
    z = F.conv2d(x.permute(0, 3, 1, 2).float(), wr, b, 2, 1, 1, 16)
    g = (torch.relu(z).bfloat16() > 0).float()
    (z * g).sum().backward()
    torch.testing.assert_close(w.grad, wr.grad.bfloat16().float(),
                               rtol=2 ** -7, atol=1e-3)
    with torch.no_grad():
        fn(x, w, b)
    assert calls == [1]


def test_conv_flops_counts_each_groups_channels():
    op = make_conv_op(2, 256, 14, 14, 256, 3, 3, 1, 1, 1, 1, groups=64)
    assert op.get_dims("filts").shape == (256, 4, 3, 3)
    assert conv_flops(op) == 2 * 2 * 14 * 14 * 256 * 4 * 9
    # the sig and its wisdom key carry groups, and only where g > 1: an
    # ungrouped sig reads as before; the reduced sig keeps the JAX
    # package's keys, and its dims give the groups
    t = get_template("xla_conv")
    g64 = "groups=(tn=uint32_t,v=64)"
    assert g64 in str(op.to_lexp()) and g64 in str(wisdom.wisdom_key(op))
    assert C.conv_groups(t.check_args(op)) == 64
    plain = make_conv_op(2, 256, 14, 14, 256, 3, 3)
    assert "groups" not in str(plain.to_lexp())
    assert C.conv_groups(t.check_args(plain)) == 1
    odd = make_conv_op(2, 256, 14, 14, 250, 3, 3, groups=64)
    with pytest.raises(RtErr, match="no whole number of groups"):
        C.conv_groups(odd)


# ------------------------------------------------------ IR, zoo, lowering

def grouped_net(batch=2, hw=12, seed=3):
    """conv1, a bottleneck whose 3x3 runs in 16 groups of 4 with a
    projected shortcut, a strided 3x3 in 8 groups of 8, a global pool and
    a 1x1 classifier."""
    b = NetBuilder("grouped", batch, 3, hw, hw)
    b.conv("conv1", 64, 3, 1, 1)
    b.conv("blk_branch2a", 64, 1, in_node="conv1")
    b.conv("blk_branch2b", 64, 3, 1, 1, groups=16)
    b.conv("blk_branch2c", 64, 1, relu=False)
    b.conv("blk_branch1", 64, 1, relu=False, in_node="conv1")
    b.eltwise("blk", ["blk_branch1", "blk_branch2c"])
    b.relu("blk_relu")
    b.conv("down", 64, 3, 2, 1, groups=8)
    b.pool("pool", 0, 1, avg=True, global_=True)
    b.conv("fc", 10, 1, relu=False)
    return b.done(seed=seed)


def _run(pipe, spec, out="fc"):
    eng = make_engine(spec)
    eng.init(pipe)
    d = pipe.get_data_img_dims()
    x = np.random.RandomState(1).randn(*d.shape).astype(np.float32)
    return eng, eng.run_fwd({"data": NDA(d, x)}, [out])[out].v


def test_grouped_filter_dims_and_refusal():
    pipe = grouped_net()
    assert pipe.must_get_node("blk_branch2b_filts").dims.shape == \
        (64, 4, 3, 3)
    assert pipe.must_get_node("down_filts").dims.shape == (64, 8, 3, 3)
    b = NetBuilder("odd", 1, 3, 8, 8)
    b.conv("c1", 24, 3, 1, 1).conv("c2", 24, 3, 1, 1, groups=5)
    with pytest.raises(RtErr, match="conv 'c2': 5 groups do not divide"):
        b.done()


def test_grouped_convs_take_no_fused_template():
    pipe = grouped_net()
    for tune in ("()", "(fuse_stem=1,fuse_resblock=1)", HEADLINE,
                 "(k1conv=1,tconv=1,ipconv=1)"):
        plan = lower_pipe(pipe, make_op_tune(tune), fused_storage=True)
        gs = [s for s in plan.steps if s.sig.get_u32_or("groups", 1) > 1]
        assert [s.call_tag for s in gs] == ["blk_branch2b", "down"]
        assert all(s.func_name == "xla_conv" for s in gs)
        assert not any(s.func_name in ("resblock", "fused_stem")
                       and "blk" in s.call_tag for s in plan.steps)


def _siblings_net():
    b = NetBuilder("sibs", 1, 3, 8, 8)
    b.conv("c1", 64, 3, 1, 1)
    for tag, g in (("a", 1), ("b", 1), ("g1", 4), ("g2", 4)):
        b.conv(tag, 64, 1, in_node="c1", groups=g)
    b.concat("cat", ["a", "b", "g1", "g2"])
    return b.done()


def test_sibling_fusion_keeps_grouped_convs_apart():
    plan = lower_pipe(_siblings_net(), make_op_tune(HEADLINE),
                      fused_storage=True)
    fused = [s for s in plan.steps if s.func_name == "xla_conv2"]
    assert [s.call_tag for s in fused] == ["a+b"]
    alone = {s.call_tag: s.sig.get_u32_or("groups", 1) for s in plan.steps
             if s.func_name == "xla_conv" and s.call_tag != "c1"}
    assert alone == {"g1": 4, "g2": 4}


def test_quant8_at_a_grouped_site_raises():
    pipe = grouped_net()
    with pytest.raises(RtErr, match="quant8 at grouped conv site "
                                    "'blk_branch2b'"):
        lower_pipe(pipe, make_op_tune("(use_culibs=1,quant8=1)"))
    # an int8 site that is not grouped still lowers
    plan = lower_pipe(pipe, make_op_tune("(use_culibs=1)"), op_tunes={
        "blk_branch2c": make_op_tune("(use_culibs=1,quant8=1)")})
    q = [s.call_tag for s in plan.steps if s.sig.get_u32_or("quant8", 0)]
    assert q == ["blk_branch2c"]


def test_add_bck_ops_refuses_a_grouped_conv():
    b = NetBuilder("bck", 1, 3, 8, 8)
    b.conv("c1", 8, 3, 1, 1).conv("c2", 8, 3, 1, 1, groups=2)
    b.softmax_with_loss()
    pipe = b.done()
    with pytest.raises(RtErr, match="grouped conv 'c2'"):
        pipe.add_bck_ops()


@pytest.mark.parametrize("tune,tol", [("()", 1e-4),
                                      ("(use_culibs=1)", 1e-4),
                                      (HEADLINE, 2e-2)])
def test_engine_ref_agrees_with_the_port(tune, tol):
    """engine=ref (float64 numpy ref_impl, in groups) against the port on
    the CPU: the f32 tunes at the f32 gate; the cell's bf16 tune (B7 and
    B8's plain versions, bf16 edges) at 2e-2 of the logits' largest, a few
    bf16 roundings of 6 layers."""
    pipe = grouped_net()
    _, ref = _run(pipe, "(engine=ref)")
    eng, got = _run(pipe, f"(engine=torch,device=cpu,op_tune={tune})")
    got = np.asarray(got, np.float64)
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
    routes = [eng.fwd.conv_routes[t] for t in ("blk_branch2b", "down")]
    assert routes == (["b8", "b8"] if tune == HEADLINE else
                      ["vendor", "vendor"])


def test_ref_impl_in_groups_is_the_per_group_convs():
    op = make_conv_op(2, 16, 7, 7, 8, 3, 3, 2, 2, 1, 1, relu=True,
                      groups=4)
    rng = np.random.RandomState(2)
    x, w, b = rng.randn(2, 16, 7, 7), rng.randn(8, 4, 3, 3), rng.randn(8)
    t = get_template("xla_conv")
    got = t.ref_impl(t.check_args(op), x, w, b)
    want = F.relu(F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), 2, 1, 1, 4)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------- the importer

PROTOTXT = """name: "g2"
input: "data"
input_shape { dim: 2 dim: 8 dim: 9 dim: 9 }
layer { name: "c" type: "Convolution" bottom: "data" top: "c"
  convolution_param { num_output: 6 kernel_size: 3 pad: 1 group: %d } }
layer { name: "r" type: "ReLU" bottom: "c" top: "c" }
"""


def test_a_prototxt_with_group_imports_and_runs(tmp_path):
    src = caffe_io.create_pipe_from_param(parse_pbtext(PROTOTXT % 2))
    src.calc_dims()
    src.calc_support_info()
    assert src.must_get_node("c_filts").dims.shape == (6, 4, 3, 3)
    rng = np.random.RandomState(4)
    w = rng.randn(6, 4, 3, 3).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    src.op_params["c_filts"] = NDA(src.must_get_node("c_filts").dims, w)
    src.op_params["c_biases"] = NDA(src.must_get_node("c_biases").dims, b)
    # written out and read back: the group, and the (out, in / g, k, k) blob
    caffe_io.write_prototxt(src, tmp_path / "g.prototxt")
    caffe_io.write_caffemodel(src, tmp_path / "g.caffemodel")
    assert "group: 2" in (tmp_path / "g.prototxt").read_text()
    pipe = caffe_io.read_model(tmp_path / "g.prototxt",
                               tmp_path / "g.caffemodel")
    assert pipe.get_op("c").get_u32("groups") == 2
    np.testing.assert_array_equal(pipe.op_params["c_filts"].v, w)
    _, got = _run(pipe, "(engine=torch,device=cpu,op_tune=())", out="c")
    x = np.random.RandomState(1).randn(2, 8, 9, 9).astype(np.float32)
    want = F.relu(F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), 1, 1, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_a_group_that_does_not_divide_raises():
    pipe = caffe_io.create_pipe_from_param(parse_pbtext(PROTOTXT % 3))
    with pytest.raises(RtErr, match="conv 'c': 3 groups do not divide"):
        pipe.calc_dims()
    deconv = PROTOTXT.replace('"Convolution"', '"Deconvolution"') % 2
    with pytest.raises(RtErr, match="deconvolution group=2"):
        caffe_io.create_pipe_from_param(parse_pbtext(deconv))


# ------------------------------------------------------------ the spans

def test_step_spans_carry_the_b8_route_and_groups():
    pipe = grouped_net()
    eng = make_engine(f"(engine=torch,device=cpu,op_tune={HEADLINE})")
    eng.init(pipe)
    d = pipe.get_data_img_dims()
    x = NDA(d, np.random.RandomState(0).randn(*d.shape).astype(np.float32))
    global_timer_log.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        eng.run_fwd({"data": x}, ["fc"])
    steps = [s[5] for s in global_timer_log.spans if s[0] == "fwd.step"]
    global_timer_log.clear()
    grouped = {a["call_tag"]: (a["route"], a["groups"]) for a in steps
               if "groups" in a}
    assert grouped == {"blk_branch2b": ("b8", 16), "down": ("b8", 8)}
    assert sorted(eng.fwd.conv_routes.values()).count("b8") == 2


# ----------------------------------------------------------- on the card

def test_b8_against_its_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("B8 is CUDA C++ with no CPU form: needs a card "
                    "(chip_smoke.py --phases env,build,gconv holds it at "
                    "ResNeXt-101's shapes)")
    dev = torch.device("cuda", 0)
    for cg, stride in ((4, 1), (8, 2), (32, 1)):
        x, w, b = (t.to(dev) for t in _operands(2, 11, 64 * cg, cg, seed=cg))
        got = G.gconv(x, w, b, 64, (stride, stride), (1, 1), relu=True)
        want = _per_group(x, w, b, 64, (stride, stride), True)
        d = (got.double() - want.double()).abs().max()
        assert float(d / want.double().abs().max()) <= 5e-3


def test_a_mesh_runs_a_grouped_conv_on_the_gathered_weight(monkeypatch):
    """Under mesh_mp=2 a grouped conv reads its whole filter (an out_chan
    slice would read another slice of the input), and the forward is one
    slot's."""
    monkeypatch.setenv("BODA_TORCH_LOCAL_DEVICES", "2")
    pipe = grouped_net()
    _, one = _run(pipe, "(engine=torch,device=cpu,op_tune=(use_culibs=1))")
    eng, got = _run(pipe, "(engine=torch,device=cpu,mesh_dp=1,mesh_mp=2,"
                          "op_tune=(use_culibs=1))")
    assert eng.fwd.routes["gathered"] >= 2
    np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-5)
