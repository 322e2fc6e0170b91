"""The zoo's data-movement and normalization templates on the port against
the JAX package's, on the same numpy-seeded inputs: copy and split_copy
(the Concat and Split lowerings, at a channel offset), scale (with and
without bias), ZeroIfNonPos, xpose, xpose_filts, reduce, bwai (copy, scale,
read), lrn and deconv, each in the NCHW f32 form and in the NHWC storage
form (f32 edges, and bf16 edges as under prec=bf16).

Tolerances: the data-movement templates, scale, ZeroIfNonPos, reduce and
bwai copy and scale bit-equal; bwai read bit-equal where the f32 sum is
exact (integer data) and within 1e-6 of the sum of |x| on random data (an
f32 sum in another order); lrn f32 mrd 1e-5, bf16 NHWC mrd 5e-3; deconv
f32 mrd 1e-5 against both the JAX template and the float64 scatter, and
under bf16 (operands rounded to bf16, f32 sums, bf16 store) mrd 5e-3
against the JAX template, with every stored value within one bf16 step of
it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boda_tpu.core.dims import Dims
from boda_tpu.graph.caffe_io import copy_matching_layer_blobs_to_pipe as \
    jcopy_blobs
from boda_tpu.models.zoo import NetBuilder as JNetBuilder
from boda_tpu.ops.op_base import OpBase
from boda_tpu.ops.pallas.conv import make_deconv_op
from boda_tpu.ops.registry import get_template as jax_template
from boda_tpu.testing.comp import mrd
from boda_tpu_torch.core.dims import NDA as PNDA
from boda_tpu_torch.core.dims import Dims as PDims
from boda_tpu_torch.graph.caffe_io import copy_matching_layer_blobs_to_pipe
from boda_tpu_torch.models.zoo import NetBuilder
from boda_tpu_torch.ops.op_base import OpBase as PortOpBase
from boda_tpu_torch.ops.registry import get_template

N, H, W = 2, 5, 7
# storage form -> (io_layout, edge dtype)
FORMS = {"nchw": ("", "float32"), "nhwc-f32": ("nhwc", "float32"),
         "nhwc-bf16": ("nhwc", "bfloat16")}


def _port_op(op):
    """The port's copy of a JAX op sig, through its lexp text."""
    return PortOpBase.from_lexp(str(op.to_lexp()))


def _x(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


def _nhwc(x):
    return x.transpose(0, 2, 3, 1).copy() if x.ndim == 4 else x


def _both(op, xs, edt="float32"):
    """Build the JAX template and the port's from op; run both on xs (numpy,
    already in the op's storage layout) cast to edt. Returns (port result,
    port inputs, jax result, the port template, its reduced sig)."""
    jt, pt = jax_template(op.func_name), get_template(op.func_name)
    rfs = pt.check_args(_port_op(op))
    assert str(rfs) == str(jt.check_args(op))
    tin = [torch.from_numpy(x).to(getattr(torch, edt)) for x in xs]
    want = jt.build(jt.check_args(op))(
        *[jnp.asarray(x).astype(getattr(jnp, edt)) for x in xs])
    got = pt.build(rfs)(*tin)
    return got, tin, np.asarray(want), pt, rfs


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _bit_equal(got, want):
    g = _np(got)
    w = np.asarray(want, np.float32) if str(want.dtype) == "bfloat16" \
        else want
    assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_array_equal(g, w)


def _concat_op(cin, cout, ocix, io_layout):
    op = OpBase({"type": "Concat", "func_name": "copy"})
    op.set_dims("in", Dims.make(img=N, chan=cin, y=H, x=W))
    op.set_dims("out", Dims.make(img=N, chan=cout, y=H, x=W))
    op.set_u32("ocix", ocix)
    if io_layout:
        op.str_vals["io_layout"] = io_layout
    return op


@pytest.mark.parametrize("form", list(FORMS))
def test_copy_writes_its_slice_in_place(form):
    io_layout, edt = FORMS[form]
    op = _concat_op(3, 8, 4, io_layout)
    lay = _nhwc if io_layout else (lambda v: v)
    x, out = lay(_x((N, 3, H, W))), lay(_x((N, 8, H, W), seed=1))
    got, tin, want, pt, rfs = _both(op, [x, out], edt)
    _bit_equal(got, want)
    # in place: the call returns the buffer it was given, whose other
    # channels keep their values
    assert got is tin[1]
    ref = pt.ref_impl(rfs, _x((N, 3, H, W)), _x((N, 8, H, W), seed=1))
    if not io_layout:
        np.testing.assert_array_equal(_np(got), ref)


@pytest.mark.parametrize("form", list(FORMS))
def test_split_copy(form):
    io_layout, edt = FORMS[form]
    op = OpBase({"type": "Split", "func_name": "split_copy"})
    op.set_dims("in", Dims.make(img=N, chan=8, y=H, x=W))
    op.set_dims("out", Dims.make(img=N, chan=3, y=H, x=W))
    op.set_u32("icix", 5)
    if io_layout:
        op.str_vals["io_layout"] = io_layout
    lay = _nhwc if io_layout else (lambda v: v)
    got, tin, want, pt, rfs = _both(op, [lay(_x((N, 8, H, W)))], edt)
    _bit_equal(got, want)
    assert got.is_contiguous() and got.data_ptr() != tin[0].data_ptr()


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("form", list(FORMS))
def test_scale(form, bias):
    io_layout, edt = FORMS[form]
    op = OpBase({"type": "Scale", "func_name": "scale"})
    op.set_dims("in", Dims.make(img=N, chan=6, y=H, x=W))
    op.set_dims("scales", Dims.make(chan=6))
    if bias:
        op.set_dims("biases", Dims.make(chan=6))
    op.set_dims("out", Dims.make(img=N, chan=6, y=H, x=W))
    if io_layout:
        op.str_vals["io_layout"] = io_layout
    x = _x((N, 6, H, W))
    xs = [_nhwc(x) if io_layout else x, _x((6,), seed=2)]
    if bias:
        xs.append(_x((6,), seed=3))
    got, _, want, pt, rfs = _both(op, xs, edt)
    _bit_equal(got, want)
    if edt == "float32" and not io_layout:
        np.testing.assert_allclose(_np(got), pt.ref_impl(rfs, x, *xs[1:]),
                                   rtol=1e-6)


@pytest.mark.parametrize("edt", ["float32", "bfloat16"])
def test_zero_if_non_pos(edt):
    op = OpBase({"type": "ZeroIfNonPos", "func_name": "ZeroIfNonPos"})
    for a in ("in", "grad", "out"):
        op.set_dims(a, Dims.make(img=N, chan=4, y=H, x=W))
    x = _x((N, 4, H, W))
    x[0, 0, 0, :3] = 0.0  # zero is not positive
    got, _, want, _, _ = _both(op, [x, _x((N, 4, H, W), seed=1)], edt)
    _bit_equal(got, want)


@pytest.mark.parametrize("case", ["transpose", "reshape"])
def test_xpose(case):
    op = OpBase({"type": "xpose", "func_name": "xpose"})
    op.set_dims("in", Dims.make(img=N, chan=4, y=H, x=W))
    out = Dims.make(img=N, y=H, x=W, chan=4) if case == "transpose" \
        else Dims.make(img=N, v=4 * H * W)
    op.set_dims("out", out)
    got, _, want, pt, rfs = _both(op, [_x((N, 4, H, W))])
    _bit_equal(got, want)
    assert got.is_contiguous() and tuple(got.shape) == tuple(out.shape)


def test_xpose_filts():
    op = OpBase({"type": "xpose_filts", "func_name": "xpose_filts"})
    op.set_dims("filts", Dims.make(out_chan=6, in_chan=4, y=3, x=2))
    op.set_dims("filts_xp", Dims.make(y=3, x=2, in_chan=4, out_chan=6))
    got, _, want, _, _ = _both(op, [_x((6, 4, 3, 2))])
    _bit_equal(got, want)
    assert got.is_contiguous()


@pytest.mark.parametrize("edt", ["float32", "bfloat16"])
def test_reduce(edt):
    op = OpBase({"type": "reduce", "func_name": "reduce"})
    op.set_dims("ins", Dims.make(n=5, img=N, chan=3, y=H, x=W))
    op.set_dims("out", Dims.make(img=N, chan=3, y=H, x=W))
    got, _, want, _, _ = _both(op, [_x((5, N, 3, H, W))], edt)
    _bit_equal(got, want)


def _bwai_op(bw_op, n):
    op = OpBase({"type": "bwai", "func_name": "bwai", "bw_op": bw_op})
    op.set_dims("in", Dims.make(tn="float", n=n))
    op.set_dims("out", Dims.make(tn="float", n=8 if bw_op == "read" else n))
    return op


@pytest.mark.parametrize("edt", ["float32", "bfloat16"])
@pytest.mark.parametrize("bw_op", ["copy", "scale", "read"])
def test_bwai(bw_op, edt):
    n = 4096
    # integer values: every f32 partial sum is exact, so read is bit-equal
    # whatever order the library sums in
    x = np.random.RandomState(0).randint(-8, 9, n).astype(np.float32)
    got, tin, want, pt, rfs = _both(_bwai_op(bw_op, n), [x], edt)
    _bit_equal(got, want)
    assert got.data_ptr() != tin[0].data_ptr()
    if edt == "float32":
        np.testing.assert_array_equal(_np(got), pt.ref_impl(rfs, x))


def test_bwai_read_random():
    n = 65536
    x = _x((n,), scale=3.0)
    got, _, want, pt, rfs = _both(_bwai_op("read", n), [x])
    assert np.abs(_np(got)[0] - want[0]) <= 1e-6 * np.abs(x).sum()
    np.testing.assert_array_equal(_np(got)[1:], 0)


def _lrn_op(C, io_layout, n=5):
    op = OpBase({"type": "LRN", "func_name": "lrn"})
    op.set_dims("in", Dims.make(img=N, chan=C, y=H, x=W))
    op.set_dims("out", Dims.make(img=N, chan=C, y=H, x=W))
    op.set_u32("local_size", n)
    from boda_tpu.core.dims import NDA
    op.nda_vals["alpha"] = NDA.scalar(1e-4 * 500, "float")
    op.nda_vals["beta"] = NDA.scalar(0.75, "float")
    op.nda_vals["k"] = NDA.scalar(2.0, "float")
    if io_layout:
        op.str_vals["io_layout"] = io_layout
    return op


@pytest.mark.parametrize("n", [3, 5, 4])
@pytest.mark.parametrize("form", list(FORMS))
def test_lrn(form, n):
    io_layout, edt = FORMS[form]
    C = 7
    x = _x((N, C, H, W), scale=2.0)
    op = _lrn_op(C, io_layout, n)
    got, _, want, pt, rfs = _both(op, [_nhwc(x) if io_layout else x], edt)
    g = _np(got)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape and str(got.dtype) == f"torch.{edt}"
    toler = 5e-3 if edt == "bfloat16" else 1e-5
    assert mrd(g, w) <= toler
    back = g.transpose(0, 3, 1, 2) if io_layout else g
    # the float64 reference of the input as the template got it (rounded
    # to the edge dtype)
    xr = _np(torch.from_numpy(x).to(getattr(torch, edt)))
    assert mrd(back, pt.ref_impl(rfs, xr)) <= toler


DECONV_CASES = {
    # FCN-style 2x upsampling: k=4 s=2 p=1
    "k4s2p1": dict(n=2, cin=8, h=6, w=6, cout=4, k=4, stride=2, pad=1),
    # k=3 s=1 p=1 (shape-preserving), ReLU
    "k3s1p1-relu": dict(n=1, cin=8, h=7, w=5, cout=8, k=3, stride=1, pad=1,
                        relu=True),
    # s=3 heavy upsample, no pad, no bias
    "k5s3-nobias": dict(n=1, cin=4, h=4, w=4, cout=8, k=5, stride=3, pad=0,
                        bias=False),
}


def _deconv(case, io_layout="", prec=""):
    c = dict(DECONV_CASES[case])
    n, cin, h, w, cout, k = (c.pop(a) for a in ("n", "cin", "h", "w",
                                                 "cout", "k"))
    s, p = c.pop("stride"), c.pop("pad")
    op = make_deconv_op(n, cin, h, w, cout, k, k, s, s, p, p, **c)
    if io_layout:
        op.str_vals["io_layout"] = io_layout
    if prec:
        op.str_vals["prec"] = prec
        op.str_vals["edge_prec"] = prec
    rng = np.random.RandomState(7)
    x = rng.randn(n, cin, h, w).astype(np.float32) * 0.3
    args = [x, rng.randn(cout, cin, k, k).astype(np.float32) * 0.3]
    if c.get("bias", True):
        args.append(rng.randn(cout).astype(np.float32))
    edt = "bfloat16" if prec and io_layout else "float32"
    xs = [_nhwc(x) if io_layout else x] + args[1:]
    got, _, want, pt, rfs = _both(op, xs, edt)
    g, wj = _np(got), np.asarray(want, np.float32)
    if io_layout:
        g, wj = g.transpose(0, 3, 1, 2), wj.transpose(0, 3, 1, 2)
    return g, wj, np.asarray(pt.ref_impl(rfs, *args)), str(got.dtype)


@pytest.mark.parametrize("io_layout", ["", "nhwc"])
@pytest.mark.parametrize("case", list(DECONV_CASES))
def test_deconv_f32(case, io_layout):
    got, want, ref, dt = _deconv(case, io_layout)
    assert dt == "torch.float32" and got.shape == want.shape == ref.shape
    assert mrd(got, want) <= 1e-5
    assert mrd(got, ref) <= 1e-5


@pytest.mark.parametrize("io_layout", ["", "nhwc"])
@pytest.mark.parametrize("case", list(DECONV_CASES))
def test_deconv_bf16(case, io_layout):
    got, want, _, dt = _deconv(case, io_layout, prec="bf16")
    assert dt == ("torch.bfloat16" if io_layout else "torch.float32")
    assert mrd(got, want) <= 5e-3
    # the sums differ in order only: any two stored values are at most one
    # bf16 step (2^-8 of the value) apart
    step = np.abs(want) * 2.0 ** -7 + 1e-30
    assert (np.abs(got - want) <= step).all()


def test_deconv_k1s1_weight_interpretation():
    """A 1x1 stride-1 deconv has a conv's output shape, so only the numbers
    show a misread blob: caffe stores deconv weights (in_chan, out_chan, 1,
    1), and the copy transposes them to the pipe's (out_chan, in_chan);
    both packages read the same asymmetric blob alike, and the template
    contracts over in_chan."""
    rng = np.random.RandomState(3)
    blob = rng.randn(4, 6, 1, 1).astype(np.float32)  # caffe (in=4, out=6)
    bias = np.zeros(6, np.float32)
    pipes = []
    for builder, copy_fn, nda, dims in (
            (NetBuilder, copy_matching_layer_blobs_to_pipe, PNDA, PDims),
            (JNetBuilder, jcopy_blobs, None, Dims)):
        from boda_tpu.core.dims import NDA as JNDA
        nda = nda or JNDA
        b = builder("k1", 1, 4, 5, 5)
        b.deconv("d", 6, 1)
        pipe = b.done(init_weights=False)
        copy_fn(pipe, {"d": [
            nda(dims.make(in_chan=4, out_chan=6, y=1, x=1), blob),
            nda(dims.make(out_chan=6), bias)]})
        pipes.append(pipe)
    w = pipes[0].op_params["d_filts"].v
    np.testing.assert_array_equal(w, blob.transpose(1, 0, 2, 3))
    np.testing.assert_array_equal(w, pipes[1].op_params["d_filts"].v)
    op = make_deconv_op(1, 4, 5, 5, 6, 1, 1)
    x = _x((1, 4, 5, 5), seed=4)
    got, _, want, _, _ = _both(op, [x, w, bias])
    want_einsum = np.einsum("nihw,oi->nohw", x, w[:, :, 0, 0])
    assert mrd(_np(got), want) <= 1e-5
    assert mrd(_np(got), want_einsum) <= 1e-5
