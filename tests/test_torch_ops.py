"""The port's plain-torch templates (pool, relu, eltwise, softmax) against
the JAX templates on the same seeded inputs, in the NCHW f32 form and in
the NHWC storage form (f32 edges, and bf16 edges as under prec=bf16).

Tolerances: f32 rtol = atol = 2e-5; bf16 edges mrd <= 5e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boda_tpu.core.dims import Dims
from boda_tpu.graph.support import Pt, pool_in_sz_to_out_sz
from boda_tpu.ops.op_base import OpBase
from boda_tpu.ops.registry import get_template as jax_template
from boda_tpu.testing.comp import mrd
from boda_tpu_torch.ops.op_base import OpBase as PortOpBase
from boda_tpu_torch.ops.registry import get_template


def _port_op(op):
    """The port's copy of a JAX op sig, through its lexp text."""
    return PortOpBase.from_lexp(str(op.to_lexp()))


N, C, H, W = 2, 6, 10, 10
# storage form -> (io_layout, edge dtype)
FORMS = {"nchw": ("", "float32"), "nhwc-f32": ("nhwc", "float32"),
         "nhwc-bf16": ("nhwc", "bfloat16")}
POOLS = {
    # ResNet pool1's form: 3x3/s2 pad 0, caffe ceil mode (10 -> 5: the
    # last window runs past the edge)
    "max-3x3-s2-ceil": dict(k=3, s=2, p=0, avg=False),
    "max-3x3-s2-pad1": dict(k=3, s=2, p=1, avg=False),
    "avg-3x3-s2-pad1": dict(k=3, s=2, p=1, avg=True),
    "avg-global": dict(k=H, s=1, p=0, avg=True),
}


def _x(seed=0, shape=(N, C, H, W)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _run_both(op, form, *xs, args_nchw=None):
    """Run the JAX template and the port's on the same inputs, given in
    the form's layout and dtype; returns (port out, jax out) as f32 numpy
    arrays in the form's layout."""
    io_layout, edt = FORMS[form]
    if io_layout:
        op.str_vals["io_layout"] = io_layout
        xs = [x.transpose(0, 2, 3, 1).copy() for x in xs]
    jt, pt = jax_template(op.func_name), get_template(op.func_name)
    rfs = pt.check_args(_port_op(op))
    assert str(rfs) == str(jt.check_args(op))
    want = jt.build(jt.check_args(op))(
        *[jnp.asarray(x).astype(getattr(jnp, edt)) for x in xs])
    got = pt.build(rfs)(
        *[torch.from_numpy(x).to(getattr(torch, edt)) for x in xs])
    assert str(got.dtype) == f"torch.{edt}"
    return got.float().numpy(), np.asarray(want, np.float32)


def _close(got, want, form):
    assert got.shape == want.shape
    if FORMS[form][1] == "bfloat16":
        assert mrd(got, want) <= 5e-3
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _pool_op(k, s, p, avg):
    out = pool_in_sz_to_out_sz(Pt(W, H), Pt(p, p), Pt(s, s), Pt(k, k))
    op = OpBase({"type": "Pooling", "func_name": "pool"})
    op.set_dims("in", Dims.make(img=N, chan=C, y=H, x=W))
    op.set_dims("out", Dims.make(img=N, chan=C, y=out.y, x=out.x))
    op.set_null_dims("kern_sz", y=k, x=k)
    op.set_null_dims("stride", y=s, x=s)
    op.set_null_dims("in_pad", y=p, x=p)
    if avg:
        op.str_vals["avg_pool"] = "1"
    return op


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("name", list(POOLS))
def test_pool_matches_jax(name, form):
    op = _pool_op(**POOLS[name])
    x = _x()
    got, want = _run_both(op, form, x)
    _close(got, want, form)
    if form == "nchw":
        pt = get_template("pool")
        np.testing.assert_allclose(got, pt.ref_impl(pt.check_args(_port_op(op)), x),
                                   rtol=2e-5, atol=2e-5)


def test_pool_ceil_mode_keeps_the_clipped_last_window():
    # 112 -> 56 in ResNet's pool1; here 10 -> 5. The output size comes
    # from the graph (caffe's rule); the port pads with -inf out to the
    # last window it needs instead of relying on torch's ceil_mode, so
    # the last window is the clipped 2x2 corner
    op = _pool_op(**POOLS["max-3x3-s2-ceil"])
    assert op.get_dims("out")["y"] == 5
    x = _x()
    pt = get_template("pool")
    got = pt.build(pt.check_args(_port_op(op)))(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got[:, :, -1, -1], x[:, :, 8:, 8:].max(
        axis=(2, 3)))


def _ew_op(func_name, **str_vals):
    op = OpBase({"type": func_name, "func_name": func_name})
    d = Dims.make(img=N, chan=C, y=H, x=W)
    for a in {"relu": ["inout"], "eltwise": ["a", "b", "out"],
              "softmax": ["in", "out"]}[func_name]:
        op.set_dims(a, d)
    op.str_vals.update(str_vals)
    return op


@pytest.mark.parametrize("form", list(FORMS))
def test_relu_matches_jax(form):
    got, want = _run_both(_ew_op("relu"), form, _x())
    _close(got, want, form)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("ew_op", ["SUM", "MAX", "PROD"])
def test_eltwise_matches_jax(ew_op, form):
    got, want = _run_both(_ew_op("eltwise", ew_op=ew_op), form, _x(0), _x(1))
    _close(got, want, form)


@pytest.mark.parametrize("form", list(FORMS))
def test_softmax_matches_jax(form):
    got, want = _run_both(_ew_op("softmax"), form, _x() * 3)
    _close(got, want, form)
    ax = -1 if FORMS[form][0] else 1
    np.testing.assert_allclose(got.sum(axis=ax), 1.0, atol=1e-2)
