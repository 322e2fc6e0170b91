"""The port's conv templates (k1conv, conv, ipconv on kernel B1; the
vendor convs s2d_conv and xla_conv) against the JAX templates in fallback
mode and against each template's float64 ref_impl, on the same seeded
inputs, in each storage form the lowering gives them: NCHW f32, NHWC
storage with f32 edges, and NHWC storage with bf16 edges under prec=bf16.

Tolerances: f32 rtol = atol = 2e-5; bf16 mrd <= 5e-3 (the repo's bf16
mrd_toler).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boda_tpu.ops.pallas.conv import make_conv_op
from boda_tpu.ops.registry import get_template as jax_template
from boda_tpu.testing.comp import mrd
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.ops.op_base import OpBase
from boda_tpu_torch.ops.registry import get_template


def _port_op(op):
    """The port's copy of a JAX op sig, through its lexp text."""
    return OpBase.from_lexp(str(op.to_lexp()))


# name -> (n, cin, h, w, cout, k, stride, pad, func_name, relu)
CONVS = {
    "k1conv-s1": (2, 16, 8, 8, 24, 1, 1, 0, "k1conv", True),
    "k1conv-s2": (2, 16, 9, 9, 32, 1, 2, 0, "k1conv", False),
    "conv-3x3-s1": (2, 16, 7, 7, 20, 3, 1, 1, "conv", True),
    "conv-3x3-s2": (1, 16, 9, 9, 12, 3, 2, 1, "conv", False),
    "ipconv": (2, 8, 3, 3, 10, 3, 1, 0, "ipconv", False),
    "s2d_conv-7x7": (2, 3, 16, 16, 8, 7, 2, 3, "s2d_conv", True),
    # the vendor conv of the use_culibs=1 tunes (cuDNN in the port)
    "xla_conv-3x3-s1": (2, 16, 7, 7, 20, 3, 1, 1, "xla_conv", True),
    "xla_conv-5x5-s2": (1, 6, 11, 9, 12, 5, 2, 2, "xla_conv", False),
}
# storage form -> (prec, io_layout, edge_prec)
FORMS = {"nchw": ("", "", ""), "nhwc-f32": ("", "nhwc", ""),
         "nhwc-bf16": ("bf16", "nhwc", "bf16")}


def _op(name, form):
    n, cin, h, w, cout, k, s, p, fn, relu = CONVS[name]
    op = make_conv_op(n, cin, h, w, cout, k, k, s, s, p, p, func_name=fn,
                      relu=relu)
    for key, v in zip(("prec", "io_layout", "edge_prec"), FORMS[form]):
        if v:
            op.str_vals[key] = v
    return op


def _inputs(name):
    n, cin, h, w, cout, k, *_ = CONVS[name]
    rng = np.random.RandomState(0)
    x = rng.randn(n, cin, h, w).astype(np.float32)
    wts = (rng.randn(cout, cin, k, k) / np.sqrt(cin * k * k)).astype(np.float32)
    b = rng.randn(cout).astype(np.float32) * 0.5
    return x, wts, b


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("name", list(CONVS))
def test_conv_template_matches_jax_and_ref(monkeypatch, name, form):
    monkeypatch.setenv("BODA_PALLAS_MODE", "fallback")
    op = _op(name, form)
    x, wts, b = _inputs(name)
    nhwc = FORMS[form][1] == "nhwc"
    bf16 = FORMS[form][2] == "bf16"
    xs = x.transpose(0, 2, 3, 1).copy() if nhwc else x
    if bf16:
        # bf16-exact weights: with a bf16 activation the JAX matmul keeps
        # an f32 weight as it is (sgemm.py:181-183), which the CPU then
        # multiplies in f32 while a TPU at DEFAULT precision and the port
        # round it to bf16; exact weights take that difference out
        wts = torch.from_numpy(wts).bfloat16().float().numpy()

    jt = jax_template(op.func_name)
    jx = jnp.asarray(xs).astype(jnp.bfloat16) if bf16 else xs
    want = np.asarray(jt.build(jt.check_args(op))(jx, wts, b), np.float32)

    pt = get_template(op.func_name)
    rfs = pt.check_args(_port_op(op))
    assert str(rfs) == str(jt.check_args(op))
    tx = torch.from_numpy(xs)
    out = pt.build(rfs)(tx.bfloat16() if bf16 else tx, torch.from_numpy(wts),
                        torch.from_numpy(b))
    assert out.dtype == (torch.bfloat16 if bf16 else torch.float32)
    got = out.float().numpy()
    assert got.shape == want.shape
    if bf16:
        assert mrd(got, want) <= 5e-3
        return
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    ref = pt.ref_impl(rfs, x, wts, b)
    np.testing.assert_allclose(got.transpose(0, 3, 1, 2) if nhwc else got,
                               ref, rtol=2e-5, atol=2e-5)


def test_conv_templates_without_bias(monkeypatch):
    monkeypatch.setenv("BODA_PALLAS_MODE", "fallback")
    n, cin, h, w, cout, k, s, p, fn, relu = CONVS["conv-3x3-s1"]
    op = make_conv_op(n, cin, h, w, cout, k, k, s, s, p, p, func_name=fn,
                      relu=relu, bias=False)
    x, wts, _ = _inputs("conv-3x3-s1")
    pt = get_template(fn)
    rfs = pt.check_args(_port_op(op))
    got = pt.build(rfs)(torch.from_numpy(x), torch.from_numpy(wts)).numpy()
    np.testing.assert_allclose(got, pt.ref_impl(rfs, x, wts), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("key", ["grad_q8"])
def test_xla_conv_refuses_the_int8_forms(key):
    # the forward int8 forms run on kernel B6 (tests/test_torch_qconv.py);
    # the int8 weight-gradient form is training and builds: its forward is
    # the float form's, bit for bit, and its gradients are the JAX
    # template's (mxu_conv's VJP; in the NCHW form the JAX template keeps
    # the bf16 VJP, NHWC storage takes the int8 weight gradient)
    import jax
    for form in ("nchw", "nhwc-bf16"):
        jop = _op("xla_conv-3x3-s1", form)
        jop.set_u32(key, 1)
        op = _port_op(jop)
        pt, jt = get_template("xla_conv"), jax_template("xla_conv")
        x, wts, b = _inputs("xla_conv-3x3-s1")
        nhwc = form != "nchw"
        if nhwc:
            x = torch.from_numpy(x).bfloat16().float().numpy() \
                .transpose(0, 2, 3, 1).copy()
        fn = pt.build(pt.check_args(op))
        plain = pt.build(pt.check_args(_port_op(_op("xla_conv-3x3-s1",
                                                    form))))
        xt = torch.from_numpy(x)
        xt = xt.bfloat16() if nhwc else xt
        wt = torch.from_numpy(wts).requires_grad_(True)
        y = fn(xt, wt, torch.from_numpy(b))
        assert torch.equal(y, plain(xt, torch.from_numpy(wts),
                                    torch.from_numpy(b)))
        c = np.cos(np.arange(y.numel(), dtype=np.float32)).reshape(y.shape)
        (gw,) = torch.autograd.grad((y.float() * torch.from_numpy(c)).sum(),
                                    wt)
        jx = jnp.asarray(x).astype(jnp.bfloat16) if nhwc else x
        jfn = jt.build(jt.check_args(jop))
        jgw = jax.grad(lambda w_: (jfn(jx, w_, b).astype(jnp.float32)
                                   * c).sum())(wts)
        assert mrd(gw.numpy(), np.asarray(jgw)) < 5e-3, form
