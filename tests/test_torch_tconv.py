"""tconv (kernel B2) and the port's `tconv` template against the JAX
package's Pallas build_tconv body in interpret mode, on the same seeded
inputs: the cases of tests/test_tconv.py plus C=128 with bias in bf16, in
the NCHW form and the NHWC bf16-edge storage form.

The Pallas kernel adds the bias rounded to the compute dtype
(tconv.py:199), unlike build_matmul_ext, which keeps it in f32; the port
reproduces each, so under prec=bf16 both add a bf16-rounded bias here.

Tolerances: f32 rtol = atol = 2e-5; bf16 mrd <= 5e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boda_tpu.core.dims import Dims
from boda_tpu.core.error import RtErr
from boda_tpu.ops.pallas import tconv as jtconv
from boda_tpu.ops.pallas.conv import make_conv_op
from boda_tpu.ops.registry import get_template as jax_template
from boda_tpu.testing.comp import mrd
from boda_tpu_torch.ops.cuda.tconv import tconv
from boda_tpu_torch.ops.registry import get_template

CASES = {
    # tests/test_tconv.py:36-53
    "c8-3x3": dict(n=1, cin=8, h=10, w=10, cout=16, k=3, pad=1, relu=False,
                   bias=False),
    "c16-3x3-relu-bias": dict(n=2, cin=16, h=9, w=9, cout=32, k=3, pad=1,
                              relu=True, bias=True),
    "c4-5x5": dict(n=1, cin=4, h=12, w=8, cout=8, k=5, pad=2, relu=False,
                   bias=True),
    "c8-1x1": dict(n=1, cin=8, h=7, w=7, cout=8, k=1, pad=0, relu=True,
                   bias=False),
    "ty-tiling": dict(n=1, cin=8, h=10, w=10, cout=16, k=3, pad=1,
                      relu=False, bias=True, work=dict(Mb=4, Nb=128)),
    # the ResNet form: C=128 3x3 pad 1, with bias, bf16 operands
    "c128-bf16": dict(n=1, cin=128, h=6, w=6, cout=128, k=3, pad=1,
                      relu=True, bias=True, prec="bf16"),
    "c128-bf16-nhwc-storage": dict(n=1, cin=128, h=6, w=6, cout=128, k=3,
                                   pad=1, relu=True, bias=True, prec="bf16",
                                   storage=True),
}


def _case(c):
    op = make_conv_op(c["n"], c["cin"], c["h"], c["w"], c["cout"], c["k"],
                      c["k"], 1, 1, c["pad"], c["pad"], func_name="tconv",
                      relu=c["relu"], bias=c["bias"])
    if c.get("prec"):
        op.str_vals["prec"] = c["prec"]
    if c.get("storage"):
        op.str_vals["io_layout"] = "nhwc"
        op.str_vals["edge_prec"] = "bf16"
    if c.get("work"):
        op.set_dims("work", Dims.make(tn="none", **c["work"]))
    rng = np.random.RandomState(0)
    x = rng.randn(c["n"], c["cin"], c["h"], c["w"]).astype(np.float32) * 0.3
    w = rng.randn(c["cout"], c["cin"], c["k"], c["k"]).astype(np.float32) * 0.3
    args = [x, w]
    if c["bias"]:
        args.append(rng.randn(c["cout"]).astype(np.float32))
    return op, args


@pytest.mark.parametrize("name", list(CASES))
def test_tconv_template_matches_pallas_interpret(monkeypatch, name):
    monkeypatch.setenv("BODA_PALLAS_MODE", "interpret")
    c = CASES[name]
    op, args = _case(c)
    storage = c.get("storage", False)
    if storage:
        args[0] = args[0].transpose(0, 2, 3, 1).copy()
    jt = jax_template("tconv")
    jargs = [jnp.asarray(args[0]).astype(jnp.bfloat16)] + args[1:] \
        if storage else args
    want = np.asarray(jt.build(jt.check_args(op))(*jargs), np.float32)

    pt = get_template("tconv")
    assert issubclass(pt, jtconv.TConv)
    rfs = pt.check_args(op)
    targs = [torch.from_numpy(a) for a in args]
    if storage:
        targs[0] = targs[0].bfloat16()
    out = pt.build(rfs)(*targs)
    assert out.dtype == (torch.bfloat16 if storage else torch.float32)
    got = out.float().numpy()
    assert got.shape == want.shape
    if c.get("prec") == "bf16":
        assert mrd(got, want) <= 5e-3
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, pt.ref_impl(rfs, *args), rtol=2e-5,
                                   atol=2e-5)


def test_tconv_wrapper_nhwc_against_ref():
    # the wrapper's own interface: NHWC x, OIHW w, f32 bias, NHWC out
    op, (x, w, b) = _case(CASES["c16-3x3-relu-bias"])
    ref = jax_template("tconv").ref_impl(op, x, w, b)
    got = tconv(torch.from_numpy(x.transpose(0, 2, 3, 1).copy()),
                torch.from_numpy(w), torch.from_numpy(b), (1, 1), True)
    np.testing.assert_allclose(got.numpy().transpose(0, 3, 1, 2), ref,
                               rtol=2e-5, atol=2e-5)


def test_tconv_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 5, 5, 8)
    w = torch.zeros(4, 8, 3, 3)
    with pytest.raises(RtErr, match="channels"):
        tconv(x, torch.zeros(4, 6, 3, 3))
    with pytest.raises(RtErr, match="contiguous"):
        tconv(torch.zeros(1, 8, 5, 5).permute(0, 2, 3, 1), w)
    with pytest.raises(RtErr, match="but w is"):
        tconv(x, w.bfloat16())
    with pytest.raises(RtErr, match="empty output"):
        tconv(torch.zeros(1, 2, 2, 8), w)
    with pytest.raises(RtErr, match="bias length"):
        tconv(x, w, torch.zeros(3), (1, 1))
    with pytest.raises(RtErr, match="no kernel for device 'meta'"):
        tconv(x.to("meta"), w.to("meta"), pad=(1, 1))
