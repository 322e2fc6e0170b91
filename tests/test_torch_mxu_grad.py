"""The port's mixed-precision conv VJP (ops/mxu_grad.MxuConv), its
output-mask ReLU, the int8 weight gradient (ops/cuda/qconv.wgrad_q8 on
kernel B6, here its plain version), the pool backward and the guard of the
inference-only templates, against the JAX package on the CPU.

The JAX side runs as tests/test_mxu_grad.py and tests/test_pool_grad.py
run it (XLA on the CPU). Tolerances: the primal bit-equal to the port's
forward without autograd (vendor_conv's arithmetic) and within f32 summing
order (mrd 1e-5) of the JAX primal; dx and dW within mrd 5e-3 of the JAX
bf16 VJP's (one bf16 rounding each); the int8 weight gradient bit-equal
in f32 before its rounding; the pool VJPs exact or at f32 add order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boda_tpu.core.dims import Dims as JDims
from boda_tpu.graph.support import Pt, pool_in_sz_to_out_sz
from boda_tpu.ops.mxu_grad import _wgrad_q8 as jwgrad_q8
from boda_tpu.ops.mxu_grad import mxu_conv as jmxu_conv
from boda_tpu.ops.op_base import OpBase as JOpBase
from boda_tpu.ops.registry import get_template as jget_template
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.engine.lower import lower_pipe
from boda_tpu_torch.engine.torch_fwd import build_forward, weights_to_torch
from boda_tpu_torch.models.zoo import build_model
from boda_tpu_torch.ops import mxu_grad
from boda_tpu_torch.ops.cnn_variants import make_op_tune
from boda_tpu_torch.ops.cuda import qconv as qmod
from boda_tpu_torch.ops.cuda.qconv import qconv_plain, wgrad_q8, \
    wgrad_q8_plain
from boda_tpu_torch.ops.mxu_grad import mxu_conv, relu_store
from boda_tpu_torch.ops.op_base import OpBase
from boda_tpu_torch.ops.registry import get_template

BF16 = torch.bfloat16
CPU = torch.device("cpu")


def _mrd(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


# tests/test_mxu_grad.py's CASES: (N, H, W, C, O, k, s, p, lhs_dil)
CASES = [
    (2, 8, 8, 8, 16, 3, 1, 1, None),
    (2, 9, 9, 4, 8, 3, 2, 1, None),
    (1, 16, 16, 3, 16, 7, 2, 3, None),   # resnet stem shape class
    (2, 8, 8, 8, 8, 1, 1, 0, None),      # 1x1
    (2, 5, 5, 4, 6, 3, 1, 2, (2, 2)),    # deconv-style lhs dilation
]


def _port_conv(case, x, w, q8=False):
    """The port's conv of case on NHWC x and HWIO w (numpy): an NHWC result
    and the tensors to differentiate. The lhs-dilated form is the
    transposed conv (stride = the dilation, pad k-1-p) of the flipped
    filter, (in, out, ky, kx), as the port's deconv runs it."""
    n, h, w_, c, o, k, s, p, ld = case
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    if ld:
        wt = torch.from_numpy(np.ascontiguousarray(
            w[::-1, ::-1].transpose(2, 3, 0, 1))).requires_grad_(True)
        y = mxu_conv(xt, wt, ld, (k - 1 - p,) * 2, BF16, transposed=True)
    else:
        wt = torch.from_numpy(np.ascontiguousarray(
            w.transpose(3, 2, 0, 1))).requires_grad_(True)
        y = mxu_conv(xt, wt, (s, s), (p, p), BF16, q8=q8)
    return y.permute(0, 2, 3, 1), xt, wt


def _port_w_grad(case, gw):
    """A port filter gradient back in the JAX case's HWIO layout."""
    if case[-1]:
        return gw.numpy().transpose(2, 3, 0, 1)[::-1, ::-1]
    return gw.numpy().transpose(2, 3, 1, 0)


def _jax_kw(case):
    n, h, w_, c, o, k, s, p, ld = case
    kw = dict(window_strides=(s, s), padding=((p, p), (p, p)),
              dimension_numbers=("NHWC", "HWIO", "NHWC"))
    if ld:
        kw["lhs_dilation"] = ld
    return kw


@pytest.mark.parametrize("case", CASES)
def test_mxu_conv_matches_jax(case):
    n, h, w_, c, o, k, s, p, ld = case
    rng = np.random.RandomState(0)
    x = rng.randn(n, h, w_, c).astype(np.float32)
    w = rng.randn(k, k, c, o).astype(np.float32) * 0.1
    kw = _jax_kw(case)
    y, xt, wt = _port_conv(case, x, w)
    ct = np.cos(np.arange(y.numel(), dtype=np.float32)).reshape(y.shape)
    gx, gw = torch.autograd.grad((y * torch.from_numpy(ct)).sum(), (xt, wt))
    # the primal under autograd is the forward without it, bit for bit
    with torch.no_grad():
        y0 = _port_conv(case, x, w)[0]
    assert torch.equal(y.detach(), y0)
    jy = jmxu_conv(x, w, compute_dtype=jnp.bfloat16, **kw)
    assert _mrd(y.detach().numpy(), jy) < 1e-5

    def loss(xx, ww):
        return (jmxu_conv(xx, ww, compute_dtype=jnp.bfloat16, **kw)
                * ct).sum()
    jgx, jgw = jax.grad(loss, argnums=(0, 1))(x, w)
    assert gx.dtype == gw.dtype == torch.float32
    assert _mrd(gx.permute(0, 2, 3, 1).numpy(), jgx) < 5e-3
    assert _mrd(_port_w_grad(case, gw), jgw) < 5e-3


def test_mxu_conv_saves_the_rounded_operands():
    # the residuals are the bf16 operands: a bf16 input is saved as is, an
    # f32 filter as its bf16 rounding (half its bytes), no f32 copies
    x = torch.randn(2, 4, 6, 6).bfloat16().requires_grad_(True)
    w = torch.randn(8, 4, 3, 3, requires_grad=True)
    y = mxu_conv(x, w, (1, 1), (1, 1), BF16)
    xc, wc = y.grad_fn.saved_tensors
    assert xc.dtype == wc.dtype == BF16
    assert xc.data_ptr() == x.data_ptr()
    assert torch.equal(wc, w.detach().bfloat16())


def test_conv_backward_plain_rounds_once():
    # dx and dW are the FP32 grad convs of the rounded values, rounded once
    rng = np.random.RandomState(1)
    xc = torch.from_numpy(rng.randn(2, 4, 7, 7).astype(np.float32)).bfloat16()
    wc = torch.from_numpy(rng.randn(6, 4, 3, 3).astype(np.float32)).bfloat16()
    gc = torch.from_numpy(rng.randn(2, 6, 7, 7).astype(np.float32)).bfloat16()
    dx, dw = mxu_grad.conv_backward_plain(gc, xc, wc, (1, 1), (1, 1), False,
                                          (True, True))
    assert dx.dtype == dw.dtype == BF16
    rdx = torch.nn.grad.conv2d_input(xc.shape, wc.double(), gc.double(),
                                     padding=1)
    rdw = torch.nn.grad.conv2d_weight(xc.double(), wc.shape, gc.double(),
                                      padding=1)
    assert _mrd(dx.float(), rdx) < 2 ** -8
    assert _mrd(dw.float(), rdw) < 2 ** -8
    # on the CPU the dispatch takes the plain form
    assert all(torch.equal(a, b) for a, b in zip(
        (dx, dw), mxu_grad.conv_backward(gc, xc, wc, (1, 1), (1, 1), False,
                                         (True, True))))


def test_relu_store_keeps_the_output():
    y = torch.tensor([-1.5, -0.0, 0.0, 1e-3, 2.5, 3.0001],
                     requires_grad=True)
    out = relu_store(y, BF16)
    assert torch.equal(out, torch.relu(y.detach()).to(BF16))
    (saved,) = out.grad_fn.saved_tensors
    assert saved.dtype == BF16 and torch.equal(saved, out)
    g = torch.arange(1.0, 7.0).bfloat16()
    (gy,) = torch.autograd.grad(out, y, g)
    assert gy.dtype == torch.float32
    assert gy.tolist() == [0.0, 0.0, 0.0, 4.0, 5.0, 6.0]
    with torch.no_grad():
        assert relu_store(y, BF16).grad_fn is None


# tests/test_mxu_grad.py's WGRAD_Q8_CASES: (N, H, W, I, O, k, s, p)
WGRAD_Q8_CASES = [
    (2, 10, 10, 8, 16, 3, 1, 1),
    (2, 11, 13, 8, 16, 3, 2, 1),
    (2, 14, 14, 8, 16, 1, 2, 0),
    (1, 9, 9, 4, 8, 5, 2, 2),
    (2, 8, 8, 8, 8, 1, 1, 0),
]


@pytest.mark.parametrize("data", ["integer", "float"])
@pytest.mark.parametrize("case", WGRAD_Q8_CASES)
def test_wgrad_q8_bit_equal_to_jax(case, data):
    n, h, w_, i, o, k, s, p = case
    rng = np.random.RandomState(0)
    oy, ox = (h + 2 * p - k) // s + 1, (w_ + 2 * p - k) // s + 1
    if data == "integer":
        x = rng.randint(-7, 8, (n, h, w_, i)).astype(np.float32)
        c = rng.randint(-3, 4, (n, oy, ox, o)).astype(np.float32)
    else:
        x = rng.randn(n, h, w_, i).astype(np.float32)
        c = rng.randn(n, oy, ox, o).astype(np.float32) * 1e-2
    xb = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    wh = np.zeros((k, k, i, o), np.float32)
    want = np.asarray(jwgrad_q8(jnp.asarray(xb).astype(jnp.bfloat16),
                                jnp.asarray(wh), jnp.asarray(c), (s, s),
                                ((p, p), (p, p))))
    xt = torch.from_numpy(xb).bfloat16()
    wt = torch.zeros(o, i, k, k)
    got = wgrad_q8_plain(xt, wt, torch.from_numpy(c), (s, s), (p, p))
    assert got.shape == (o, i, k, k) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().transpose(2, 3, 1, 0), want)
    # the wrapper takes its plain version for CPU tensors
    assert torch.equal(wgrad_q8(xt, wt, torch.from_numpy(c), (s, s),
                                (p, p)), got)


@pytest.mark.parametrize("case", WGRAD_Q8_CASES)
def test_q8_vjp_matches_jax_and_keeps_bf16_dx(case):
    # the q8 VJP: dx is the bf16 VJP's bit for bit, dW the JAX package's
    # int8 weight gradient (within one bf16 rounding)
    n, h, w_, i, o, k, s, p = case
    rng = np.random.RandomState(0)
    x = rng.randint(-7, 8, (n, h, w_, i)).astype(np.float32)
    w = rng.randint(-7, 8, (k, k, i, o)).astype(np.float32)
    full = (n, h, w_, i, o, k, s, p, None)
    y, xt, wt = _port_conv(full, x, w, q8=True)
    c = rng.randint(-3, 4, tuple(y.shape)).astype(np.float32)
    gx, gw = torch.autograd.grad((y * torch.from_numpy(c)).sum(), (xt, wt))
    y2, xt2, wt2 = _port_conv(full, x, w)
    gx2, gw2 = torch.autograd.grad((y2 * torch.from_numpy(c)).sum(),
                                   (xt2, wt2))
    assert torch.equal(gx, gx2)

    def loss(xx, ww):
        return (jmxu_conv(xx, ww, window_strides=(s, s),
                          padding=((p, p), (p, p)),
                          dimension_numbers=("NHWC", "HWIO", "NHWC"),
                          wgrad_int8=True) * c).sum()
    jgx, jgw = jax.grad(loss, argnums=(0, 1))(x, w)
    assert _mrd(_port_w_grad(full, gw), jgw) <= 2 ** -8
    assert _mrd(gx.permute(0, 2, 3, 1).numpy(), jgx) <= 2 ** -8


def test_q8_overflow_guard_keeps_the_bf16_vjp(monkeypatch):
    # N*OH*OW*127^2 >= 2^31: the int32 sums could wrap, so the weight
    # gradient stays bf16 and B6 is not called (mxu_grad.py:143-150)
    assert mxu_grad.q8_fits(1, 364, 365) and not mxu_grad.q8_fits(1, 365,
                                                                   365)
    calls = []
    monkeypatch.setattr(qmod, "wgrad_q8",
                        lambda *a: calls.append(a) or wgrad_q8_plain(*a))
    x = torch.randn(1, 1, 365, 365).requires_grad_(True)
    w = torch.randn(2, 1, 1, 1, requires_grad=True)
    for q8 in (True, False):
        y = mxu_conv(x, w, (1, 1), (0, 0), BF16, q8=q8)
        gw = torch.autograd.grad(y.sum(), w)[0]
        if q8:
            g_q8 = gw
    assert not calls and torch.equal(g_q8, gw)
    y = mxu_conv(x[..., :364, :], w, (1, 1), (0, 0), BF16, q8=True)
    torch.autograd.grad(y.sum(), w)
    assert len(calls) == 1


# strided sites whose N*OH*OW sums fit int32 but whose cotangent dilated by
# the stride (the JAX _wgrad_q8's contraction) would not: a 1x1/s2 like
# res3a_branch1 and a 3x3/s2, b32 at a 56x56 output (N*OH*OW = 100352 <=
# K_MAX < N*(2*OH-1)^2 = 394272); the port runs one B6 conv per phase
STRIDED_Q8_CASES = [
    (32, 112, 112, 2, 4, 1, 2, 0),
    (32, 111, 111, 2, 4, 3, 2, 1),
]


@pytest.mark.parametrize("case", STRIDED_Q8_CASES)
def test_wgrad_q8_strided_site_beyond_the_dilated_k_bound(case, monkeypatch):
    n, h, w_, i, o, k, s, p = case
    oy = (h + 2 * p - k) // s + 1
    assert mxu_grad.q8_fits(n, oy, oy) \
        and n * ((oy - 1) * s + 1) ** 2 > qmod.K_MAX
    rng = np.random.RandomState(0)
    x = rng.randn(n, h, w_, i).astype(np.float32)
    c = rng.randn(n, oy, oy, o).astype(np.float32) * 1e-2
    xb = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(jwgrad_q8(jnp.asarray(xb).astype(jnp.bfloat16),
                                jnp.zeros((k, k, i, o)), jnp.asarray(c),
                                (s, s), ((p, p), (p, p))))
    convs = []
    monkeypatch.setattr(qmod, "qconv_plain", lambda *a: convs.append(a[1])
                        or qconv_plain(*a))
    xt = torch.from_numpy(xb).bfloat16()
    got = wgrad_q8_plain(xt, torch.zeros(o, i, k, k), torch.from_numpy(c),
                         (s, s), (p, p))
    np.testing.assert_array_equal(got.numpy().transpose(2, 3, 1, 0), want)
    # one launch per phase holding a tap, each summing N*OH*OW terms
    assert len(convs) == qmod.wgrad_q8_launches((s, s), (k, k)) \
        and all(wq.shape[1:3] == (oy, oy) for wq in convs)
    # the q8 VJP at the site: B6 for dW (no K-bound error), bf16 dx
    xg = xt.permute(0, 3, 1, 2).requires_grad_(True)
    wg = torch.zeros(o, i, k, k, requires_grad=True)
    y = mxu_conv(xg, wg, (s, s), (p, p), BF16, q8=True)
    gw = torch.autograd.grad((y * torch.from_numpy(c).permute(0, 3, 1, 2))
                             .sum(), wg)[0]
    assert torch.equal(gw, got.to(BF16).float())


# ------------------------------------------------------------ the pool VJPs

# tests/test_pool_grad.py's GEOMS: (h, w, ky, kx, sy, sx, py, px)
GEOMS = [
    (12, 12, 3, 3, 2, 2, 0, 0),
    (9, 9, 3, 3, 1, 1, 1, 1),
    (8, 8, 2, 2, 2, 2, 0, 0),
    (10, 8, 3, 2, 2, 2, 1, 0),
]


def _pool_op(n, c, h, w, ky, kx, sy, sx, py, px, avg=False, io_layout="",
             pool_bwd=""):
    out = pool_in_sz_to_out_sz(Pt(w, h), Pt(px, py), Pt(sx, sy), Pt(kx, ky))
    op = JOpBase({"type": "Pooling", "func_name": "pool"})
    op.set_dims("in", JDims.make(img=n, chan=c, y=h, x=w))
    op.set_dims("out", JDims.make(img=n, chan=c, y=out.y, x=out.x))
    op.set_null_dims("kern_sz", y=ky, x=kx)
    op.set_null_dims("stride", y=sy, x=sx)
    op.set_null_dims("in_pad", y=py, x=px)
    if avg:
        op.str_vals["avg_pool"] = "1"
    if io_layout:
        op.str_vals["io_layout"] = io_layout
    if pool_bwd:
        op.str_vals["pool_bwd"] = pool_bwd
    return op


def _both(op):
    jt, pt = jget_template("pool"), get_template("pool")
    pop = OpBase.from_lexp(str(op.to_lexp()))
    return jt.build(jt.check_args(op)), pt.build(pt.check_args(pop))


def _port_grad(fn, x, ct):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = fn(xt)
    return torch.autograd.grad((y * torch.from_numpy(ct)).sum(), xt)[0] \
        .numpy(), y.detach().numpy()


def np_first_argmax_pool_bwd(x, g, ky, kx, sy, sx, py, px):
    """Independent reference: each window sends its cotangent to its FIRST
    maximum in row-major window order; out-of-bounds positions never win
    (tests/test_pool_grad.py's reference)."""
    n, c, H, W = x.shape
    oy, ox = g.shape[2], g.shape[3]
    gx = np.zeros_like(x, dtype=np.float64)
    for yy in range(oy):
        for xx in range(ox):
            y0, x0 = yy * sy - py, xx * sx - px
            best = -np.inf * np.ones((n, c))
            bq = np.zeros((n, c, 2), np.int64)
            found = np.zeros((n, c), bool)
            for dy in range(ky):
                for dx in range(kx):
                    q = (y0 + dy, x0 + dx)
                    if not (0 <= q[0] < H and 0 <= q[1] < W):
                        continue
                    v = x[:, :, q[0], q[1]]
                    take = v > best
                    best = np.where(take, v, best)
                    bq[..., 0] = np.where(take, q[0], bq[..., 0])
                    bq[..., 1] = np.where(take, q[1], bq[..., 1])
                    found |= take
            for i in range(n):
                for j in range(c):
                    if found[i, j]:
                        gx[i, j, bq[i, j, 0], bq[i, j, 1]] += g[i, j, yy, xx]
    return gx


# the port has one max-pool backward; pool_bwd=gather selects the JAX
# package's gather-form VJP, which it must equal as well
@pytest.mark.parametrize("pool_bwd", ["", "gather"])
@pytest.mark.parametrize("io_layout", ["", "nhwc"])
@pytest.mark.parametrize("geom", GEOMS)
def test_max_pool_grad_matches_jax(geom, io_layout, pool_bwd):
    h, w, ky, kx, sy, sx, py, px = geom
    n, c = 2, 8
    op = _pool_op(n, c, h, w, ky, kx, sy, sx, py, px, io_layout=io_layout,
                  pool_bwd=pool_bwd)
    jfn, pfn = _both(op)
    oy, ox = op.get_dims("out")["y"], op.get_dims("out")["x"]
    nhwc = io_layout == "nhwc"
    rng = np.random.RandomState(0)
    x = rng.randn(*((n, h, w, c) if nhwc else (n, c, h, w))) \
        .astype(np.float32)  # continuous: ties measure-0
    ct = rng.randn(*((n, oy, ox, c) if nhwc else (n, c, oy, ox))) \
        .astype(np.float32)
    got, y = _port_grad(pfn, x, ct)
    want = jax.grad(lambda xv: jnp.sum(jfn(xv) * ct))(x)
    np.testing.assert_array_equal(y, np.asarray(jfn(x)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("geom", GEOMS)
def test_max_pool_grad_tie_heavy_first_argmax(geom):
    h, w, ky, kx, sy, sx, py, px = geom
    n, c = 2, 4
    op = _pool_op(n, c, h, w, ky, kx, sy, sx, py, px)
    _jfn, pfn = _both(op)
    rng = np.random.RandomState(1)
    # post-relu-like: many exact zeros and a few levels, tied maxima
    x = np.maximum(rng.randint(-2, 3, size=(n, c, h, w)), 0) \
        .astype(np.float32) * 0.5
    oy, ox = op.get_dims("out")["y"], op.get_dims("out")["x"]
    ct = rng.randn(n, c, oy, ox).astype(np.float32)
    got, _ = _port_grad(pfn, x, ct)
    want = np_first_argmax_pool_bwd(x, ct, ky, kx, sy, sx, py, px)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_bf16_nhwc_max_pool_ties_first_argmax():
    # the storage form under prec=bf16: ties are common in bf16 edges
    h, w, ky, kx, sy, sx, py, px = GEOMS[0]
    op = _pool_op(2, 4, h, w, ky, kx, sy, sx, py, px, io_layout="nhwc")
    _jfn, pfn = _both(op)
    rng = np.random.RandomState(5)
    x = (np.maximum(rng.randint(-2, 3, size=(2, h, w, 4)), 0) * 0.5) \
        .astype(np.float32)
    oy, ox = op.get_dims("out")["y"], op.get_dims("out")["x"]
    ct = rng.randn(2, oy, ox, 4).astype(np.float32)
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    y = pfn(xt)
    (g,) = torch.autograd.grad((y.float() * torch.from_numpy(ct)).sum(), xt)
    want = np_first_argmax_pool_bwd(x.transpose(0, 3, 1, 2),
                                    ct.transpose(0, 3, 1, 2), ky, kx, sy, sx,
                                    py, px)
    np.testing.assert_allclose(g.float().numpy().transpose(0, 3, 1, 2),
                               want, rtol=1e-2, atol=1e-2)


def test_global_max_pool_and_avg_pool_grads():
    _jfn, pfn = _both(_pool_op(1, 4, 10, 10, 10, 10, 1, 1, 0, 0))
    x = np.random.RandomState(2).randn(1, 4, 10, 10).astype(np.float32)
    g, _ = _port_grad(pfn, x, np.ones((1, 4, 1, 1), np.float32))
    assert g.sum() == pytest.approx(4.0)  # one winner per channel
    jfn, pfn = _both(_pool_op(2, 4, 8, 8, 2, 2, 2, 2, 0, 0, avg=True))
    x = np.random.RandomState(3).randn(2, 4, 8, 8).astype(np.float32)
    g, _ = _port_grad(pfn, x, np.ones((2, 4, 4, 4), np.float32))
    np.testing.assert_allclose(g, np.full_like(x, 0.25))


# ------------------------------------------------------- the training guard

GUARDED = [
    ("()", "mini", {"k1conv", "conv"}),
    ("(fuse_stem=1,fuse_resblock=1)", "resnet-50", {"fused_stem",
                                                    "resblock"}),
    ("(prec=bf16,layout=nhwc)", "resnet-50", {"tconv", "ipconv"}),
    ("(use_culibs=1,prec=bf16,layout=nhwc,quant8=1)", "mini", {"xla_conv"}),
]


@pytest.mark.parametrize("tune,model,templates", GUARDED)
def test_training_through_an_inference_only_template_raises(tune, model,
                                                            templates):
    # no template without a backward in the JAX package runs under
    # autograd: the forward raises at its first such step, naming it, and
    # each step of those templates is one step_has_backward refuses
    pipe = build_model(model, batch=1, ysz=64, xsz=64) \
        if model == "resnet-50" else build_model(model, batch=1)
    plan = lower_pipe(pipe, make_op_tune(tune), fused_storage=True)
    refused = {s.func_name for s in plan.steps
               if not mxu_grad.step_has_backward(s.sig)}
    assert templates <= refused
    first = next(s for s in plan.steps
                 if not mxu_grad.step_has_backward(s.sig))
    fwd = build_forward(plan, CPU)
    w = {k: v.requires_grad_(v.is_floating_point())
         for k, v in weights_to_torch(plan, pipe.op_params, CPU).items()}
    d = pipe.get_data_img_dims()
    x = torch.zeros(tuple(d.shape))
    with pytest.raises(RtErr, match=f"step {first.call_tag} runs template "
                                    f"'{first.func_name}'.*no backward"):
        fwd({"data": x}, w)
    with pytest.raises(RtErr, match="no backward"):
        mxu_grad.check_trainable(plan.steps, "cnet_train")
    with torch.no_grad():  # inference through the same plan is untouched
        fwd({"data": x}, w)


@pytest.mark.parametrize("name", ["matmul_ext", "tconv", "sgemm_int8",
                                  "qconv"])
def test_kernel_wrappers_refuse_autograd(name):
    # the wrappers' own guard, for a call outside any plan
    from boda_tpu_torch.ops.cuda.qsgemm import sgemm_int8
    from boda_tpu_torch.ops.cuda.sgemm import matmul_ext
    from boda_tpu_torch.ops.cuda.tconv import tconv
    a = torch.randn(4, 8, requires_grad=True)
    calls = {"matmul_ext": lambda: matmul_ext(a, torch.randn(3, 8)),
             "sgemm_int8": lambda: sgemm_int8(a, torch.randn(8, 3)),
             "tconv": lambda: tconv(torch.randn(1, 5, 5, 8).requires_grad_(),
                                    torch.randn(4, 3, 3, 8)),
             "qconv": lambda: qmod.qconv(
                 torch.zeros(1, 4, 4, 16, dtype=torch.int8),
                 torch.zeros(2, 1, 1, 16, dtype=torch.int8), torch.ones(1),
                 torch.ones(2, requires_grad=True))}
    with pytest.raises(RtErr, match=f"{name}: an inference-only kernel"):
        calls[name]()
    with torch.no_grad():
        calls[name]()


def test_sgemm_template_refuses_autograd():
    # the hand sgemm template (B1) runs matmul_ext: its guard names it
    from boda_tpu.ops.op_base import read_op_sigs as jread_op_sigs
    from pathlib import Path
    op = jread_op_sigs(Path(__file__).parent / "data" / "ops"
                       / "sgemm-tiny.txt")[0]
    pop = OpBase.from_lexp(str(op.to_lexp()))
    pop.set_func_name("sgemm")
    pt = get_template("sgemm")
    rfs = pt.check_args(pop)
    a, b = (torch.randn(*rfs.get_dims(n).shape, requires_grad=True)
            for n in ("a", "b"))
    assert not mxu_grad.step_has_backward(pop)
    with pytest.raises(RtErr, match="matmul_ext: an inference-only kernel"):
        pt.build(rfs)(a, b)
