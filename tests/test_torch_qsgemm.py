"""sgemm_int8 (kernel B3) and the port's `sgemm_int8` template against the
JAX package: the plain PyTorch version (what a CPU tensor runs) vs the
Pallas SgemmInt8 body in interpret mode and its fallback, on the same
seeded inputs.

Tolerances: none against the Pallas body. Both quantize identically
(symmetric per tensor, round half to even), the int32 sum is exact and the
dequant is one f32 multiply by sa * sb, so the results are bit-equal.
Against ref_impl, which does the last multiply in f64, 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boda_tpu.core.dims import Dims
from boda_tpu.ops.cnn_variants import add_codegen_annotations, make_op_tune
from boda_tpu.ops.op_base import OpBase
from boda_tpu.ops.pallas import qsgemm as jqsgemm
from boda_tpu.ops.registry import get_template as jax_template
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.ops.op_base import OpBase as PortOpBase
from boda_tpu_torch.ops.cuda.qsgemm import K_MAX, int8_product, quantize, \
    quantize_operands, quantize_operands_plain, sgemm_int8, sgemm_int8_plain
from boda_tpu_torch.ops.registry import get_template


def _port_op(op):
    """The port's copy of a JAX op sig, through its lexp text."""
    return PortOpBase.from_lexp(str(op.to_lexp()))


SHAPES = {  # M, K, N, A all zero
    "64x32x48": (64, 32, 48, False),
    "77x50x33": (77, 50, 33, False),
    "1x3x1": (1, 3, 1, False),
    "zero-a-40x20x24": (40, 20, 24, True),
}


def _op(M, K, N):
    op = OpBase({"type": "sgemm"})  # no func_name: the tune picks it
    op.set_dims("a", Dims.make(M=M, K=K))
    op.set_dims("b", Dims.make(K=K, N=N))
    op.set_dims("c", Dims.make(M=M, N=N))
    add_codegen_annotations(op, make_op_tune("(prec=int8)"))
    return op


def _inputs(M, K, N, zero_a, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randn(M, K).astype(np.float32)
    b = rng.randn(K, N).astype(np.float32)
    return (np.zeros_like(a) if zero_a else a), b


def _qsym(v):
    """The Pallas template's qsym (qsgemm.py:55-59), on jnp."""
    amax = jnp.maximum(jnp.abs(v).max(), 1e-30)
    scale = amax / 127.0
    q = jnp.clip(jnp.round(v / scale), -127, 127).astype(jnp.int8)
    return q, scale.astype(jnp.float32)


@pytest.mark.parametrize("pallas_mode", ["interpret", "fallback"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_sgemm_int8_bit_equal_to_pallas(monkeypatch, pallas_mode, shape):
    M, K, N, zero_a = SHAPES[shape]
    op = _op(M, K, N)
    assert op.func_name == "sgemm_int8"
    a, b = _inputs(M, K, N, zero_a)
    monkeypatch.setenv("BODA_PALLAS_MODE", pallas_mode)
    jt = jax_template("sgemm_int8")
    want = np.asarray(jt.build(jt.check_args(op))(a, b))
    pt = get_template("sgemm_int8")
    got = pt.build(pt.check_args(_port_op(op)))(torch.from_numpy(a),
                                                torch.from_numpy(b)).numpy()
    assert got.dtype == np.float32 and got.shape == (M, N)
    np.testing.assert_array_equal(got, want)
    if zero_a:
        assert not got.any()


@pytest.mark.parametrize("shape", list(SHAPES))
def test_sgemm_int8_within_1e6_of_ref_impl(shape):
    M, K, N, zero_a = SHAPES[shape]
    a, b = _inputs(M, K, N, zero_a, seed=1)
    pt = get_template("sgemm_int8")
    ref = pt.ref_impl(pt.check_args(_port_op(_op(M, K, N))), a, b)
    got = sgemm_int8(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 37.5])
def test_quantize_is_qsym_exactly(scale):
    rng = np.random.RandomState(2)
    v = (rng.randn(33, 70) * scale).astype(np.float32)
    v[3, 5] = 0.5 * float(np.abs(v).max())  # lands on a rounding tie or near
    jq, js = _qsym(v)
    q, s = quantize(torch.from_numpy(v))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)


def _qsym_inputs(case):
    """a [9, 13], b [13, 6] for the quantize pass: all zero (amax clamped to
    1e-30), tiny (every |v| under 1e-30, so the clamp sets the scale),
    saturating (many values at +-amax, quantized to +-127, and values on a
    rounding tie just under them), or non-finite (a NaN in a, whose scale is
    then NaN, and an inf in b, whose scale is then inf)."""
    rng = np.random.RandomState(5)
    a = rng.randn(9, 13).astype(np.float32)
    b = rng.randn(13, 6).astype(np.float32)
    if case == "all-zero":
        a[:], b[:] = 0, 0
    elif case == "tiny":
        a *= np.float32(1e-31)
        b *= np.float32(3e-32)
    elif case == "non-finite":
        a[4, 6] = np.nan
        b[7, 2] = np.inf
    else:
        for v in (a, b):
            amax = np.abs(v).max()
            v[::3, ::2] = amax
            v[1::3, ::2] = -amax
            v[2::3, 1::2] = np.float32(amax * np.float32(126.5 / 127))
    return a, b


@pytest.mark.parametrize("case", ["all-zero", "tiny", "saturating",
                                  "non-finite"])
def test_quantize_operands_plain_is_pallas_qsym(case):
    """quantize_operands_plain (the card's yardstick for the quantize kernel)
    is bit-equal to the Pallas template's qsym, NaN for NaN, and the
    wrapper's CPU path returns it."""
    a, b = _qsym_inputs(case)
    ja, jsa = _qsym(a)
    jb, jsb = _qsym(b)
    qa, qb, s = quantize_operands_plain(torch.from_numpy(a),
                                        torch.from_numpy(b))
    np.testing.assert_array_equal(qa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(qb.numpy(), np.asarray(jb).T)
    assert s.shape == (1,) and s.dtype == torch.float32
    np.testing.assert_array_equal(s.numpy(),
                                  [np.float32(jsa) * np.float32(jsb)])
    if case == "saturating":
        assert np.abs(qa.numpy()).max() == 127 and (qa.numpy() == -127).any()
    if case == "all-zero":  # sa = sb = 1e-30 / 127, whose product is 0 in f32
        assert not qa.any() and quantize(torch.from_numpy(a))[1].item() > 0
    if case == "non-finite":  # NaN scales; NaN and inf / inf quantize to 0
        assert np.isnan(jsa) and np.isinf(jsb) and s.isnan().all()
        assert not qb.any() and qa[4, 6] == 0
    got = quantize_operands(torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got, (qa, qb, s)):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


def test_quantize_operands_transpose_b():
    rng = np.random.RandomState(3)
    a = torch.from_numpy(rng.randn(5, 7).astype(np.float32))
    b = torch.from_numpy(rng.randn(7, 3).astype(np.float32))
    qa, qb, s = quantize_operands(a, b)
    assert qa.shape == (5, 7) and qb.shape == (3, 7) and qb.is_contiguous()
    assert torch.equal(qb, quantize(b)[0].t())
    assert s.shape == (1,)
    assert s.item() == (quantize(a)[1] * quantize(b)[1]).item()


def test_prec_int8_selects_the_port_template():
    op = _op(8, 8, 8)
    pt = get_template(op.func_name)
    assert op.func_name == "sgemm_int8"
    assert pt is not jqsgemm.SgemmInt8 and pt.name == jqsgemm.SgemmInt8.name
    rfs = pt.check_args(_port_op(op))
    assert str(rfs) == str(jqsgemm.SgemmInt8.check_args(op))
    assert pt.flops(rfs) == 2 * 8 * 8 * 8


def test_sgemm_int8_refuses_k_over_the_int32_bound():
    assert K_MAX == 2 ** 31 // 127 ** 2
    # the largest sum at K_MAX still fits in int32
    assert K_MAX * 127 ** 2 < 2 ** 31 <= (K_MAX + 1) * 127 ** 2
    with pytest.raises(RtErr, match="could overflow the int32"):
        sgemm_int8(torch.ones(1, K_MAX + 1), torch.ones(K_MAX + 1, 1))
    with pytest.raises(RtErr, match="disagree on K"):
        sgemm_int8(torch.ones(2, 3), torch.ones(4, 2))
    with pytest.raises(RtErr, match="dtype"):
        sgemm_int8(torch.ones(2, 3).double(), torch.ones(3, 2).double())
    with pytest.raises(RtErr, match="no kernel for device 'meta'"):
        sgemm_int8(torch.ones(2, 3, device="meta"),
                   torch.ones(3, 2, device="meta"))


def test_sgemm_int8_plain_sums_exactly_at_ragged_k():
    # every product is 127 * +-127 and K is not a multiple of 4: the plain
    # version's integer sum is exact, then rounded once to f32
    K = 4099
    a = torch.ones(2, K)
    b = torch.ones(K, 3)
    b[:, 1] = -1.0
    qa, qb, s = quantize_operands(a, b)
    got = sgemm_int8_plain(a, b)
    want = torch.tensor([[K, -K, K]] * 2, dtype=torch.float64) * 127 * 127
    assert torch.equal(got, want.float() * s)
    pt = get_template("sgemm_int8")
    ref = pt.ref_impl(pt.check_args(_port_op(_op(2, K, 3))), a.numpy(),
                      b.numpy())
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)


def test_int8_product_is_the_wrappers_second_half():
    a, b = _inputs(9, 21, 5, False, seed=4)
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    q = quantize_operands(a, b)
    assert torch.equal(int8_product(*q), sgemm_int8(a, b))
    qa, qb, s = q
    with pytest.raises(RtErr, match="dtype torch.float32 not in"):
        int8_product(qa.float(), qb, s)
    with pytest.raises(RtErr, match=r"operands \(9, 21\), \(5, 20\)"):
        int8_product(qa, qb[:, :20].contiguous(), s)
    with pytest.raises(RtErr, match="scale"):
        int8_product(qa, qb, s.reshape(()))


def test_plain_version_does_not_count_a_launch():
    n0 = sgemm_int8.launches
    sgemm_int8(torch.ones(2, 3), torch.ones(3, 4))
    assert sgemm_int8.launches == n0
