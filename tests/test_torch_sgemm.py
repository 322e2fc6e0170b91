"""matmul_ext (kernel B1) and the port's `sgemm` template against the JAX
package: the plain PyTorch version (what a CPU tensor runs) vs the Pallas
build_matmul_ext body in interpret mode, on the same seeded inputs.

Tolerances: f32 rtol = atol = 2e-5 (different summation orders of full-f32
products); bf16 operands mrd <= 5e-3, the repo's bf16 mrd_toler.
"""

import numpy as np
import pytest
import torch

from boda_tpu.ops.pallas.sgemm import build_matmul_ext, make_sgemm_op
from boda_tpu.ops.registry import get_template as jax_template
from boda_tpu.ops.tile import solve_matmul_tiles
from boda_tpu.testing.comp import mrd
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.ops.op_base import OpBase as PortOpBase
from boda_tpu_torch.ops.cuda.sgemm import matmul_ext
from boda_tpu_torch.ops.registry import get_template


def _port_op(op):
    """The port's copy of a JAX op sig, through its lexp text."""
    return PortOpBase.from_lexp(str(op.to_lexp()))


CASES = [
    # M, K, N, bias, relu, in dtype, out dtype: ragged M/N/K, M=1
    (1, 37, 19, True, True, "float32", "float32"),
    (70, 130, 65, False, True, "float32", "float32"),
    (33, 16, 8, False, False, "float32", "float32"),
    (45, 200, 130, True, False, "bfloat16", "float32"),
    (1, 64, 100, True, True, "bfloat16", "bfloat16"),
    (96, 72, 40, False, True, "bfloat16", "bfloat16"),
]


def _inputs(M, K, N, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randn(M, K).astype(np.float32)
    b = (rng.randn(K, N) / np.sqrt(K)).astype(np.float32)
    bias = rng.randn(N).astype(np.float32)
    return a, b, bias


def _close(got, want, in_dt):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if in_dt == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        assert mrd(got, want) <= 5e-3


@pytest.mark.parametrize("case", CASES, ids=[
    f"M{c[0]}K{c[1]}N{c[2]}{'-bias' if c[3] else ''}{'-relu' if c[4] else ''}"
    f"-{c[5]}-{c[6]}" for c in CASES])
def test_matmul_ext_matches_pallas_interpret(monkeypatch, case):
    M, K, N, bias, relu, in_dt, out_dt = case
    monkeypatch.setenv("BODA_PALLAS_MODE", "interpret")
    a, b, bv = _inputs(M, K, N)
    tiles = solve_matmul_tiles(M, N, K, in_dt)
    jfn = build_matmul_ext(M, N, K, tiles, in_dtype=in_dt, out_dtype=out_dt,
                           relu=relu, bias=bias)
    want = jfn(a, b, bv) if bias else jfn(a, b)
    tdt = getattr(torch, in_dt)
    got = matmul_ext(torch.from_numpy(a).to(tdt),
                     torch.from_numpy(b.T.copy()).to(tdt),
                     torch.from_numpy(bv) if bias else None, relu,
                     getattr(torch, out_dt))
    assert got.dtype == getattr(torch, out_dt)
    _close(got.float().numpy(), np.asarray(want, np.float32), in_dt)


@pytest.mark.parametrize("prec", ["", "bf16"])
def test_sgemm_template_matches_jax_and_ref(monkeypatch, prec):
    monkeypatch.setenv("BODA_PALLAS_MODE", "interpret")
    M, K, N = 40, 48, 24
    op = make_sgemm_op(M, N, K)
    if prec:
        op.str_vals["prec"] = prec
    a, b, _ = _inputs(M, K, N, seed=1)
    jt = jax_template("sgemm")
    want = np.asarray(jt.build(jt.check_args(op))(a, b), np.float32)
    pt = get_template("sgemm")
    rfs = pt.check_args(_port_op(op))
    assert str(rfs) == str(jt.check_args(op))
    got = pt.build(rfs)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    _close(got, want, "bfloat16" if prec else "float32")
    if not prec:
        np.testing.assert_allclose(got, pt.ref_impl(rfs, a, b), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("prec", ["", "bf16"])
def test_xla_sgemm_matches_jax(prec):
    """The vendor sgemm (the ops_prof kg tune): torch.matmul against the
    JAX package's jnp.dot, f32 at 2e-5 and bf16 at mrd 5e-3."""
    M, K, N = 33, 70, 21
    op = make_sgemm_op(M, N, K, func_name="xla_sgemm")
    if prec:
        op.str_vals["prec"] = prec
    a, b, _ = _inputs(M, K, N, seed=2)
    jt = jax_template("xla_sgemm")
    want = np.asarray(jt.build(jt.check_args(op))(a, b), np.float32)
    pt = get_template("xla_sgemm")
    rfs = pt.check_args(_port_op(op))
    assert str(rfs) == str(jt.check_args(op))
    got = pt.build(rfs)(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    _close(got.numpy(), want, "bfloat16" if prec else "float32")


def test_matmul_ext_refuses_what_the_kernel_does_not_take():
    a = torch.zeros(4, 8)
    b = torch.zeros(3, 8)
    with pytest.raises(RtErr, match="disagree on K"):
        matmul_ext(a, torch.zeros(3, 7))
    with pytest.raises(RtErr, match="dtype"):
        matmul_ext(a.double(), b.double())
    with pytest.raises(RtErr, match="a is torch.float32 but b"):
        matmul_ext(a, b.bfloat16())
    with pytest.raises(RtErr, match="contiguous"):
        matmul_ext(torch.zeros(8, 4).t(), b)
    with pytest.raises(RtErr, match="bias length"):
        matmul_ext(a, b, torch.zeros(4))
    with pytest.raises(RtErr, match="bias.*dtype"):
        matmul_ext(a, b, torch.zeros(3, dtype=torch.bfloat16))
    # a device with neither a kernel nor a plain version raises: nothing
    # falls back to the CPU
    with pytest.raises(RtErr, match="no kernel for device 'meta'"):
        matmul_ext(a.to("meta"), b.to("meta"))


def test_plain_version_does_not_count_a_launch():
    n0 = matmul_ext.launches
    matmul_ext(torch.ones(2, 3), torch.ones(4, 3))
    assert matmul_ext.launches == n0


def test_registry_names_unknown_templates():
    with pytest.raises(RtErr, match="no kernel template 'lrn'.*"
                                    "k1conv.*sgemm.*tconv"):
        get_template("lrn")
