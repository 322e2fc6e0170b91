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
from boda_tpu_torch.ops.cuda.sgemm import matmul_ext, matmul_plan
from boda_tpu_torch.ops.cuda.util import GemmPlan
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
    # the planner's forms: the 64-wide tile (N=64, the im2col K=576), the
    # split fc (M=1, K=2048, N=1000), and bf16 K=50, which the kernel stages
    # element by element
    (200, 576, 64, True, True, "float32", "float32"),
    (1, 2048, 1000, True, False, "float32", "float32"),
    (70, 50, 40, True, True, "bfloat16", "float32"),
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


def test_xla_sgemm_bf16_keeps_the_f32_product():
    """Under prec=bf16 the vendor sgemm rounds its operands to bf16 and
    returns their product summed in f32, unrounded, as the JAX package's
    jnp.dot(preferred_element_type=f32) does: equal to the f32 product of
    the rounded operands to 1e-6 relative (summation order), and not a
    bf16 value (K = 512 sums are not representable in 8 bits)."""
    M, K, N = 24, 512, 20
    op = make_sgemm_op(M, N, K, func_name="xla_sgemm")
    op.str_vals["prec"] = "bf16"
    a, b, _ = _inputs(M, K, N, seed=3)
    pt = get_template("xla_sgemm")
    got = pt.build(pt.check_args(_port_op(op)))(torch.from_numpy(a),
                                                torch.from_numpy(b))
    assert got.dtype == torch.float32
    ar = torch.from_numpy(a).bfloat16().double().numpy()
    br = torch.from_numpy(b).bfloat16().double().numpy()
    want = ar @ br
    scale = np.abs(want).max()
    assert np.abs(got.double().numpy() - want).max() <= 1e-6 * scale
    assert not torch.equal(got, got.bfloat16().float())
    jt = jax_template("xla_sgemm")
    jwant = np.asarray(jt.build(jt.check_args(op))(a, b), np.float64)
    assert np.abs(got.double().numpy() - jwant).max() <= 1e-6 * scale


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


# ResNet-50's B1 products (k1conv, the res2 3x3 im2col conv, the fc) at
# batch 32 and 1: (M, K, N) -> (tile_n, output tiles, splits in bf16 and
# f32 on 132 SMs, then on 114 SMs)
MATMUL_PLANS = {
    ("res2a_branch2a", 32): ((100352, 64, 64), (64, 784, 1, 1, 1, 1)),
    ("res2a_branch2a", 1): ((3136, 64, 64), (64, 25, 1, 2, 1, 2)),
    ("res2a_branch1", 32): ((100352, 64, 256), (128, 1568, 1, 1, 1, 1)),
    ("res2a_branch1", 1): ((3136, 64, 256), (128, 50, 1, 2, 1, 2)),
    ("res2b_branch2a", 1): ((3136, 256, 64), (64, 25, 2, 8, 2, 8)),
    ("res3a_branch2a", 32): ((25088, 256, 128), (128, 196, 1, 1, 1, 1)),
    ("res3a_branch2a", 1): ((784, 256, 128), (128, 7, 2, 8, 2, 8)),
    ("res4b_branch2a", 32): ((6272, 1024, 256), (128, 98, 1, 1, 1, 1)),
    ("res4b_branch2a", 1): ((196, 1024, 256), (128, 4, 8, 32, 8, 32)),
    ("res5a_branch2a", 32): ((1568, 1024, 512), (128, 52, 2, 4, 2, 4)),
    ("res5a_branch2a", 1): ((49, 1024, 512), (128, 4, 8, 32, 8, 32)),
    ("res5a_branch1", 1): ((49, 1024, 2048), (128, 16, 8, 16, 4, 16)),
    ("res5b_branch2c", 32): ((1568, 512, 2048), (128, 208, 1, 1, 1, 1)),
    ("res2 3x3 im2col", 32): ((100352, 576, 64), (64, 784, 1, 1, 1, 1)),
    ("res2 3x3 im2col", 1): ((3136, 576, 64), (64, 25, 3, 8, 3, 8)),
    ("fc1000", 32): ((32, 2048, 1000), (128, 8, 16, 32, 8, 32)),
    ("fc1000", 1): ((1, 2048, 1000), (128, 8, 16, 32, 8, 32)),
}


@pytest.mark.parametrize("name", list(MATMUL_PLANS),
                         ids=[f"{n}-b{b}" for n, b in MATMUL_PLANS])
def test_matmul_plan(name):
    (M, K, N), (tile_n, blocks, s16, s32, s16_114, s32_114) = \
        MATMUL_PLANS[name]
    p16 = matmul_plan(M, N, K, torch.bfloat16, 132)
    p32 = matmul_plan(M, N, K, torch.float32, 132)
    assert p16 == GemmPlan("mma", K % 8 == 0, 128, tile_n, 64, s16, blocks)
    assert p32 == GemmPlan("ffma", K % 4 == 0, 128, tile_n, 8, s32, blocks)
    # the 64-wide form exactly where it covers N with fewer columns
    assert (tile_n == 64) == (N % 128 in range(1, 65))
    # the split rule follows the card's SM count
    assert matmul_plan(M, N, K, torch.bfloat16, 114).splits == s16_114
    assert matmul_plan(M, N, K, torch.float32, 114).splits == s32_114
    for plan, least in ((p16, 2), (p32, 4)):
        chunks = -(-K // plan.bk)
        per = -(-chunks // plan.splits)
        # every split sums at least `least` chunks (or all there are) and
        # none is empty; only grids under half a tile per SM split
        assert per >= min(least, chunks) and (plan.splits - 1) * per < chunks
        assert plan.splits == 1 or blocks < 66


def test_matmul_ext_admits_offsets_past_int32():
    """The kernel indexes in 64 bits: M*K past 2^31 passes the checks (and
    the meta device then refuses to run it), an extent past int32 or more
    N tiles than the grid holds does not."""
    big = torch.empty(2 ** 21 + 1, 1024, device="meta")
    with pytest.raises(RtErr, match="no kernel for device 'meta'"):
        matmul_ext(big, torch.empty(64, 1024, device="meta"))
    with pytest.raises(RtErr, match="extent over int32"):
        matmul_ext(torch.empty(1, 2 ** 31, device="meta"),
                   torch.empty(1, 2 ** 31, device="meta"))
    with pytest.raises(RtErr, match="N over 4194240"):
        matmul_ext(torch.empty(1, 1, device="meta"),
                   torch.empty(65535 * 64 + 1, 1, device="meta"))


def test_registry_names_unknown_templates():
    with pytest.raises(RtErr, match="no kernel template 'lrn'.*"
                                    "k1conv.*sgemm.*tconv"):
        get_template("lrn")
