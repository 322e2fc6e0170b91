"""The port's `xla_conv2` (sibling convs as one vendor conv) against the JAX
XlaConv2.build on the CPU, on the same seeded inputs, in NCHW f32 and in
NHWC bf16 storage; the int8 forms it refuses; where the vendor conv rounds
under prec=bf16; and a slice net with a stage boundary through TorchFwd
against the JAX engine under the two `fuse_siblings` tunes.

Tolerances: f32 rtol = atol = 2e-5; bf16 mrd <= 5e-3 (the repo's bf16
mrd_toler), with bf16-exact filters (tests/test_torch_conv.py says why);
the engines at 5e-4 (f32) and 5e-3 (bf16) over every node.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from boda_tpu.core import dims as jdims
from boda_tpu.core.dims import Dims
from boda_tpu.engine import iface as jiface
from boda_tpu.models import zoo as jzoo
from boda_tpu.ops.op_base import OpBase as JOpBase
from boda_tpu.ops.pallas import gen_data as jgen_data
from boda_tpu.ops.registry import get_template as jax_template
from boda_tpu.testing.comp import mrd
from boda_tpu_torch.core.digest import nda_digest
from boda_tpu_torch.core.dims import NDA
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.engine.iface import make_engine
from boda_tpu_torch.engine.torch_fwd import produced_nodes
from boda_tpu_torch.models import zoo
from boda_tpu_torch.ops.cuda.conv import make_conv_op
from boda_tpu_torch.ops.cuda.gen_data import gen_test_nda
from boda_tpu_torch.ops.op_base import OpBase
from boda_tpu_torch.ops.registry import get_template
from boda_tpu_torch.testing.comp import comp_digests

# name -> (n, cin, h, w, stride, [(cout, kernel, pad, relu) per member])
GROUPS = {
    # res2a: branch2a (64 -> 64, ReLU) and branch1 (64 -> 256, none)
    "res2a-pair": (2, 64, 6, 6, 1, [(64, 1, 0, True), (256, 1, 0, False)]),
    # a stage boundary: both 1x1 at stride 2
    "stage-boundary-s2": (2, 32, 9, 9, 2, [(16, 1, 0, True),
                                           (64, 1, 0, False)]),
    # an inception group of three 1x1 branches
    "inception-trio": (1, 24, 7, 5, 1, [(8, 1, 0, True), (12, 1, 0, True),
                                        (4, 1, 0, True)]),
    # fuse_mixed_siblings: a 1x1 embedded in the center of its 3x3 partner
    "mixed-1x1-3x3": (2, 16, 8, 8, 1, [(8, 1, 0, True), (12, 3, 1, True)]),
}
FORMS = {"nchw-f32": ("", "", ""), "nhwc-bf16": ("bf16", "nhwc", "bf16")}


def _group_op(name, form):
    """The xla_conv2 sig of a group, as engine/lower._fuse_sibling_convs
    writes it."""
    n, cin, h, w, s, members = GROUPS[name]
    op = JOpBase({"type": "xla_conv2", "func_name": "xla_conv2"})
    op.set_dims("in", Dims.make(img=n, chan=cin, y=h, x=w))
    kf = max(k for _, k, _, _ in members)
    for tag, (cout, k, p, relu) in zip("abcd", members):
        oy, ox = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        op.set_dims(f"filts_{tag}", Dims.make(out_chan=cout, in_chan=cin,
                                              y=k, x=k))
        op.set_dims(f"biases_{tag}", Dims.make(out_chan=cout))
        op.set_dims(f"out_{tag}", Dims.make(img=n, chan=cout, y=oy, x=ox))
        if relu:
            op.set_u32(f"relu_{tag}", 1)
    op.set_null_dims("stride", y=s, x=s)
    op.set_null_dims("kern_sz", y=kf, x=kf)
    pf = members[0][2] + (kf - members[0][1]) // 2
    if pf:
        op.set_null_dims("in_pad", y=pf, x=pf)
    for key, v in zip(("prec", "io_layout", "edge_prec"), FORMS[form]):
        if v:
            op.str_vals[key] = v
    return op


def _group_inputs(name, bf16):
    n, cin, h, w, _s, members = GROUPS[name]
    rng = np.random.RandomState(3)
    x = rng.randn(n, cin, h, w).astype(np.float32)
    wbs = []
    for cout, k, _p, _relu in members:
        wts = (rng.randn(cout, cin, k, k) / np.sqrt(cin * k * k)
               ).astype(np.float32)
        if bf16:
            wts = torch.from_numpy(wts).bfloat16().float().numpy()
        wbs += [wts, rng.randn(cout).astype(np.float32) * 0.5]
    return x, wbs


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("name", list(GROUPS))
def test_xla_conv2_matches_jax_and_ref(name, form):
    op = _group_op(name, form)
    bf16 = form == "nhwc-bf16"
    x, wbs = _group_inputs(name, bf16)
    xs = x.transpose(0, 2, 3, 1).copy() if bf16 else x
    jt = jax_template("xla_conv2")
    jrfs = jt.check_args(op)
    jx = jnp.asarray(xs).astype(jnp.bfloat16) if bf16 else xs
    want = [np.asarray(o, np.float32) for o in jt.build(jrfs)(jx, *wbs)]

    pt = get_template("xla_conv2")
    rfs = pt.check_args(OpBase.from_lexp(str(op.to_lexp())))
    assert str(rfs) == str(jrfs)
    assert pt.flops(rfs) == jt.flops(jrfs)
    tx = torch.from_numpy(xs)
    outs = pt.build(rfs)(tx.bfloat16() if bf16 else tx,
                         *[torch.from_numpy(a) for a in wbs])
    assert len(outs) == len(want) == len(GROUPS[name][5])
    refs = pt.ref_impl(rfs, x, *wbs)
    for out, w_, ref in zip(outs, want, refs):
        assert out.dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert out.is_contiguous()
        got = out.float().numpy()
        assert got.shape == w_.shape
        if bf16:
            assert mrd(got, w_) <= 5e-3
            continue
        np.testing.assert_allclose(got, w_, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("key", ["quant8", "prequant_w", "grad_q8"])
def test_xla_conv2_refuses_the_int8_forms(key):
    op = OpBase.from_lexp(str(_group_op("res2a-pair", "nchw-f32").to_lexp()))
    op.set_u32(key, 1)
    pt = get_template("xla_conv2")
    with pytest.raises(RtErr, match=f"int8 form \\({key}=1\\).*ROADMAP A3"):
        pt.build(pt.check_args(op))


@pytest.mark.parametrize("func", ["xla_conv", "s2d_conv", "xla_conv2"])
def test_vendor_conv_bf16_rounds_once_after_the_bias(func):
    # under prec=bf16 the f32 sum of the bf16 products meets the f32 bias
    # unrounded, and the one rounding is the store's: a bf16 conv that rounds
    # the sum before the bias (what a bf16 cuDNN conv returns) differs on
    # these operands, and so would a conv on unrounded operands
    rng = np.random.RandomState(5)
    n, cin, h, cout, k, s, p = 2, 6, 12, 8, 3, 2, 1
    x = torch.from_numpy(rng.randn(n, h, h, cin).astype(np.float32))
    w = torch.from_numpy(rng.randn(cout, cin, k, k).astype(np.float32) * 0.3)
    b = torch.from_numpy(rng.randn(cout).astype(np.float32))
    if func == "xla_conv2":
        op = OpBase.from_lexp(str(_group_op("res2a-pair", "nhwc-bf16"
                                            ).to_lexp()))
        x = torch.from_numpy(rng.randn(2, 6, 6, 64).astype(np.float32))
        w = torch.from_numpy(rng.randn(64, 64, 1, 1).astype(np.float32) * 0.2)
        b = torch.from_numpy(rng.randn(64).astype(np.float32))
        s, p = 1, 0
        args = (x.bfloat16(), w, b,
                torch.zeros(256, 64, 1, 1), torch.zeros(256))
    else:
        op = make_conv_op(n, cin, h, h, cout, k, k, s, s, p, p,
                          func_name=func, relu=True)
        op.str_vals.update(prec="bf16", io_layout="nhwc", edge_prec="bf16")
        args = (x.bfloat16(), w, b)
    pt = get_template(func)
    got = pt.build(pt.check_args(op))(*args)
    got = got[0] if func == "xla_conv2" else got
    acc = F.conv2d(x.bfloat16().float().permute(0, 3, 1, 2),
                   w.bfloat16().float(), stride=s, padding=p)

    def store(y):
        y = torch.relu(y + b[None, :, None, None])
        return y.bfloat16().permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, store(acc))
    assert not torch.equal(got, store(acc.bfloat16().float()))


# (n, cin, h, w, cout, kernel, stride, pad, relu): the shapes of the trials
ROUNDING_TRIALS = [(2, 16, 7, 7, 20, 3, 1, 1, True),
                   (1, 6, 11, 9, 12, 5, 2, 2, False),
                   (2, 64, 14, 14, 64, 1, 1, 0, True)]


def test_bf16_cudnn_rounding_misses_the_gate(capsys):
    # why the vendor conv stays FP32-on-rounded under prec=bf16: a bf16
    # cuDNN conv returns its sum rounded to bf16 (torch's conv has no f32
    # output for bf16 operands), and the bias comes after. Emulated exactly
    # on the CPU (FP32 conv of the rounded operands, round, bias, ReLU,
    # store) and held against the JAX template over 6 seeds x 3 shapes, that
    # form moves a good share of the stored values by one bf16 step and
    # misses the 5e-3 gate in half the trials; the port's form is bit-equal.
    # Run with -s for the numbers.
    jt, pt = jax_template("xla_conv"), get_template("xla_conv")
    errs, moved = [], []
    for seed in range(6):
        for n, cin, h, w, cout, k, s, p, relu in ROUNDING_TRIALS:
            op = make_conv_op(n, cin, h, w, cout, k, k, s, s, p, p,
                              func_name="xla_conv", relu=relu)
            op.str_vals.update(prec="bf16", io_layout="nhwc",
                               edge_prec="bf16")
            rng = np.random.RandomState(seed)
            x = rng.randn(n, h, w, cin).astype(np.float32)
            wts = torch.from_numpy(
                (rng.randn(cout, cin, k, k) / np.sqrt(cin * k * k)
                 ).astype(np.float32)).bfloat16().float()
            b = torch.from_numpy(rng.randn(cout).astype(np.float32) * 0.5)
            jop = JOpBase.from_lexp(str(op.to_lexp()))
            want = np.asarray(jt.build(jt.check_args(jop))(
                jnp.asarray(x).astype(jnp.bfloat16), wts.numpy(), b.numpy()),
                np.float32)
            xb = torch.from_numpy(x).bfloat16()
            got = pt.build(pt.check_args(op))(xb, wts, b).float().numpy()
            np.testing.assert_array_equal(got, want)
            acc = F.conv2d(xb.float().permute(0, 3, 1, 2), wts, stride=s,
                           padding=p).bfloat16().float()
            y = acc + b[None, :, None, None]
            y = (torch.relu(y) if relu else y).bfloat16().float()
            alt = y.permute(0, 2, 3, 1).numpy()
            errs.append(mrd(alt, want))
            moved.append(float((alt != want).mean()))
    over = sum(e > 5e-3 for e in errs)
    with capsys.disabled():
        print(f"\nbf16-rounded sum before the bias, {len(errs)} trials: mrd "
              f"{min(errs):.3e} .. {max(errs):.3e}, {over} over 5e-3; values "
              f"moved {100 * min(moved):.1f}% .. {100 * max(moved):.1f}%")
    assert 3e-3 < min(errs) and max(errs) < 8e-3 and over >= len(errs) // 3
    assert 0.10 < min(moved) and max(moved) < 0.40


# ------------------------------------------------------------ the engines

PORT = (zoo, make_engine, NDA, gen_test_nda)
JAX = (jzoo, jiface.make_engine, jdims.NDA, jgen_data.gen_test_nda)
F32_TWIN = "(use_culibs=1,fuse_siblings=1,s2d=0)"
HEADLINE = "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,fuse_siblings=1)"
SIB_TUNES = {"f32-twin": (F32_TWIN, 5e-4), "headline": (HEADLINE, 5e-3)}


def build_boundary_net(batch=2, pkg=PORT):
    """A small net with a ResNet stage boundary: a 7x7/s2 stem and a max
    pool, then branch1 (1x1/s2, no ReLU) beside branch2a (1x1/s2, ReLU),
    both reading the pool's output, branch2b (3x3), branch2c (1x1, no
    ReLU), the sum and its ReLU, a global average pool, an fc and softmax."""
    b = pkg[0].NetBuilder("boundary", batch, 3, 32, 32)
    b.conv("conv1", 16, 7, 2, 3).pool("pool1", 3, 2)
    stem = b.cur
    b.conv("branch1", 32, 1, 2, relu=False)
    branch1 = b.cur
    b.cur = stem
    b.conv("branch2a", 8, 1, 2).conv("branch2b", 8, 3, 1, 1)
    b.conv("branch2c", 32, 1, relu=False)
    b.eltwise("sum", [branch1, b.cur]).relu("sum_relu")
    b.pool("gpool", 0, 1, avg=True, global_=True)
    b.conv("fc", 10, 1, relu=False).softmax("prob")
    return b.done(seed=11)


def _run(pipe, spec, pkg, produced=None):
    _zoo, make, nda, pattern = pkg
    eng = make(spec)
    eng.init(pipe)
    d = pipe.get_data_img_dims()
    blob = nda(d, pattern(d, 0, 0.1))
    if produced is None:
        produced = produced_nodes(eng.plan)
    nodes = [n for n, nd in pipe.nodes.items()
             if nd.dims is not None and nd.top_for and n in produced]
    return eng, eng.run_fwd({pipe.data_img_node_names[0]: blob}, nodes)


@pytest.mark.parametrize("tune", list(SIB_TUNES))
def test_boundary_net_matches_jax_engine(monkeypatch, tune):
    monkeypatch.setenv("BODA_PALLAS_MODE", "fallback")
    op_tune, toler = SIB_TUNES[tune]
    pipe, jpipe = build_boundary_net(), build_boundary_net(pkg=JAX)
    if tune == "headline":
        for p_ in (pipe, jpipe):     # bf16-exact weights, as above
            for v in p_.op_params.values():
                v.v[...] = torch.from_numpy(v.v).bfloat16().float().numpy()
    teng, touts = _run(pipe, f"(engine=torch,device=cpu,keep_all_nodes=1,"
                             f"op_tune={op_tune})", PORT)
    _, jouts = _run(jpipe, f"(engine=rtc,keep_all_nodes=1,op_tune={op_tune})",
                    JAX, produced_nodes(teng.plan))
    funcs = [s.func_name for s in teng.plan.steps]
    assert funcs.count("xla_conv2") == 1 and "k1conv" not in funcs
    assert teng.plan.storage_nhwc == (tune == "headline")
    assert sorted(touts) == sorted(jouts)
    assert {"branch1", "branch2a"} <= set(touts)
    kg = {n: nda_digest(NDA(pipe.nodes[n].dims, np.asarray(v.v)))
          for n, v in jouts.items()}
    errs = comp_digests(touts, kg, toler)
    assert not errs, errs
