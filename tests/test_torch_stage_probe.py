"""cnet_stage_probe on the port against the JAX package's, on the CPU: the
same stages, step counts and GF per stage (forward, and under bwd=1 with
the same flop multipliers); each port segment's output from the mode's own
stage input and weights within 1e-5 (mrd, f32) of the JAX segment's on the
same arrays; under bwd=1 each stage's input and weight gradients (the
mode's stage_fn) within 1e-4 of jax.grad of the JAX segment under the f32
vendor tune and within 2e-2 under the bf16 vendor tune (the training
gradients' bound, tests/test_torch_train.py); a hand tune refused by the
inference-only guard.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from boda_tpu.core.has_main import create_and_run_has_main as jrun
from boda_tpu.engine.lower import lower_pipe as jlower_pipe
from boda_tpu.engine.segments import build_plan_segments as jsegments
from boda_tpu.graph.caffe_io import write_prototxt as jwrite_prototxt
from boda_tpu.models.zoo import NetBuilder as JNetBuilder
from boda_tpu.ops.cnn_variants import make_op_tune as jmake_op_tune
from boda_tpu_torch.apps.cnet_bench import stage_fn
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.core.has_main import create_and_run_has_main

MINI_STAGES = "stem:conv1|mid:cccp1+conv2+cat2+pool|head:drop+fc-conv+gpool+prob"
# the gradients' stages stop at the logits: the gradient of the summed
# softmax is zero in exact arithmetic, so there is nothing to compare
GRAD_STAGES = {"mini": "stem:conv1|mid:cccp1+conv2+cat2+pool|"
                       "head:drop+fc-conv+gpool"}
CAT_STAGES = "s1:c1|s2:br+c2"
F32_TUNE = "(use_culibs=1)"
BF16_TUNE = "(use_culibs=1,prec=bf16,layout=nhwc,s2d=0)"


def _cat_net(tmp_path):
    """tests/test_cnet_bench.py's stage with a concat in it."""
    b = JNetBuilder("cat-net", 1, 3, 16, 16)
    b.conv("c1", 8, 3, 1, 1)
    src = b.cur
    b.conv("br/a", 4, 1, in_node=src)
    oa = b.cur
    b.conv("br/b", 4, 3, pad=1, in_node=src)
    ob = b.cur
    b.concat("br/cat", [oa, ob])
    b.conv("c2", 8, 1)
    ptt = tmp_path / "n.prototxt"
    jwrite_prototxt(b.done(), ptt)
    return ptt


def _net(net: str, tmp_path) -> tuple[str, str]:
    if net == "mini":
        return "model=mini,batch=1", MINI_STAGES
    # the concat net has no prob node, which the JAX mode's whole-net
    # timing reads: whole_net=0 there, as in its own test
    return f"ptt_fn={_cat_net(tmp_path)},batch=1,whole_net=0", CAT_STAGES


def _table(text: str) -> list[tuple[str, int, str]]:
    """(stage, steps, GF) of each row of a stage table."""
    rows = []
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("stage "))
    for ln in lines[start + 1:]:
        if ln.startswith("SUM"):
            break
        name, steps, _ms, gf, _tfs = ln.split()
        rows.append((name, int(steps), gf))
    return rows


def _run(run, spec: str):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        hm = run(spec)
    return buf.getvalue(), hm


@pytest.mark.parametrize("bwd", [0, 1])
@pytest.mark.parametrize("net", ["mini", "cat"])
def test_stage_table_as_the_jax_mode(net, bwd, tmp_path):
    args, stages = _net(net, tmp_path)
    spec = (f"(mode=cnet_stage_probe,{args},iters=2,reps=1,bwd={bwd},"
            f"op_tune={BF16_TUNE},stages={stages}")
    out, hm = _run(create_and_run_has_main, spec + ",device=cpu)")
    jout, _ = _run(jrun, spec + ")")
    assert _table(out) == _table(jout)
    assert [r[0] for r in _table(out)] == [p.split(":")[0]
                                           for p in stages.split("|")]
    assert ("(isolated-sum / whole = " in out) == (net == "mini")
    assert len(hm.rows) == len(_table(out))


def _jax_segments(hm, tune: str):
    """The JAX package's segments of the same net under `tune`, beside the
    port mode's (same stages, same weight order)."""
    jplan = jlower_pipe(hm.jpipe, jmake_op_tune(tune), fused_storage=True)
    assert [s.call_tag for s in jplan.steps] == \
        [s.call_tag for s in hm.plan.steps]
    jsegs = jsegments(jplan, {n: None for n in hm.weights}, hm.stages)
    assert [(p.name, p.weight_names, p.in_node, p.out_node) for p in jsegs] \
        == [(p.name, p.weight_names, p.in_node, p.out_node)
            for p in hm.segments]
    return jsegs


def _probe(net: str, tune: str, tmp_path, bwd: int = 0):
    args, stages = _net(net, tmp_path)
    if bwd:
        stages = GRAD_STAGES.get(net, stages)
    args = args.replace(",whole_net=0", "")
    _, hm = _run(create_and_run_has_main,
                 f"(mode=cnet_stage_probe,{args},iters=1,reps=1,bwd={bwd},"
                 f"whole_net=0,op_tune={tune},stages={stages},device=cpu)")
    from boda_tpu.graph.modes import _load_pipe as jload_pipe
    hm.jpipe = jload_pipe(hm)
    return hm


def _np(t):
    return t.detach().float().numpy()


def _mrd(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jnp(t):
    v = t.detach()
    return jnp.asarray(v.float().numpy()).astype(jnp.bfloat16) \
        if str(v.dtype) == "torch.bfloat16" else jnp.asarray(v.numpy())


@pytest.mark.parametrize("net", ["mini", "cat"])
@pytest.mark.parametrize("tune", ["()", F32_TUNE])
def test_stage_outputs_as_the_jax_segments(net, tune, tmp_path):
    hm = _probe(net, tune, tmp_path)
    for ps, jps in zip(hm.segments, _jax_segments(hm, tune)):
        xin = hm.stage_inputs[ps.name]
        ws = [hm.weights[n] for n in ps.weight_names]
        got = ps.fn(xin, *ws)
        want = jps.fn(_jnp(xin), *[_jnp(w) for w in ws])
        assert _mrd(_np(got), np.asarray(want, np.float32)) <= 1e-5, ps.name
        # and the whole net's value of the stage's output node (no
        # storage pass under these tunes: the logical form)
        assert not hm.plan.storage_nhwc
        assert _mrd(_np(got), _np(hm.node_vals[ps.out_node])) <= 1e-5


@pytest.mark.parametrize("net", ["mini", "cat"])
@pytest.mark.parametrize("tune,toler", [(F32_TUNE, 1e-4), (BF16_TUNE, 2e-2)])
def test_stage_gradients_as_jax_grad(net, tune, toler, tmp_path):
    hm = _probe(net, tune, tmp_path, bwd=1)
    data = hm.jpipe.data_img_node_names
    n_dgrad = 0
    for ps, jps in zip(hm.segments, _jax_segments(hm, tune)):
        xin = hm.stage_inputs[ps.name]
        ws = [hm.weights[n] for n in ps.weight_names]
        data_fed = ps.in_node in data
        fn, flops = stage_fn(ps, xin, ws, True, data_fed)
        want_dgrad = (not data_fed) or not ps.weight_names
        assert flops == ps.flops * (1 + int(want_dgrad)
                                    + int(bool(ps.weight_names)))
        grads = fn()

        def loss(x, wt, _f=jps.fn):
            return _f(x, *wt).ravel().astype(jnp.float32).sum()
        argnums = tuple(a for a, use in ((0, want_dgrad),
                                         (1, bool(ps.weight_names))) if use)
        jg = jax.grad(loss, argnums=argnums)(_jnp(xin),
                                             tuple(_jnp(w) for w in ws))
        want = ([jg[0]] if want_dgrad else []) + \
            (list(jg[-1]) if ps.weight_names else [])
        assert len(grads) == len(want) > 0
        for g, w in zip(grads, want):
            assert g.shape == tuple(w.shape)
            assert _mrd(_np(g), np.asarray(w, np.float32)) <= toler, ps.name
        n_dgrad += want_dgrad
    assert n_dgrad >= 1


def test_bwd_under_a_hand_tune_is_refused(tmp_path):
    with pytest.raises(RtErr, match="cnet_stage_probe: step .* runs "
                                    "template '.*', which has no backward"):
        create_and_run_has_main(
            f"(mode=cnet_stage_probe,model=mini,iters=1,reps=1,bwd=1,"
            f"op_tune=(),stages={MINI_STAGES},device=cpu)")


def test_stage_probe_defaults_to_the_card():
    with pytest.raises(RtErr, match="device 'cuda' requested but CUDA is "
                                    "not available"):
        create_and_run_has_main(f"(mode=cnet_stage_probe,model=mini,"
                                f"stages={MINI_STAGES})")
