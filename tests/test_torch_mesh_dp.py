"""The dp split of the port's mesh computes the function of the whole batch,
as GSPMD does in the JAX package: train-mode dropout over the global flat
index, and the int8 steps' dynamic activation scale over the global batch
(boda_tpu_torch/engine/mesh_fwd.py slot_kwargs, parallel/mesh.pmax,
ops/cuda/qconv.absmax and act_quantize's amax, ops/cuda/elementwise's
masks at a slot's first row). On the CPU, against the JAX engine on the
conftest's 8 virtual devices and against the port's own forward on one
slot, also where the dp rows are two gloo ranks.

Tolerances: train_dropout against the JAX engine's same mesh and the
port's one slot, max abs 1e-5 on prob (f32, the vendor convs); dynamic
int8 against the JAX engine's same mesh mrd 5e-2 (the int8 mesh gate:
bf16 storage rounds apart in the two packages), against the port's one
slot equal. The quantize forms and the masks are held bit for bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import boda_tpu_torch.modes  # noqa: F401  (the port's engines)
from boda_tpu.core import dims as jdims
from boda_tpu.engine import iface as jiface
from boda_tpu.engine.lower import DROP_SEED_NODE as JDROP_SEED_NODE
from boda_tpu.models import zoo as jzoo
from boda_tpu.ops.pallas.elementwise import Dropout as JDropout
from boda_tpu_torch.core.dims import NDA
from boda_tpu_torch.engine.iface import make_engine
from boda_tpu_torch.engine.lower import DROP_SEED_NODE
from boda_tpu_torch.models.zoo import build_model
from boda_tpu_torch.ops.cuda import conv as pconv
from boda_tpu_torch.ops.cuda import qconv as qmod
from boda_tpu_torch.ops.cuda.elementwise import Dropout
from boda_tpu_torch.ops.op_base import OpBase
from boda_tpu_torch.parallel import mesh as pmesh

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
DP_MESHES = [(2, 1), (4, 2)]
INT8_TUNE = "(use_culibs=1,prec=bf16,layout=nhwc,quant8=1)"
SEED = 5


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (many small ops in a row; six test processes
    share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def cpu_slots(monkeypatch):
    """8 slots of the CPU for this test (the env restored after it)."""
    monkeypatch.setenv("BODA_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("BODA_TORCH_LOCAL_DEVICES", "8")


def _data(pipe, scale_img=None):
    """mini's input from a seed; image scale_img scaled x8, so that the
    slots' own absmaxes differ."""
    d = pipe.get_data_img_dims()
    x = np.random.RandomState(0).randn(*d.shape).astype(np.float32)
    if scale_img is not None:
        x[scale_img] *= 8.0
    return x


def _port_prob(spec, x, seed=None):
    pipe = build_model("mini", batch=8)
    e = make_engine(f"(engine=torch,device=cpu,{spec})")
    e.init(pipe)
    ins = {"data": NDA(pipe.get_data_img_dims(), x)}
    if seed is not None:
        ins[DROP_SEED_NODE] = NDA(e.plan.node_dims[DROP_SEED_NODE],
                                  np.asarray([seed], np.int32))
    return e.run_fwd(ins, ["prob"])["prob"].v


def _jax_prob(spec, x, seed=None):
    pipe = jzoo.build_model("mini", batch=8)
    e = jiface.make_engine(f"(engine=rtc,{spec})")
    e.init(pipe)
    ins = {"data": jdims.NDA(pipe.get_data_img_dims(), x)}
    if seed is not None:
        ins[JDROP_SEED_NODE] = jdims.NDA(e.plan.node_dims[JDROP_SEED_NODE],
                                         np.asarray([seed], np.int32))
    return e.run_fwd(ins, ["prob"])["prob"].v


def _mrd(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dp,mp", DP_MESHES)
def test_train_dropout_dp_split_is_the_whole_batchs(cpu_slots, dp, mp):
    """mini b8 under train_dropout=1 with a fed seed: the port's mesh equals
    the JAX engine's same mesh and the port's one slot within 1e-5; the
    mask is live (the infer-mode forward differs)."""
    x = _data(build_model("mini", batch=8))
    tune = "op_tune=(use_culibs=1),train_dropout=1"
    mesh = f",mesh_dp={dp},mesh_mp={mp}"
    got = _port_prob(tune + mesh, x, SEED)
    one = _port_prob(tune, x, SEED)
    want = _jax_prob(tune + mesh, x, SEED)
    infer = _port_prob("op_tune=(use_culibs=1)" + mesh, x)
    assert np.abs(got - want).max() <= 1e-5
    assert np.abs(got - one).max() <= 1e-5
    assert np.abs(got - infer).max() > 1e-2


def _scales_by_step(monkeypatch):
    """Record every s_act the int8 steps quantize at (act_quantize as
    ops/cuda/conv.py calls it), and every slot's own absmax."""
    seen = {"s": [], "absmax": []}

    def act_quantize(*a, **kw):
        xq, s = qmod.act_quantize(*a, **kw)
        seen["s"].append(s.clone())
        return xq, s

    def absmax(x):
        m = qmod.absmax(x)
        seen["absmax"].append(m.clone())
        return m
    monkeypatch.setattr(pconv, "act_quantize", act_quantize)
    monkeypatch.setattr(pconv, "absmax", absmax)
    return seen


@pytest.mark.parametrize("dp,mp", DP_MESHES)
def test_dynamic_int8_dp_split_is_the_whole_batchs(cpu_slots, monkeypatch,
                                                   dp, mp):
    """mini b8 under dynamic quant8 with one image scaled x8: the port's
    mesh within 5e-2 of the JAX engine's same mesh and equal to the port's
    one slot; every slot of every int8 step quantizes at the one slot's
    s_act bit for bit, though the slots' own absmaxes differ; pmax once per
    dynamic int8 step."""
    x = _data(build_model("mini", batch=8), scale_img=3)
    tune = f"op_tune={INT8_TUNE}"
    mesh = f",mesh_dp={dp},mesh_mp={mp}"
    seen = _scales_by_step(monkeypatch)
    one = _port_prob(tune, x)
    s_one = list(seen["s"])
    assert s_one and not seen["absmax"]
    seen["s"].clear()
    calls = pmesh.pmax.calls
    got = _port_prob(tune + mesh, x)
    n = dp * mp
    assert pmesh.pmax.calls - calls == len(s_one)
    assert len(seen["s"]) == len(seen["absmax"]) == n * len(s_one)
    for i, s in enumerate(s_one):
        slots = seen["s"][n * i:n * (i + 1)]
        assert all(torch.equal(v, s) for v in slots), i
    own = seen["absmax"][:n]
    assert len({float(m) for m in own}) > 1
    np.testing.assert_array_equal(got, one)
    want = _jax_prob(tune + mesh, x)
    assert _mrd(got, want) <= 5e-2


def test_pmax_within_one_process():
    """pmax over each axis of a (2, 4) mesh of CPU slots: the group's
    elementwise max, NaN kept, one call counted."""
    m = pmesh.make_mesh(n_devices=8, dp=2, mp=4, devices=[CPU] * 8)
    rng = np.random.RandomState(4)
    vals = {p: torch.from_numpy(rng.randn(3).astype(np.float32))
            for p in m.local_positions()}
    vals[(1, 2)][1] = float("nan")
    for axis in ("dp", "mp"):
        calls = pmesh.pmax.calls
        got = pmesh.pmax(m, vals, axis)
        assert pmesh.pmax.calls == calls + 1
        for p in m.local_positions():
            want = torch.stack([vals[q] for q in m.group(p, axis)]) \
                .amax(0)
            torch.testing.assert_close(got[p], want, equal_nan=True)
    assert torch.isnan(pmesh.pmax(m, vals, "dp")[(0, 2)][1])
    assert not torch.isnan(pmesh.pmax(m, vals, "dp")[(0, 1)]).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nan", [False, True])
def test_quantize_at_a_device_max_is_the_dynamic_form(dtype, nan):
    """act_quantize(x, amax=m) at m = max|x| equals the dynamic form bit for
    bit (xq and s_act), plain version and wrapper; absmax is max|x|; at the
    max of a larger batch the scale is that batch's."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(4, 5, 6, 24).astype(np.float32)) \
        .to(dtype)
    if nan:
        x[1, 2, 3, 4] = float("nan")
    m = qmod.absmax(x)
    assert torch.equal(m, qmod.absmax_plain(x)) or (nan and m.isnan().all())
    assert bool(m.isnan().all()) == nan
    for fn in (qmod.act_quantize_plain, qmod.act_quantize):
        xq, s = fn(x)
        xq_m, s_m = fn(x, amax=m)
        assert torch.equal(xq_m, xq)
        assert torch.equal(s_m, s) or (nan and s.isnan().all()
                                       and s_m.isnan().all())
    if not nan:
        big = torch.cat([x, 3 * x])
        _, s_big = qmod.act_quantize_plain(big)
        xq_g, s_g = qmod.act_quantize(x, amax=qmod.absmax(big))
        assert torch.equal(s_g, s_big)
        assert torch.equal(xq_g, qmod.act_quantize_plain(big)[0][:4])
    with pytest.raises(Exception, match="a static act_absmax and a device"):
        qmod.act_quantize(x, 1.0, amax=m)


def _jax_mask32_at(seed, idx):
    """The JAX template's uint32 fmix (elementwise.py:248-262) at the flat
    indices idx (uint64), wrapped to uint32 as its uint32 arange wraps."""
    u = np.uint32
    c1, c2, c3, c4 = (u(v) for v in JDropout._FMIX)
    i = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = i * c1 + u(seed) * c2
        h ^= h >> u(16)
        h *= c3
        h ^= h >> u(13)
        h *= c4
        h ^= h >> u(16)
    return (h >> u(8)).astype(np.float64) / float(1 << 24)


def _jax_mask_at(seed, idx):
    """The JAX template's uint64 LCG + fmix (elementwise.py:223-234) at the
    flat indices idx."""
    with np.errstate(over="ignore"):
        h = idx * np.uint64(6364136223846793005) \
            + np.uint64(seed * 2654435761 + 1442695040888963407)
        h ^= h >> np.uint64(33)
        h *= np.uint64(0xff51afd7ed558ccd)
        h ^= h >> np.uint64(33)
    return (h >> np.uint64(40)).astype(np.float64) / float(1 << 24)


@pytest.mark.parametrize("first", [2 ** 31 - 24, 2 ** 32 - 24, 2 ** 33 - 24])
def test_dropout_masks_at_a_slots_offset(first):
    """_mask32 and _mask of the rows from row0 on, whose flat indices run
    across 2^31, 2^32 or 2^33, equal the JAX template's formulas at those
    indices; at row 0 those formulas are the JAX template's own masks."""
    shape = (4, 3, 2, 2)  # 12 elements a row
    per = 12
    row0 = first // per
    idx = np.arange(row0 * per, row0 * per + 48, dtype=np.uint64)
    seed = 123456789
    got32 = Dropout._mask32(torch.tensor([seed], dtype=torch.int32), shape,
                            row0)
    np.testing.assert_array_equal(got32.double().numpy().reshape(-1),
                                  _jax_mask32_at(seed, idx))
    sig = OpBase({"type": "Dropout", "func_name": "dropout"})
    sig.set_u32("det_drop_seed", 7)
    np.testing.assert_array_equal(Dropout._mask(sig, shape, row0).reshape(-1),
                                  _jax_mask_at(7, idx))
    at0 = np.arange(48, dtype=np.uint64)
    np.testing.assert_array_equal(JDropout._mask32_np(seed, shape)
                                  .reshape(-1), _jax_mask32_at(seed, at0))
    np.testing.assert_array_equal(
        Dropout._mask(sig, shape).reshape(-1), _jax_mask_at(7, at0))


def test_a_slots_dropout_is_its_rows_of_the_batchs():
    """The train-mode dropout of rows [2, 4) of a batch at row0=2 is those
    rows of the whole batch's, seeded and static alike."""
    x = torch.from_numpy(np.random.RandomState(1).randn(4, 3, 5, 5)
                         .astype(np.float32))
    seed = torch.tensor([9], dtype=torch.int32)
    for seeded in (True, False):
        sig = OpBase({"type": "Dropout", "func_name": "dropout",
                      "drop_mode": "train"})
        sig.set_dims("inout", _dims(x.shape))
        args = (seed,) if seeded else ()
        if seeded:
            sig.set_dims("seed", _dims((1,), "v", "int32_t"))
        fn = Dropout.build(Dropout.check_args(sig))
        assert fn.takes_row0
        whole = fn(*args, x)
        np.testing.assert_array_equal(fn(*args, x[2:], row0=2).numpy(),
                                      whole[2:].numpy())
        assert not torch.equal(fn(*args, x[2:]), whole[2:])


def _dims(shape, names="img chan y x", tn="float"):
    from boda_tpu_torch.core.dims import Dims
    return Dims(list(zip(names.split(), shape)), tn=tn)


_DP_SPLIT_RANK = r"""
import sys
import numpy as np
import torch
from boda_tpu_torch.engine.lower import DROP_SEED_NODE, lower_pipe
from boda_tpu_torch.engine.torch_fwd import build_forward, weights_to_torch
from boda_tpu_torch.models.zoo import build_model
from boda_tpu_torch.ops.cnn_variants import make_op_tune
from boda_tpu_torch.parallel import mesh as pm
from boda_tpu_torch.parallel.multihost import init_multihost, \
    shutdown_multihost
init_multihost(sys.argv[1], 2, int(sys.argv[2]))
try:
    cpu = torch.device("cpu")
    pipe = build_model("mini", batch=8)
    x = np.random.RandomState(0).randn(
        *pipe.get_data_img_dims().shape).astype(np.float32)
    x[3] *= 8.0
    for tune, drop in (("(use_culibs=1,prec=bf16,layout=nhwc,quant8=1)",
                        False), ("(use_culibs=1)", True)):
        plan = lower_pipe(pipe, make_op_tune(tune), fused_storage=True,
                          train_dropout=drop)
        w = weights_to_torch(plan, pipe.op_params, cpu)
        ins = {"data": torch.from_numpy(x)}
        if drop:
            ins[DROP_SEED_NODE] = torch.tensor([5], dtype=torch.int32)
        m = pm.make_mesh(mp=2)  # (2, 2): rank r holds dp row r
        assert m.spans_ranks() and m.shape == {"dp": 2, "mp": 2}
        with torch.no_grad():
            one = build_forward(plan, cpu)(ins, w)["prob"]
            calls = pm.pmax.calls
            got = build_forward(plan, mesh=m)(ins, w)["prob"]
        assert torch.equal(got, one), (tune, float((got - one).abs().max()))
        assert (pm.pmax.calls > calls) != drop, (tune, pm.pmax.calls)
    print("dp split OK")
finally:
    shutdown_multihost()
"""


def test_dp_split_over_two_gloo_ranks(tmp_path):
    """mini b8 on a (2, 2) mesh whose dp rows are two gloo ranks (two CPU
    slots each): dynamic int8 (pmax between the ranks) and train_dropout
    (rank 1's rows from row 4) equal to one slot's forward on each rank."""
    from boda_tpu_torch.parallel.multihost import free_port
    script = tmp_path / "dp_split.py"
    script.write_text(_DP_SPLIT_RANK)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "BODA_TORCH_DEVICE": "cpu",
           "BODA_TORCH_LOCAL_DEVICES": "2", "OMP_NUM_THREADS": "1"}
    for _attempt in range(3):
        coord = f"localhost:{free_port()}"
        procs = [subprocess.Popen([sys.executable, str(script), coord,
                                   str(r)], cwd=ROOT, env=env, text=True,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT)
                 for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=180)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if not any("EADDRINUSE" in o or "address already in use" in o
                   for o in outs):
            break
    for p, o in zip(procs, outs):
        assert p.returncode == 0 and "dp split OK" in o, o[-2000:]
