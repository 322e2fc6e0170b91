"""The port's Backend (be=torch, backend/torch_be.py) on the Backend
contract of its backend/iface.py (the copy of boda_tpu/backend/iface.py),
its Codegen and gen_data template, and rtc_test; on device=cpu, the
only device here.

gen_data vars are compared with the JAX XlaBackend's bit for bit: both
packages make the pattern with the same numpy function.
"""

import numpy as np
import pytest
import torch

from boda_tpu.backend import iface as jiface
from boda_tpu.core import dims as jdims
from boda_tpu.ops import op_base as jop_base
from boda_tpu.ops.registry import Codegen as JaxCodegen
from boda_tpu_torch import modes  # noqa: F401  (be=torch, torch_* modes)
from boda_tpu_torch.backend.iface import CompiledFunc, RtcFuncCall, \
    make_backend
from boda_tpu_torch.backend.torch_be import TorchBackend
from boda_tpu_torch.core.dims import NDA, Dims
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.core.has_main import create_and_run_has_main
from boda_tpu_torch.ops.op_base import OpBase
from boda_tpu_torch.ops.registry import Codegen


def _be():
    be = make_backend("(be=torch,device=cpu)")
    assert isinstance(be, TorchBackend)
    be.init()
    return be


def _func(be, name, fn, ins, outs, present=None):
    cf = CompiledFunc(name, fn, ins, outs, [])
    cf.present_args = present
    be.compile([cf])


def test_vars_views_copies_and_release():
    be = _be()
    d = Dims.make(a=2, b=3)
    be.create_var_with_dims("x", d)
    v = be.var_device_value("x")
    assert isinstance(v, torch.Tensor) and v.dtype == torch.float32
    assert v.device == torch.device("cpu") and not v.any()
    host = np.arange(6, dtype=np.float32).reshape(2, 3)
    be.copy_nda_to_var("x", NDA(d, host))
    be.create_var_with_dims_as_reshaped_view_of_var("xv", Dims.make(n=6), "x")
    got = be.copy_var_to_nda("xv")
    assert got.v.shape == (6,) and np.array_equal(got.v, host.ravel())
    # a copy converts to the var's dtype
    be.copy_nda_to_var("x", NDA(d, host.astype(np.float64) + 0.5))
    assert be.var_device_value("x").dtype == torch.float32
    with pytest.raises(RtErr, match="duplicate var"):
        be.create_var_with_dims("x", d)
    with pytest.raises(RtErr, match="size mismatch"):
        be.copy_nda_to_var("x", NDA(Dims.make(n=5), np.zeros(5, np.float32)))
    be.release_var("x")
    with pytest.raises(RtErr, match="released var 'x'"):
        be.copy_var_to_nda("xv")
    with pytest.raises(RtErr, match="no var 'x'"):
        be.release_var("x")


def test_run_views_nda_args_present_args_and_timing():
    be = _be()
    d = Dims.make(n=4)
    for v in ("a", "c"):
        be.create_var_with_dims(v, d)
    be.create_var_with_dims_as_reshaped_view_of_var("a2", Dims.make(p=2, q=2),
                                                    "a")
    be.copy_nda_to_var("a", NDA(d, np.arange(4, dtype=np.float32)))
    # a view in, a by-value NDA scalar in, an absent optional arg skipped
    _func(be, "axpy", lambda a, s: a.reshape(4) * s, ["a", "s", "opt"],
          ["c"], present={"a", "s", "c"})
    cid = be.run(RtcFuncCall("axpy", {"a": "a2", "s": NDA.scalar(3.0, "float"),
                                      "c": "c"}))
    be.finish_and_sync()
    assert np.array_equal(be.copy_var_to_nda("c").v, [0, 3, 6, 9])
    assert be.get_dur(cid, cid) >= 0
    cid2 = be.run(RtcFuncCall("axpy", {"a": "a", "s": NDA.scalar(1.0, "float"),
                                       "c": "c"}))
    assert be.get_dur(cid, cid2) >= be.get_dur(cid2, cid2) >= 0
    with pytest.raises(RtErr, match="missing arg 's'"):
        be.run(RtcFuncCall("axpy", {"a": "a", "c": "c"}))
    with pytest.raises(RtErr, match="missing output arg 'c'"):
        be.run(RtcFuncCall("axpy", {"a": "a", "s": NDA.scalar(1.0, "float")}))
    with pytest.raises(RtErr, match="no compiled func 'nope'"):
        be.run(RtcFuncCall("nope", {}))


def test_run_refuses_wrong_precision_and_foreign_outputs():
    be = _be()
    d = Dims.make(n=3)
    be.create_var_with_dims("a", d)
    be.create_var_with_dims("c", d)
    _func(be, "to_f64", lambda a: a.double(), ["a"], ["c"])
    with pytest.raises(RtErr, match="dtype torch.float64 != var 'c' dtype "
                                    "torch.float32.*wrong precision"):
        be.run(RtcFuncCall("to_f64", {"a": "a", "c": "c"}))
    _func(be, "to_np", lambda a: a.numpy(), ["a"], ["c"])
    with pytest.raises(RtErr, match="not on the backend's device cpu"):
        be.run(RtcFuncCall("to_np", {"a": "a", "c": "c"}))
    _func(be, "to_meta", lambda a: a.to("meta"), ["a"], ["c"])
    with pytest.raises(RtErr, match="is on meta, not on the backend's device"):
        be.run(RtcFuncCall("to_meta", {"a": "a", "c": "c"}))


def test_plat_tag_and_device_kind():
    be = _be()
    assert be.get_plat_tag() == "torch:cpu:cpu"
    assert be.device_kind() == "cpu"


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    be = make_backend("torch")
    assert be.device == "cuda"
    with pytest.raises(RtErr, match="'cuda' requested but CUDA is not "
                                    "available"):
        be.ensure_init()
    with pytest.raises(RtErr, match="CUDA is not available"):
        create_and_run_has_main("(mode=rtc_test,n=8)", {})


def test_port_modes_refuse_the_jax_backend():
    # the port registers no be=xla: its config refuses the name
    with pytest.raises(RtErr, match="unknown be 'xla' for Backend"):
        create_and_run_has_main("(mode=rtc_test,rtc=xla,n=8)", {})


@pytest.mark.parametrize("rtc", ["(be=torch,device=cpu)", "interp"])
def test_torch_rtc_test(capsys, rtc):
    create_and_run_has_main(f"(mode=rtc_test,rtc={rtc},n=100)", {})
    out = capsys.readouterr().out
    tag = "torch:cpu:cpu" if "torch" in rtc else "interp:numpy"
    assert f"rtc_test PASSED plat={tag} n=100" in out


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
def test_gen_data_vars_equal_the_jax_backends(mode):
    got = {}
    # each package's backend, codegen, Dims, NDA and OpBase
    for name, be, cg_cls, dims_mod, op_cls in (
            ("torch", _be(), Codegen, (Dims, NDA), OpBase),
            ("xla", jiface.make_backend("xla"), JaxCodegen,
             (jdims.Dims, jdims.NDA), jop_base.OpBase)):
        dims_cls, nda_cls = dims_mod
        be.init()
        cg = cg_cls(be)
        dims = dims_cls.make(tn="float", img=2, chan=3, y=5, x=7)
        be.create_var_with_dims("out", dims)
        op = op_cls({"type": "gen_data", "func_name": "gen_data"})
        op.set_dims("out", dims)
        op.set_u32("mode", mode)
        op.nda_vals["scale"] = nda_cls.scalar(0.1, "float")
        cg.gen_and_run(op, {"out": "out"})
        be.finish_and_sync()
        got[name] = be.copy_var_to_nda("out").v
    assert got["torch"].dtype == np.float32
    assert got["torch"].tobytes() == np.asarray(got["xla"]).tobytes()


def test_gen_data_output_takes_the_backends_device():
    be = _be()
    cg = Codegen(be)
    be.create_var_with_dims("out", Dims.make(n=5))
    op = OpBase({"type": "gen_data", "func_name": "gen_data"})
    op.set_dims("out", Dims.make(n=5))
    inst = cg.gen_func(op)
    cg.compile_pend()
    # the backend bound its device into the function at compile
    assert be._funcs[inst].fn.keywords == {"device": torch.device("cpu")}
    cg.run_func(RtcFuncCall(inst, {"out": "out"}))
    first = be.var_device_value("out")
    cg.run_func(RtcFuncCall(inst, {"out": "out"}))
    # each run makes a new tensor: vars never share the pattern's storage
    assert be.var_device_value("out").data_ptr() != first.data_ptr()
