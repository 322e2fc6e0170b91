"""cnet_xprof on the port, on the CPU (the host's events, as the JAX mode's
own tests read the CPU's): the JAX mode's header, rows and by-kind table,
with and without bwd=1; dump_fn and trace_dir; the kind rollup of CUDA
kernel names; a device trace of a CPU run holds no device rows (the mode
raises on a card when that happens); the default device is the card."""

import contextlib
import io
import json
import re

import pytest

from boda_tpu.core.has_main import create_and_run_has_main as jrun
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.core.has_main import create_and_run_has_main
from boda_tpu_torch.tune.xprof import aggregate_profile, kernel_kind, \
    rollup_kinds

MINI = "model=mini,batch=2,steps=2,op_tune=(use_culibs=1)"
HEADER = re.compile(r"^cnet_xprof mini b2 steps=2 device=(\S+) "
                    r"compile_s=[\d.]+ planes=\[.*\]$", re.M)
ROW = re.compile(r"^(.{44}) +(\d+) +([\d.]+) +([\d.]+)$")


def _run(run, spec: str):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        hm = run(spec)
    return buf.getvalue(), hm


def _tables(out: str) -> tuple[list, list]:
    """The per-kernel rows and the by-kind rows of a cnet_xprof table."""
    lines = out.splitlines()
    i = next(k for k, ln in enumerate(lines) if ln.startswith("device total"))
    j = lines.index("-- by kind --")
    rows = [ROW.match(ln) for ln in lines[i + 2:j]]
    kinds = [ROW.match(ln) for ln in lines[j + 1:]
             if ROW.match(ln)]
    return rows, kinds


@pytest.mark.parametrize("bwd", [0, 1])
def test_xprof_table_on_the_cpu(bwd, tmp_path):
    out, hm = _run(create_and_run_has_main,
                   f"(mode=cnet_xprof,{MINI},bwd={bwd},dump_fn=rows.txt,"
                   f"trace_dir={tmp_path}/trace,boda_output_dir={tmp_path},"
                   f"conv_fwd=(engine=torch,device=cpu))")
    jout, _ = _run(jrun, f"(mode=cnet_xprof,{MINI},bwd={bwd},"
                         f"boda_output_dir={tmp_path}/jax)")
    # the JAX mode's header and layout, the host's device name on the CPU
    assert HEADER.search(out)[1] == "cpu" and HEADER.search(jout)
    for text in (out, jout):
        assert re.search(r"^device total: [\d.]+ ms/step over \d+ ", text,
                         re.M)
        rows, kinds = _tables(text)
        assert rows and all(rows) and kinds
    rows, kinds = _tables(out)
    assert len(rows) == min(len(hm.rows), 25)
    assert [r[2] for r in rows] == [str(r["count"]) for r in hm.rows[:25]]
    assert sum(int(k[2]) for k in kinds) == \
        sum(r["count"] for r in hm.kinds[:25])
    # shares of the total add up to 100 over every row
    assert sum(r["total_ns"] for r in hm.rows) == pytest.approx(hm.total_ns)
    # a conv net's forward (and backward) runs its convs; the profiler's
    # step annotations, which span whole steps, are no rows
    assert any("conv" in r["op"] for r in hm.rows)
    assert not any(r["op"].startswith("ProfilerStep") for r in hm.rows)
    if bwd:
        assert any("Backward" in r["op"] or "backward" in r["op"]
                   for r in hm.rows)
    # dump_fn: one line per row, with its full name
    dump = (tmp_path / "rows.txt").read_text().splitlines()
    assert len(dump) == len(hm.rows)
    assert [ln.split(None, 3)[3] for ln in dump] == \
        [r["op"] for r in hm.rows]
    # trace_dir: the Chrome trace of the profiled steps
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::matmul_ffma<float, 128, true>(float "
     "const*, float const*, float const*, float*, float*, "
     "(anonymous namespace)::Gemm, int)", "matmul_ffma"),
    ("void (anonymous namespace)::matmul_ffma<__nv_bfloat16, 64, false>"
     "(float const*)", "matmul_ffma"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<float>, at::detail::Array<char*, 1> >(int, "
     "at::native::FillFunctor<float>, at::detail::Array<char*, 1>)",
     "at::native::vectorized_elementwise_kernel"),
    # a parameter list that nests a lambda's (as PyTorch's kernels do)
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_"
     "impl_nocast<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase"
     "&)::{lambda()#3}::operator()() const::{lambda()#7}::operator()() "
     "const::{lambda(float)#1}>(at::TensorIteratorBase&, at::native::direct_"
     "copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::operator()() "
     "const::{lambda()#7}::operator()() const::{lambda(float)#1} const&)::"
     "{lambda(int)#1}>(int, at::native::gpu_kernel_impl_nocast<at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::"
     "operator()() const::{lambda()#7}::operator()() const::{lambda(float)"
     "#1}>(at::TensorIteratorBase&, at::native::direct_copy_kernel_cuda(at::"
     "TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#7}::"
     "operator()() const::{lambda(float)#1} const&)::{lambda(int)#1})",
     "at::native::elementwise_kernel"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized"
     "<at::native::(anonymous namespace)::OpaqueType<4u>, unsigned int, 4, "
     "64, 64, 16>(char*, at::native::(anonymous namespace)::CatArrInputTensor"
     "Metadata<at::native::(anonymous namespace)::OpaqueType<4u>, unsigned "
     "int, 64, 64>, at::native::(anonymous namespace)::TensorSizeStride"
     "<unsigned int, 4u>, int, unsigned int)",
     "at::native::CatArrayBatchedCopy_vectorized"),
    ("qconv_kernel", "qconv_kernel"),
    ("fusion.12", "fusion"),
    ("aten::mkldnn_convolution", "aten::mkldnn_convolution"),
])
def test_kernel_kind(name, kind):
    assert kernel_kind(name) == kind


def test_rollup_merges_instances_of_one_kind():
    rows = [{"op": n, "kind": kernel_kind(n), "count": c, "total_ns": t}
            for n, c, t in (("void k<float>(int)", 2, 10.0),
                            ("void k<__nv_bfloat16>(int)", 3, 30.0),
                            ("fusion.3", 1, 5.0), ("fusion.7", 4, 1.0),
                            ("other", 1, 100.0))]
    kinds = rollup_kinds(rows)
    assert [(k["kind"], k["count"], k["total_ns"], k["n_ops"])
            for k in kinds] == [("other", 1, 100.0, 1), ("k", 5, 40.0, 2),
                                ("fusion", 5, 6.0, 2)]


def test_a_cpu_trace_has_no_device_rows():
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64, 64).sum()
    assert aggregate_profile(prof, device=False)
    assert aggregate_profile(prof, device=True) == []


def test_xprof_defaults_to_the_card():
    with pytest.raises(RtErr, match="device 'cuda' requested but CUDA is "
                                    "not available"):
        create_and_run_has_main(f"(mode=cnet_xprof,{MINI})")
