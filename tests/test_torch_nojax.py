"""The port stands alone: it never imports jax (the machine with the card
has none), nor anything of the JAX package boda_tpu.

In a fresh interpreter an import hook refuses jax, jaxlib and boda_tpu;
the port is imported, mini is built, lowered and run on the CPU through
the port's make_engine and build_model and through the CLI entry point
(python -m boda_tpu_torch run_cnet), ResNet-50 runs under the fused tune
(fused_stem, resblock), cnet_bench runs GoogLeNet (its concat and LRN
templates) on the CPU, the per-op modes rtc_test and ops_prof
(with sgemm_int8), cnet_tune, cnet_xprof, cnet_stage_probe, wis_ana and
cnet_ana, test_compute_multi (engine=ref, the fused and the
per-call executors against the `mini` TPU digests), test_lmdb (the
per-call executor over tests/data/lmdb-tiny) and aio_cls_selfcheck (the
serving path: three clients coalesced into one batch), and the rest of
the CLI (cs_test_master and a per-call run_cnet over be=ipc, whose worker
is the port's CLI in a process of its own, test_dense, test_upsamp,
scan_data_stream with a spawned stream-src, score, lmdb_bench,
test_velo_crc, blf_pack) run through
the CLI, the native host core builds from the port's own sources
(csrc/host) and places like the Python placement, `help` lists only the
port's modes,
and chip_smoke.py's imports are exercised too; the bench twin (python3 -m
boda_tpu_torch.bench) runs under the same hook and, without a card, exits
non-zero with one line of error and no JSON. A static check finds no import
statement of boda_tpu in the port's sources or chip_smoke.py.
"""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

BLOCK_JAX = """
import sys

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "boda_tpu"):
            raise ImportError(f"import of {name} refused: the port runs "
                              "without jax and without boda_tpu")
        return None

sys.meta_path.insert(0, _NoJax())
"""

# the port's modes: `help` lists these and no other
PORT_MODES = {"run_cnet", "cnet_predict", "cnet_bench", "cls_agree",
              "test_lmdb", "test_compute_multi", "comp_ndas",
              "rtc_test", "ops_prof", "cnn_op_info",
              "cnn_prof", "aio_cls_server", "serve_bench",
              "aio_cls_selfcheck", "blf_pack", "conv_pyra", "pyra_bench",
              "zmq_hello_server", "zmq_hello_client", "zmq_det_stub_server",
              "zmq_cls_server", "zmq_det_server", "zmq_det_client",
              "cnet_train", "train_bench",
              # the tuning and profiling surface, the plots, the wisdom
              # tools and the net-analysis and net-surgery modes
              "cnet_tune", "fusion_penalty", "cnet_stage_probe",
              "cnet_xprof", "wis_merge", "wis_ana", "roofline_plot",
              "wis_plot", "op_eff_plot", "conv_ana", "cnet_ana", "cnet_copy",
              "cnet_fc_to_conv", "cnet_resize_conv", "cnet_bpt_dump",
              "cnet_util",
              # the rest of the CLI: remote execution, the harness, the
              # streams, scoring, the LMDB tools and the displays
              "ipc_compute_worker", "cs_test_master", "test_cmds",
              "test_all", "test_dense", "test_upsamp",
              "gen_test_compute_tests", "gen_ops_prof_tests",
              "scan_data_stream", "lmdb_parse_datums", "lmdb_bench",
              "display_lmdb", "gen_lmdb", "display_test", "display_pil",
              "display_raw_vid", "ds_test", "test_velo_crc", "load_pil",
              "score", "score_files", "ham_ana",
              # parallel and multi-process
              "mh_test", "pp_test"}
# the serving, dense-inference and training modules: the source scan must
# cover them
SLICE_MODULES = ["parallel/transport.py", "io/device_preproc.py",
                 "apps/aio_serve.py", "models/upsamp.py", "apps/predict.py",
                 "apps/pyra.py", "apps/zmq_serve.py", "apps/stream_infer.py",
                 "apps/train.py", "ops/mxu_grad.py", "ops/cuda/bck.py",
                 "engine/segments.py", "apps/cnet_bench.py",
                 "graph/modes.py", "graph/caffe_io.py", "tune/xprof.py",
                 "tune/plots.py", "tune/wisdom_modes.py",
                 "backend/ipc.py", "core/features.py", "testing/modes.py",
                 "io/data_stream.py", "io/disp.py", "io/render.py",
                 "io/video.py", "io/pcap.py", "io/velodyne.py",
                 "io/rosbag.py", "apps/score.py", "apps/eval_cls.py",
                 "utils/cpplib.py", "parallel/mesh.py",
                 "parallel/multihost.py", "parallel/_pipe_plan.py",
                 "parallel/pipeline.py", "parallel/pp_modes.py",
                 "parallel/dryrun.py", "engine/mesh_fwd.py"]
# the native host core's sources: the port's own copies, which include only
# the C++ and system libraries
HOST_SOURCES = ["blf_pack.cc", "stream.cc"]

RUN_MINI = BLOCK_JAX + """
import runpy
import tempfile
from boda_tpu_torch.core.dims import NDA
from boda_tpu_torch.engine.iface import make_engine
from boda_tpu_torch.models.zoo import build_model
from boda_tpu_torch.ops.cuda.gen_data import gen_test_nda
import chip_smoke  # noqa: F401

pipe = build_model("mini", batch=2)
eng = make_engine("(engine=torch,device=cpu,op_tune=(prec=bf16,layout=nhwc))")
eng.init(pipe)
d = pipe.get_data_img_dims()
out = eng.run_fwd({"data": NDA(d, gen_test_nda(d, 0, 0.1))}, ["prob"])
assert out["prob"].v.shape == (2, 10, 1, 1)
# the fused tune: fused_stem and the 12 identity bottlenecks of ResNet-50
rn = build_model("resnet-50", batch=1, ysz=64, xsz=64)
eng = make_engine("(engine=torch,device=cpu,op_tune=(prec=bf16,layout=nhwc,"
                  "fuse_stem=1,fuse_resblock=1))")
eng.init(rn)
kinds = [s.func_name for s in eng.plan.steps]
assert (kinds.count("fused_stem"), kinds.count("resblock")) == (1, 12), kinds
d = rn.get_data_img_dims()
out = eng.run_fwd({"data": NDA(d, gen_test_nda(d, 0, 0.1))}, ["prob"])
assert out["prob"].v.shape == (1, 1000, 1, 1)
for argv in (["help"],
             ["run_cnet", "--model=mini", "--conv_fwd=(engine=torch,device=cpu)"],
             ["rtc_test", "--rtc=(be=torch,device=cpu)"],
             ["test_compute_multi", "--model=mini", "--all_vars=1",
              "--write_digests=0",
              "--engines=(ref=(engine=ref),fused=(engine=torch,device=cpu),"
              "percall=(engine=torch,device=cpu,fuse=0))",
              "--kg_digests_fn=tests/data/tpu_digests/mini/digest-rtc.boda"],
             ["test_lmdb", "--model=mini",
              "--in_dims=(dims=(img=4,chan=3,y=32,x=32))",
              "--src=(mode=lmdb-src,fn=tests/data/lmdb-tiny,mean=128)",
              "--conv_fwd=(engine=torch,device=cpu,fuse=0)"],
             ["cnet_bench", "--model=googlenet_conv_lrn", "--batch=1",
              "--model_opts=(ysz=64,xsz=64)",
              "--conv_fwd=(engine=torch,device=cpu)", "--iters=1", "--reps=1"],
             ["ops_prof", "--ops_fn=tests/data/ops/sgemm-tiny.txt",
              "--rtcs=(t=(be=torch,device=cpu),ref=(be=interp))",
              "--op_tunes=(kg=(use_culibs=1),hand=(),int8=(prec=int8))",
              "--func_mrd_toler=(sgemm_int8=5e-2)", "--run_iter=1"],
             ["aio_cls_selfcheck", "--model=mini",
              "--conv_fwd=(engine=torch,device=cpu)"],
             ["cnet_train", "--model=mini", "--batch=2", "--steps=2",
              "--device=cpu", "--optimizer=momentum"],
             ["train_bench", "--model=mini", "--batch=2", "--device=cpu",
              "--iters=1", "--reps=1"],
             ["cnet_tune", "--model=mini", "--device=cpu", "--iters=1",
              "--reps=1", "--tunes=((),(prec=bf16,layout=nhwc))"],
             ["cnet_xprof", "--model=mini", "--steps=1",
              "--conv_fwd=(engine=torch,device=cpu)"],
             ["cnet_stage_probe", "--model=mini", "--device=cpu",
              "--iters=1", "--reps=1",
              "--stages=stem:conv1|rest:cccp1+conv2+cat2+pool+drop+fc-conv"
              "+gpool+prob"],
             ["wis_ana", "--wisdom_in_fn=tests/data/wisdom-sgemm-baseline.wis"],
             ["cnet_ana", "--model=mini"],
             # be=ipc: the worker is the port's CLI, under the same hook
             ["cs_test_master", "--worker_be=(be=torch,device=cpu)",
              "--n=64"],
             ["run_cnet", "--model=mini",
              "--conv_fwd=(engine=torch,fuse=0,"
              "rtc=(be=ipc,worker_be=(be=torch,device=cpu)))"],
             ["test_dense", "--model=mini", "--out_node=conv2",
              "--in_dims=(dims=(img=1,chan=3,y=48,x=48))",
              "--conv_fwd=(engine=torch,device=cpu,keep_all_nodes=1)"],
             ["test_upsamp", "--model=mini",
              "--conv_fwd=(engine=torch,device=cpu,keep_all_nodes=1)"],
             ["scan_data_stream",
              "--stream=(mode=pipe,stages=(_0=(mode=stream-src,spawn=("
              "mode=test-gen,num=2,sz=4)),_1=(mode=pass)))"],
             ["score", "--imgset_fn=tests/data/voc/imgset.txt",
              "--ann_dir=tests/data/voc/ann",
              "--res_fns=(dog=tests/data/voc/results/dog_test.txt)"],
             ["lmdb_bench", "--fn=tests/data/lmdb-tiny"],
             ["test_velo_crc", "--boda_output_dir=" + tempfile.mkdtemp()],
             ["blf_pack", "--in_sz=(y=64,x=48)", "--bin_sz=(y=128,x=128)"],
             # last: --local-devices puts this process on the CPU ask
             ["pp_test", "--model=mini", "--microbatches=2",
              "--local-devices=4"],
             ["mh_test", "--num-processes=2", "--local-devices=2",
              "--model=mini", "--batch=4"]):
    sys.argv = ["boda_tpu_torch", *argv]
    try:
        runpy.run_module("boda_tpu_torch", run_name="__main__")
    except SystemExit as e:
        assert e.code in (0, None), (argv, e.code)
# the native host core, built from the port's own sources
from boda_tpu_torch.apps.pyra import blf_place
from boda_tpu_torch.core.geom import Pt
from boda_tpu_torch.utils.cpplib import cpp_available
if cpp_available():
    sizes = [Pt(40, 30), Pt(20, 15), Pt(10, 8)]
    assert blf_place(sizes, Pt(64, 64), Pt(2, 2), impl="cpp") == \
        blf_place(sizes, Pt(64, 64), Pt(2, 2), impl="py")
    print("HOST_CORE_OK")
assert not any(m.split(".")[0] in ("jax", "jaxlib", "boda_tpu")
               for m in sys.modules)
print("NOJAX_OK")
"""


def test_port_runs_without_jax():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    r = subprocess.run([sys.executable, "-c", RUN_MINI], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert "run_cnet: out node 'prob'" in r.stdout
    assert "rtc_test PASSED plat=torch:cpu:cpu" in r.stdout
    assert "kg digests vs percall: PASS" in r.stdout
    assert "top_1_acc=0 num_pos=0 num_test=8" in r.stdout
    assert "cnet_bench googlenet_conv_lrn b1 bf16 storage=nhwc: step_ms=" \
        in r.stdout
    assert r.stdout.count("func=sgemm_int8 ") == 4  # 2 ops x 2 backends
    assert "selfcheck ok: 3 clients, max_batch_seen=3" in r.stdout
    assert "cnet_train mini b2 opt=momentum lr=0.01: loss " in r.stdout
    assert "train_bench mini b2 bf16 storage=nhwc opt=sgd lr=0.01: " \
        "step_ms=" in r.stdout
    assert "best: batch=1 tune=(" in r.stdout
    assert "cnet_xprof mini b1 steps=1 device=cpu" in r.stdout
    assert "(isolated-sum / whole = " in r.stdout
    assert "TOTAL: " in r.stdout
    assert "rtc_test PASSED plat=ipc:torch:cpu:cpu n=64" in r.stdout
    assert "test_dense PASSED" in r.stdout
    assert "test_upsamp PASSED" in r.stdout
    assert "scan-data-stream: 2 blocks" in r.stdout
    assert "test_velo_crc: calc=9411 expected=9411 OK" in r.stdout
    assert "dog: AP=0.6667 (3 dets)" in r.stdout
    assert "pp_test 1f1b model=mini pp=4 M=2: PASSED" in r.stdout
    assert "mh_test PASSED ranks=2 model=mini" in r.stdout
    if shutil.which(os.environ.get("CXX") or "g++"):
        assert "HOST_CORE_OK" in r.stdout
    for bad in ("COMP_FAIL", "ERROR"):
        assert bad not in r.stdout
    assert "NOJAX_OK" in r.stdout
    listed = []
    for ln in r.stdout.split("boda_tpu_torch modes:\n", 1)[1].splitlines():
        if not ln.startswith("  "):
            break  # the end of the list (the timers table follows)
        listed.append(ln.split()[0])
    assert set(listed) == PORT_MODES
    assert not [m for m in listed if m.startswith("torch_")]


RUN_BENCH = BLOCK_JAX + """
import runpy
runpy.run_module("boda_tpu_torch.bench", run_name="__main__")
"""


def test_bench_twin_runs_without_jax_and_refuses_without_a_card():
    env = {**os.environ, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, "-c", RUN_BENCH], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0, r.stdout
    assert r.stdout == ""
    assert r.stderr.strip().splitlines() == [
        "bench: no CUDA device (torch.cuda.is_available() is false); "
        "nothing timed"], r.stderr[-2000:]


def test_import_hook_refuses_jax():
    # the hook itself works: a direct import of jax fails under it
    r = subprocess.run([sys.executable, "-c", BLOCK_JAX + "import jax"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "refused" in r.stderr


def _boda_tpu_imports(path: Path) -> list[str]:
    """`import boda_tpu...` / `from boda_tpu... import` statements of a
    source file, at top level or inside a function, as 'line: module'."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [f"{node.lineno}: {n}" for n in names
                if n.split(".")[0] == "boda_tpu"]
    return bad


def test_no_source_of_the_port_imports_boda_tpu():
    files = sorted((ROOT / "boda_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert len(files) > 40
    assert {f"boda_tpu_torch/{m}" for m in SLICE_MODULES} <= \
        {str(f.relative_to(ROOT)) for f in files}
    assert [f"{f.relative_to(ROOT)}:{b}" for f in files
            for b in _boda_tpu_imports(f)] == []


def test_host_core_sources_are_the_ports_own():
    """csrc/host holds the port's copies of the native host core: each
    source includes only the C++ and system libraries, never the JAX
    package's csrc/ nor another file."""
    host = ROOT / "boda_tpu_torch" / "csrc" / "host"
    assert sorted(p.name for p in host.iterdir()) == HOST_SOURCES
    for p in host.iterdir():
        text = p.read_text()
        quoted = re.findall(r'^#include "([^"]+)"', text, re.M)
        assert quoted == [], (p.name, quoted)
        assert "boda_tpu/" not in text.replace("boda_tpu_torch/", ""), p.name


def test_the_static_check_finds_a_nested_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\n\ndef g():\n    from boda_tpu.core import dims\n"
                 "    import boda_tpu_torch, boda_tpu\n")
    assert _boda_tpu_imports(f) == ["4: boda_tpu.core", "5: boda_tpu"]
