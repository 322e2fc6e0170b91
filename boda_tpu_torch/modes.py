"""Mode registration hub: importing this module registers the port's CLI
modes, engines, backends and stream stages (the port's counterpart of
boda_tpu/modes.py, whose registry lists the same modes under the same
names, in this order):

  rtc_test                           backend/modes.py
  ipc_compute_worker, cs_test_master backend/ipc.py (and be=ipc)
  conv_ana, cnet_ana, cnet_copy,     graph/modes.py
    cnet_fc_to_conv, cnet_resize_conv,
    cnet_bpt_dump, cnet_util
  run_cnet, cnet_predict             apps/run_cnet.py
  scan_data_stream (and the stream   io/data_stream.py
    stages: sources, xforms, sinks)
  zmq_hello_server, zmq_hello_client,  apps/zmq_serve.py
    zmq_det_stub_server, zmq_cls_server,
    zmq_det_server, zmq_det_client
    (and the stream stage zmq-det)
  (the stream stage cnet-infer)      apps/stream_infer.py
  aio_cls_server, serve_bench,       apps/aio_serve.py
    aio_cls_selfcheck
  test_lmdb, cls_agree,              apps/eval_cls.py
    lmdb_parse_datums, lmdb_bench,
    display_lmdb, gen_lmdb (and the
    streams labeled-npy-src,
    shapes-src, lmdb-src)
  display_test, display_pil,         io/disp.py
    display_raw_vid, ds_test (and
    data-to-img, add-img,
    img-add-text, img-sink)
  (video-src, video-sink)            io/video.py
  (pcap-src, pcap-sink)              io/pcap.py
  test_velo_crc (and velodyne,       io/velodyne.py
    velodyne-gen, velo-frame-gen,
    velo-pcdm-to-xyz)
  (add-img-pts)                      io/render.py
  (rosbag-src, rosbag-sink)          io/rosbag.py
  cnet_tune, fusion_penalty,         apps/cnet_bench.py
    cnet_stage_probe, cnet_bench,
    pyra_bench, train_bench
  cnet_train                         apps/train.py
  mh_test                            parallel/multihost.py
  pp_test                            parallel/pp_modes.py
  ops_prof                           tune/prof.py
  roofline_plot, wis_plot,           tune/plots.py
    op_eff_plot
  wis_merge, wis_ana                 tune/wisdom_modes.py
  cnn_op_info, cnn_prof              tune/opinfo.py
  cnet_xprof                         tune/xprof.py
  blf_pack, conv_pyra                apps/pyra.py
  load_pil, score, score_files,      apps/score.py
    ham_ana
  comp_ndas, test_cmds,              testing/modes.py
    test_compute_multi, test_dense,
    test_upsamp, test_all,
    gen_test_compute_tests,
    gen_ops_prof_tests

plus the engines engine=torch (engine/torch_fwd.py) and engine=ref
(engine/ref_fwd.py) and the backends be=torch (backend/torch_be.py) and
be=interp (backend/interp.py).
"""

from .backend import modes as _backend_modes, ipc  # noqa: F401
from .graph import modes as _graph_modes  # noqa: F401
from .apps import run_cnet  # noqa: F401
from .io import data_stream  # noqa: F401
from .apps import zmq_serve, stream_infer, aio_serve, eval_cls  # noqa: F401
from .io import disp, video, pcap, velodyne, render, rosbag  # noqa: F401
from .apps import cnet_bench, train  # noqa: F401
from .parallel import multihost, pp_modes  # noqa: F401
from .tune import prof, plots, wisdom_modes, opinfo, xprof  # noqa: F401
from .apps import pyra, score  # noqa: F401
from .testing import modes as _testing_modes  # noqa: F401
from .backend import interp, torch_be  # noqa: F401
from .engine import ref_fwd, torch_fwd  # noqa: F401
