"""Mode registration hub: importing this module registers the port's CLI
modes, engines, backends and stream stages (the port's counterpart of
boda_tpu/modes.py, whose registry lists the same modes under the same
names, in this order):

  rtc_test                           backend/modes.py
  conv_ana, cnet_ana, cnet_copy,     graph/modes.py
    cnet_fc_to_conv, cnet_resize_conv,
    cnet_bpt_dump, cnet_util
  run_cnet, cnet_predict             apps/run_cnet.py
  zmq_hello_server, zmq_hello_client,  apps/zmq_serve.py
    zmq_det_stub_server, zmq_cls_server,
    zmq_det_server, zmq_det_client
    (and the stream stage zmq-det)
  aio_cls_server, serve_bench,       apps/aio_serve.py
    aio_cls_selfcheck
  test_lmdb, cls_agree (and the      apps/eval_cls.py
    streams labeled-npy-src,
    shapes-src, lmdb-src)
  cnet_tune, fusion_penalty,         apps/cnet_bench.py
    cnet_stage_probe, cnet_bench,
    pyra_bench, train_bench
  cnet_train                         apps/train.py
  ops_prof                           tune/prof.py
  roofline_plot, wis_plot,           tune/plots.py
    op_eff_plot
  wis_merge, wis_ana                 tune/wisdom_modes.py
  cnn_op_info, cnn_prof              tune/opinfo.py
  cnet_xprof                         tune/xprof.py
  blf_pack, conv_pyra                apps/pyra.py
  test_compute_multi, comp_ndas      testing/modes.py

plus the stream stage cnet-infer (apps/stream_infer.py), the engines
engine=torch (engine/torch_fwd.py) and engine=ref (engine/ref_fwd.py) and
the backends be=torch (backend/torch_be.py) and be=interp
(backend/interp.py).
"""

from .backend import modes as _backend_modes  # noqa: F401
from .graph import modes as _graph_modes  # noqa: F401
from .apps import run_cnet, zmq_serve, stream_infer  # noqa: F401
from .apps import aio_serve, eval_cls, cnet_bench, train  # noqa: F401
from .tune import prof, plots, wisdom_modes, opinfo, xprof  # noqa: F401
from .apps import pyra  # noqa: F401
from .testing import modes as _testing_modes  # noqa: F401
from .backend import interp, torch_be  # noqa: F401
from .engine import ref_fwd, torch_fwd  # noqa: F401
