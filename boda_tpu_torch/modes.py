"""Mode registration hub: importing this module registers the port's CLI
modes, engines, backends and stream stages (the port's counterpart of
boda_tpu/modes.py):

  run_cnet, cnet_predict             apps/run_cnet.py
  cnet_bench, pyra_bench,            apps/cnet_bench.py
    train_bench
  cnet_train                         apps/train.py
  blf_pack, conv_pyra                apps/pyra.py
  aio_cls_server, serve_bench,       apps/aio_serve.py
    aio_cls_selfcheck
  zmq_hello_server, zmq_hello_client,  apps/zmq_serve.py
    zmq_det_stub_server, zmq_cls_server,
    zmq_det_server, zmq_det_client
    (and the stream stage zmq-det)
  test_lmdb, cls_agree (and the      apps/eval_cls.py
    streams labeled-npy-src,
    shapes-src, lmdb-src)
  test_compute_multi, comp_ndas      testing/modes.py
  torch_rtc_test                     backend/modes.py
  torch_ops_prof                     tune/prof.py
  torch_cnn_op_info, torch_cnn_prof  tune/opinfo.py

plus the stream stage cnet-infer (apps/stream_infer.py), the engines
engine=torch (engine/torch_fwd.py) and engine=ref (engine/ref_fwd.py) and
the backends be=torch (backend/torch_be.py) and be=interp
(backend/interp.py).
"""

from .apps import aio_serve, cnet_bench, eval_cls, pyra, run_cnet  # noqa: F401
from .apps import stream_infer, train, zmq_serve  # noqa: F401
from .backend import interp, modes as _backend_modes, torch_be  # noqa: F401
from .engine import ref_fwd, torch_fwd  # noqa: F401
from .testing import modes as _testing_modes  # noqa: F401
from .tune import opinfo, prof  # noqa: F401
