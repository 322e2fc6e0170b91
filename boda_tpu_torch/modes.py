"""Mode registration hub: importing this module registers the port's CLI
modes, engines and backends (the port's counterpart of boda_tpu/modes.py):

  run_cnet, cnet_predict             apps/run_cnet.py
  cnet_bench                         apps/cnet_bench.py
  test_lmdb, cls_agree (and the      apps/eval_cls.py
    streams labeled-npy-src,
    shapes-src, lmdb-src)
  test_compute_multi, comp_ndas      testing/modes.py
  torch_rtc_test                     backend/modes.py
  torch_ops_prof                     tune/prof.py
  torch_cnn_op_info, torch_cnn_prof  tune/opinfo.py

plus the engines engine=torch (engine/torch_fwd.py) and engine=ref
(engine/ref_fwd.py) and the backends be=torch (backend/torch_be.py) and
be=interp (backend/interp.py).
"""

from .apps import cnet_bench, eval_cls, run_cnet  # noqa: F401
from .backend import interp, modes as _backend_modes, torch_be  # noqa: F401
from .engine import ref_fwd, torch_fwd  # noqa: F401
from .testing import modes as _testing_modes  # noqa: F401
from .tune import opinfo, prof  # noqa: F401
