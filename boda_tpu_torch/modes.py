"""Mode registration hub: importing this module registers the port's CLI
modes, engine and backends (the port's counterpart of boda_tpu/modes.py):

  run_cnet, cnet_predict             apps/run_cnet.py
  cls_agree (and stream shapes-src)  apps/eval_cls.py
  torch_rtc_test                     backend/modes.py
  torch_ops_prof                     tune/prof.py
  torch_cnn_op_info, torch_cnn_prof  tune/opinfo.py

plus engine=torch (engine/torch_fwd.py) and the backends be=torch
(backend/torch_be.py) and be=interp (backend/interp.py).
"""

from .apps import eval_cls, run_cnet  # noqa: F401
from .backend import interp, modes as _backend_modes, torch_be  # noqa: F401
from .engine import torch_fwd  # noqa: F401
from .tune import opinfo, prof  # noqa: F401
