"""rtc_test: the backend smoke test on the port.

Port of boda_tpu/backend/modes.py (rtc_test): create three vars, copy two
inputs in, run the `dot` template (c = a * b) through the port's Codegen,
sync, copy c out and check it.
"""

from __future__ import annotations

import numpy as np

from ..core.config import Attr
from ..core.dims import NDA, Dims
from ..core.error import RtErr
from ..core.has_main import HasMain, mode
from ..ops.op_base import OpBase
from ..ops.registry import Codegen
from .iface import Backend


@mode("rtc_test", help="backend smoke test on the port: run the 'dot' "
                       "kernel and verify")
class RtcTest(HasMain):
    rtc = Attr(Backend, default="torch",
               help="backend to test: be=torch (device=cuda by default) or "
                    "be=interp")
    n = Attr(int, default=1024, help="vector length")

    def main(self):
        self.rtc.init()
        cg = Codegen(self.rtc)
        dims = Dims.make(n=self.n)
        for v in ("a", "b", "c"):
            self.rtc.create_var_with_dims(v, dims)
        a = np.arange(self.n, dtype=np.float32) * 0.5
        b = np.ones(self.n, dtype=np.float32) * 2.0
        self.rtc.copy_nda_to_var("a", NDA(dims, a))
        self.rtc.copy_nda_to_var("b", NDA(dims, b))
        op = OpBase({"type": "dot", "func_name": "dot"})
        for v in ("a", "b", "c"):
            op.set_dims(v, dims)
        cid = cg.gen_and_run(op, {"a": "a", "b": "b", "c": "c"})
        self.rtc.finish_and_sync()
        c = self.rtc.copy_var_to_nda("c").v
        if not np.allclose(c, a * b):
            raise RtErr(f"{self.TYPE_ID} FAILED: dot output mismatch")
        dur = self.rtc.get_dur(cid, cid)
        print(f"{self.TYPE_ID} PASSED plat={self.rtc.get_plat_tag()} "
              f"n={self.n} dur={dur * 1e6:.1f}us")
