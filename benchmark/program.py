"""The system under test: `boda_tpu_torch`'s engine, built the way its users
build it, and one request through `TorchFwd.run_fwd`.

This is the only file of the benchmark that imports the program. It takes the
program's public entry points only: the zoo builder named by the
configuration, `make_engine` + `init`, `set_input_preproc` with
`device_preproc_fn` (the u8 wire), and `run_fwd`.
"""

from __future__ import annotations

import numpy as np

PROGRAM = "boda_tpu_torch"


class ProgramMissing(RuntimeError):
    pass


def engine_spec(traffic: dict, device: str, scales_fn: str = "") -> str:
    """The engine's configuration string: the traffic's tune, and where it
    declares int8 sites, each site pattern at the tune plus quant8=1 with
    the static activation scales of scales_fn (the selective-int8 preset's
    form)."""
    tune = traffic["tune"]
    spec = f"engine=torch,device={device},op_tune={tune}"
    pats = traffic["precision"].get("int8_sites", [])
    if pats:
        q = tune[:-1] + ",quant8=1)"
        spec += ",op_tunes_pat=(" + ",".join(f"{p}={q}" for p in pats) + ")"
        spec += f",act_scales_fn={scales_fn}"
    return f"({spec})"


class Program:
    """The engine for one cell: the configuration's net at the traffic's
    batch, the benchmark's weights in place of the zoo's, and the u8 wire
    in front of its data node."""

    def __init__(self, config: dict, traffic: dict, weights: dict,
                 batch: int, device: str, scales_fn: str = ""):
        try:
            from boda_tpu_torch.core.dims import NDA, Dims
            from boda_tpu_torch.engine.iface import make_engine
            from boda_tpu_torch.io.device_preproc import device_preproc_fn
            from boda_tpu_torch.models.zoo import build_model
        except ImportError as e:
            raise ProgramMissing(f"the program {PROGRAM} cannot be imported "
                                 f"({e})") from e
        self._NDA = NDA
        _c, h, w = config["input_chw"]
        pipe = build_model(config["zoo_builder"], batch=batch, ysz=h, xsz=w,
                           num_classes=config["num_classes"])
        have = {n: tuple(v.dims.shape) for n, v in pipe.op_params.items()}
        want = {n: tuple(v.shape) for n, v in weights.items()}
        if have != want:
            diff = sorted(set(have.items()) ^ set(want.items()))[:6]
            raise ValueError(f"the program's net {config['zoo_builder']} and "
                             f"the reference disagree on the weights: {diff}")
        for n, v in weights.items():
            pipe.op_params[n] = NDA(pipe.op_params[n].dims,
                                    np.ascontiguousarray(v, np.float32))
        self.eng = make_engine(engine_spec(traffic, device, scales_fn))
        self.eng.init(pipe)
        d = pipe.get_data_img_dims()
        self.wire = Dims.make(tn="uint8_t", img=batch, y=h, x=w, chan=3)
        pre = traffic["preproc"]
        self.data = pipe.data_img_node_names[0]
        self.eng.set_input_preproc(
            self.data, device_preproc_fn(h, w, bgr=pre["bgr"],
                                         mean=tuple(pre["mean_bgr"]),
                                         dtype=d.dtype), self.wire)
        self.logits = config["logits"]

    def request(self, u8: np.ndarray) -> np.ndarray:
        """One batch of (B, H, W, 3) uint8 images in, its (B, classes)
        float32 logits on the host out."""
        out = self.eng.run_fwd({self.data: self._NDA(self.wire, u8)},
                               [self.logits])
        v = out[self.logits].v
        return v.reshape(v.shape[0], -1)
