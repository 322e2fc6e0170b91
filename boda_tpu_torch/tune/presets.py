"""Measured tuning presets: the selective-int8 site set of a ResNet-family
net, and its calibrated static activation scales.

The port's copy of boda_tpu/tune/presets.py: RESNET_INT8_SITE_PATS,
resnet_int8_site_tunes (:43), save_act_scales (:94) and load_act_scales
(:101), the training site set RESNET_GRAD_Q8_SITE_PATS and
resnet_grad_q8_site_tunes (:27-41; int8 weight gradients on kernel B6),
and a twin of calibrate_int8_act_scales (:54-91) that runs its float
forward through the port's engine (engine/torch_fwd.build_forward) on the
card, or on the CPU where the caller asks.
"""

from __future__ import annotations

import re

from ..ops.cnn_variants import OpTune, make_op_tune

# ResNet-family selective int8, found by a batch-128 sweep of 13 site sets on
# a TPU v5e (the JAX package's presets.py and ROUND3_NOTES.md): int8 on the
# K=9C 3x3 contractions of stages 3-5 and on every stage-4/5 conv (N >= 256);
# the stage-2 convs and the stage-3 1x1s stay float.
RESNET_INT8_SITE_PATS = (r"res3[a-z0-9]*_branch2b",
                         r"res[45][a-z0-9]*_branch.*")

# The training int8 weight-gradient site set, found on a TPU v5e (the JAX
# package's presets.py, scripts/wgrad_int8_probe.py): the 3x3 weight
# gradients of stages 3-5 and the res5 1x1 expansions to 2048, where the
# contraction amortizes the quantize passes; every other 1x1 and stage 2
# stay bf16.
RESNET_GRAD_Q8_SITE_PATS = (r"res[345][a-z0-9]*_branch2b",
                            r"res5[a-z0-9]*_branch2c")


def resnet_grad_q8_site_tunes(pipe, base_tune_spec: str) -> dict[str, OpTune]:
    """Tag→tune map applying int8 WEIGHT-GRADIENT convs (OpTune grad_q8)
    to the measured-winner training site set of a ResNet-family pipe."""
    assert base_tune_spec.endswith(")")
    q = make_op_tune(base_tune_spec[:-1] + ",grad_q8=1)")
    rxs = [re.compile(p) for p in RESNET_GRAD_Q8_SITE_PATS]
    return {op.tag: q for op in pipe.ops.values()
            if op.type == "Convolution"
            and any(rx.fullmatch(op.tag) for rx in rxs)}


def resnet_int8_site_tunes(pipe, base_tune_spec: str) -> dict[str, OpTune]:
    """Tag→tune map applying dynamic int8 to the measured-winner site set
    of a ResNet-family pipe (no-op: returns {} for other nets)."""
    assert base_tune_spec.endswith(")")
    q = make_op_tune(base_tune_spec[:-1] + ",quant8=1)")
    rxs = [re.compile(p) for p in RESNET_INT8_SITE_PATS]
    return {op.tag: q for op in pipe.ops.values()
            if op.type == "Convolution"
            and any(rx.fullmatch(op.tag) for rx in rxs)}


def calibrate_int8_act_scales(pipe, base_tune_spec: str, x,
                              site_tunes: dict[str, OpTune],
                              device: str = "cuda") -> dict[str, OpTune]:
    """Static int8 calibration: run ONE float forward over calibration
    input x (logical NCHW numpy), read each quantized site's INPUT-node
    absmax, and return per-site tunes carrying act_scale — the quant8
    kernels then skip the per-call dynamic activation-max reduction. The
    forward runs on `device` (the card unless the caller asks for cpu)."""
    import copy

    import numpy as np
    import torch

    from ..core.device import get_device
    from ..core.error import RtErr
    from ..engine.lower import lower_pipe
    from ..engine.torch_fwd import build_forward, weights_to_torch

    dev = get_device(device)
    plan = lower_pipe(pipe, make_op_tune(base_tune_spec), fused_storage=True)
    fwd = build_forward(plan, dev, keep_all_nodes=True)
    weights = weights_to_torch(plan, pipe.op_params, dev)
    data_node = pipe.data_img_node_names[0]
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    with torch.no_grad():
        vals = fwd({data_node: xt}, weights)
    out = {}
    for tag, tune in site_tunes.items():
        op = pipe.get_op(tag)
        in_node = op.bots[0]
        if in_node not in vals:
            # guessing a scale (e.g. from the raw image) would silently
            # clip nearly everything — refuse instead
            raise RtErr(f"calibrate_int8_act_scales: input node '{in_node}'"
                        f" of site '{tag}' not in the forward's kept values"
                        " (calibrate with a base tune whose fusion passes"
                        " keep it, e.g. without fuse_resblock/fuse_stem)")
        # OpTune objects are plain attrs — shallow-copy and set the scale
        t2 = copy.copy(tune)
        t2.act_scale = float(vals[in_node].float().abs().max()) or 1e-6
        out[tag] = t2
    return out


def save_act_scales(path, tunes: dict[str, OpTune]) -> None:
    """Persist calibrated per-site activation absmaxes (one lexp/line)."""
    with open(path, "w") as f:
        for tag in sorted(tunes):
            f.write(f"(tag={tag},act_scale={tunes[tag].act_scale!r})\n")


def load_act_scales(path, site_tunes: dict[str, OpTune]) -> dict[str, OpTune]:
    """Apply persisted act scales onto a site-tune map. Reports the
    applied/unmatched counts — a mismatched artifact (wrong model/site
    set) silently running dynamic would masquerade as a static-int8
    measurement."""
    import copy

    from ..core.lexp import parse_lexp
    scales = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            l = parse_lexp(line)
            l.deep_inc_use_cnt()
            scales[l.get_kid("tag").leaf_val] = \
                float(l.get_kid("act_scale").leaf_val)
    out = {}
    applied = 0
    for tag, tune in site_tunes.items():
        t2 = copy.copy(tune)
        if tag in scales:
            t2.act_scale = scales[tag]
            applied += 1
        out[tag] = t2
    unmatched_sites = len(site_tunes) - applied
    unmatched_artifact = len(scales) - applied
    import sys
    # stderr: bench.py's stdout contract is exactly one JSON line
    print(f"act_scales: applied {applied}/{len(site_tunes)} site(s) from "
          f"{path}" + (f" ({unmatched_sites} site(s) stay dynamic, "
                       f"{unmatched_artifact} artifact entr(ies) unused)"
                       if unmatched_sites or unmatched_artifact else ""),
          file=sys.stderr, flush=True)
    return out
