"""cnet_train: the trainer (SGD, momentum or Adam over labeled data
or a seeded synthetic set), its solver snapshots and trained-weights
outputs.

The port's copy of boda_tpu/apps/train.py. One step is the fused forward
(engine/torch_fwd.build_forward, the plan lowered with fused storage, as
the JAX trainer lowers it) under autograd: the vendor convs carry the
mixed-precision VJP of ops/mxu_grad (bf16 grad convs, f32 master weights;
grad_q8 sites take the int8 weight gradient on kernel B6), the other
templates differentiate as torch ops, and a template with no backward
raises before the first step (mxu_grad.check_trainable). Then the JAX
step's order: global-norm clip, L2 weight decay (decay_mult), lr_mult, and
the SGD / momentum / Adam update. The step is functional (new weight and
state tensors), as the JAX step is.

Against the JAX package: batches come from the same numpy RandomState
(saved in snapshots), so a run of either package sees the same data; the
snapshot, the trained-weights artifact and the caffemodel/prototxt outputs
are byte-compatible with the JAX package's writers, in both directions.
`steps_per_call` runs K steps per call with their batches uploaded
together and the losses read back once (JAX's scan; the same losses as
K=1). `device_data` stages the u8 set on the card and gathers and
preprocesses each batch there. Resume is bit-identical on the card: the
trainer runs with cuDNN's deterministic algorithms (its default weight-
gradient algorithms are not), and on the CPU. The mode runs on the card
unless `device=cpu` is given.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.config import Attr
from ..core.dims import NDA
from ..core.error import RtErr
from ..core.has_main import mode
from ..core.lexp import parse_lexp
from ..graph.modes import _NetMode
from ..io.data_stream import DataBlock, DataStream
from ..ops.cnn_variants import OpTune

OPTIMIZERS = ("sgd", "momentum", "adam")


def init_opt_state(optimizer: str, weights: dict) -> dict:
    """Optimizer state for build_train_step's `vel` argument, of the
    weights' kind (torch tensors on their device, or numpy arrays). SGD is
    stateless (an empty dict: no weight-sized copies)."""
    import torch

    def zeros(v):
        return torch.zeros_like(v) if isinstance(v, torch.Tensor) \
            else np.zeros_like(v)
    if optimizer == "momentum":
        return {"v": {k: zeros(v) for k, v in weights.items()}}
    if optimizer == "adam":
        v0 = next(iter(weights.values()), None)
        t = torch.zeros((), dtype=torch.float32, device=v0.device) \
            if isinstance(v0, torch.Tensor) else np.float32(0)
        return {"m": {k: zeros(v) for k, v in weights.items()},
                "v": {k: zeros(v) for k, v in weights.items()}, "t": t}
    return {}


def batch_loss(fwd, data_node: str, top: str, from_logits: bool, w: dict,
               xb, labels, seed_node: str = "", seed_t=None):
    """The training loss of one batch: the batch mean of softmax
    cross-entropy of fwd({data_node: xb[, seed_node: seed_t]}, w)[top]
    (spatial means where it is 4-d), through log_softmax where
    from_logits, else log(max(p, 1e-30)); a 0-d f32 tensor."""
    import torch
    ins = {data_node: xb}
    if seed_node:
        if seed_t is None:
            raise RtErr("build_train_step: plan has a dropout seed input — "
                        "pass seed_t (global step)")
        ins[seed_node] = torch.as_tensor(seed_t, dtype=torch.int32,
                                         device=xb.device).reshape(1)
    p = fwd(ins, w)[top]
    if p.dim() == 4:
        p = p.mean(dim=(2, 3))
    p = p.float()
    logp = torch.log_softmax(p, dim=1) if from_logits \
        else torch.log(p.clamp_min(1e-30))
    return -torch.take_along_dim(logp, labels.long()[:, None], dim=1).mean()


def build_train_step(fwd, data_node: str, top: str, *, lr: float,
                     optimizer: str = "sgd", momentum: float = 0.9,
                     from_logits: bool = False, clip_gradients: float = 0.0,
                     weight_decay: float = 0.0, seed_node: str = "",
                     param_mults: dict = None, grad_reduce=None):
    """Shared fwd+bwd+update step (used by cnet_train and train_bench):
    step(w, vel, xb, labels[, lr_t[, seed_t]]) -> (loss, new_w, new_vel),
    on tensors of one device: w {name: f32 master weight}, vel
    init_opt_state(optimizer, w), xb the data node's logical input, labels
    int; `fwd(inputs, weights) -> {top: logits or probs}`. The loss is
    batch_loss (log_softmax where `top` is the pre-softmax logits node —
    log(prob) has zero gradient once the softmax saturates). Then, as the
    JAX step: global-norm clipping (caffe
    clip_gradients), L2 `weight_decay` times each param's decay_mult,
    lr_mult on the regularized gradient (lr_mult=0 freezes the blob and
    keeps its optimizer state at zero), and SGD, heavy-ball momentum (v' =
    mu*v + g; w' = w - lr*v') or Adam. `param_mults`: {weight name:
    (lr_mult, decay_mult)}. `lr_t` (an f32 tensor or number) overrides lr
    per call (schedules); `seed_t`, the global step index, feeds the
    dropout seed input `seed_node` of a plan lowered train_dropout=1.
    `grad_reduce({name: grad}) -> {name: grad}`, where given, runs on the
    raw gradients first: under a mesh over several processes (fwd a
    mesh forward, parallel/mesh.sum_over_ranks) it sums each process's
    share, as GSPMD's psum did. Returns the loss as a 0-d tensor (not read
    back)."""
    import torch

    if optimizer not in OPTIMIZERS:
        raise RtErr(f"unknown optimizer '{optimizer}' "
                    f"({' | '.join(OPTIMIZERS)})")
    pm = param_mults or {}
    has_mults = any(tuple(m) != (1.0, 1.0) for m in pm.values())

    def mult(k, ix):
        return float(pm.get(k, (1.0, 1.0))[ix])

    def step(w, vel, xb, labels, lr_t=None, seed_t=None):
        # leaves sorted by name, the order of JAX's tree_leaves (the clip
        # norm's sum order)
        names = sorted(w)
        wr = {k: w[k].detach().requires_grad_(True) for k in names}
        with torch.enable_grad():
            loss = batch_loss(fwd, data_node, top, from_logits, wr, xb,
                              labels, seed_node, seed_t)
            gl = torch.autograd.grad(loss, [wr[k] for k in names],
                                     allow_unused=True)
        with torch.no_grad():
            grads = {k: torch.zeros_like(w[k]) if g is None else g
                     for k, g in zip(names, gl)}
            if grad_reduce is not None:
                grads = grad_reduce(grads)
            if clip_gradients:
                gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                       for g in grads.values()))
                scale = torch.clamp(
                    clip_gradients / torch.clamp(gnorm, min=1e-12), max=1.0)
                grads = {k: (g.float() * scale).to(g.dtype)
                         for k, g in grads.items()}
            if weight_decay:
                grads = {k: (g.float() + weight_decay * mult(k, 1)
                             * w[k].float()).to(g.dtype)
                         for k, g in grads.items()}
            if has_mults:
                grads = {k: (g.float() * mult(k, 0)).to(g.dtype)
                         for k, g in grads.items()}
            if optimizer == "momentum":
                vel = {"v": {k: momentum * vel["v"][k]
                             + grads[k].to(vel["v"][k].dtype)
                             for k in names}}
                upd = vel["v"]
            elif optimizer == "adam":
                b1, b2, eps = 0.9, 0.999, 1e-8
                t = vel["t"] + 1
                m = {k: b1 * vel["m"][k] + (1 - b1) * grads[k]
                     for k in names}
                v = {k: b2 * vel["v"][k] + (1 - b2) * torch.square(grads[k])
                     for k in names}
                bc1 = 1 - torch.pow(b1, t)
                bc2 = 1 - torch.pow(b2, t)
                upd = {k: (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
                       for k in names}
                vel = {"m": m, "v": v, "t": t}
            else:
                upd = grads
            lr_v = lr if lr_t is None else torch.as_tensor(
                lr_t, dtype=torch.float32, device=xb.device)
            new_w = {k: w[k] - lr_v * upd[k].to(w[k].dtype) for k in names}
        return loss.detach(), new_w, vel

    return step


WTS_MAGIC = b"boda_tpu_trained_weights_v1\n"


def _bf16_bits_to_f32(raw: np.ndarray) -> np.ndarray:
    return (raw.astype(np.uint32) << 16).view(np.float32)


def _f32_to_bf16_bits(v: np.ndarray) -> np.ndarray:
    """bf16 bit patterns of f32 values, rounded to nearest even (NaN to the
    quiet NaN 0x7fc0): the bytes ml_dtypes' bfloat16 writes for finite
    values."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    out = ((bits + (((bits >> 16) & 1) + 0x7FFF)) >> 16).astype(np.uint16)
    return np.where(np.isnan(v), np.uint16(0x7FC0), out)


def write_weights_artifact(path, weights: dict, *, dtype: str = "bf16",
                           meta: str = "") -> None:
    """Compact trained-weights artifact: {param blob name: array} in the
    pipe's op_params layout (caffe blob order), stored bf16 by default
    (training computes in bf16, so the bf16-rounded master weights are the
    deployed numerics) or f32. Not a caffemodel: caffe protobuf carries f32
    only, and this artifact's job is exact, compact round-tripping of the
    trained state. The bytes are the JAX package's writer's."""
    if dtype not in ("bf16", "f32"):
        raise RtErr(f"write_weights_artifact: dtype must be bf16|f32, "
                    f"got '{dtype}'")
    with open(path, "wb") as f:
        f.write(WTS_MAGIC)
        f.write(f"(n={len(weights)},dtype={dtype},meta={meta})\n".encode())
        for name in sorted(weights):
            v = np.asarray(weights[name], np.float32)
            raw = _f32_to_bf16_bits(v) if dtype == "bf16" else v
            nb = name.encode()
            f.write(len(nb).to_bytes(4, "little") + nb)
            f.write(len(v.shape).to_bytes(1, "little"))
            for s in v.shape:
                f.write(int(s).to_bytes(4, "little"))
            f.write(np.ascontiguousarray(raw).tobytes())


def read_weights_artifact(path) -> dict:
    """-> {name: f32 array}. Raises RtErr on bad magic / truncation."""
    buf = open(path, "rb").read()
    if not buf.startswith(WTS_MAGIC):
        raise RtErr(f"'{path}' is not a boda_tpu trained-weights artifact")
    try:
        off = len(WTS_MAGIC)
        eol = buf.index(b"\n", off)
        hdr = parse_lexp(buf[off:eol].decode())
        hdr.deep_inc_use_cnt()
        n = int(hdr.get_kid("n").leaf_val)
        dtype = hdr.get_kid("dtype").leaf_val
        off = eol + 1
        out = {}
        for _ in range(n):
            ln = int.from_bytes(buf[off:off + 4], "little")
            off += 4
            name = buf[off:off + ln].decode()
            off += ln
            nd = buf[off]
            off += 1
            shape = []
            for _d in range(nd):
                shape.append(int.from_bytes(buf[off:off + 4], "little"))
                off += 4
            cnt = int(np.prod(shape)) if shape else 1
            if dtype == "bf16":
                v = _bf16_bits_to_f32(np.frombuffer(buf, np.uint16, cnt, off))
                off += 2 * cnt
            else:
                v = np.frombuffer(buf, np.float32, cnt, off).copy()
                off += 4 * cnt
            out[name] = v.reshape(shape)
        return out
    except RtErr:
        raise
    except Exception as e:
        raise RtErr(f"trained-weights artifact '{path}' is truncated or "
                    f"corrupt: {type(e).__name__}: {e}")


def load_weights_into_pipe(pipe, path) -> None:
    """Apply a trained-weights artifact onto pipe.op_params (validating
    the name/shape sets match the pipe's parameter blobs)."""
    w = read_weights_artifact(path)
    missing = sorted(set(pipe.op_params) - set(w))[:4]
    if missing:
        raise RtErr(f"weights artifact '{path}' missing params {missing}")
    for name, v in w.items():
        nda = pipe.op_params.get(name)
        if nda is None:
            raise RtErr(f"weights artifact '{path}' has param '{name}' "
                        f"unknown to this net")
        if tuple(nda.dims.shape) != v.shape:
            raise RtErr(f"weights artifact '{path}': param '{name}' shape "
                        f"{v.shape} != net's {tuple(nda.dims.shape)}")
        pipe.op_params[name] = NDA(nda.dims, v.astype(nda.dims.dtype))


SNAP_MAGIC = b"boda_tpu_snapshot_v1\n"


def write_snapshot(path, *, step: int, optimizer: str, consumed: int,
                   weights: dict, vel: dict, losses: list,
                   rng_state) -> None:
    """Solver snapshot (caffe's .solverstate role), byte for byte the JAX
    package's format (the NDA bwrite convention, core/dims.py): step
    counter, stream-consumption count (for deterministic stream resume by
    skip-with-wrap), weights, optimizer state (flattened by path), loss
    history, and the numpy RNG state (bit-identical synthetic-data
    resume). Arrays are numpy (the caller reads tensors back first)."""
    from ..core.dims import Dims

    def nda1(v, tn):
        v = np.atleast_1d(np.asarray(v))
        return NDA(Dims.make(tn=tn, v=max(v.size, 1)),
                   v if v.size else np.zeros(1, v.dtype))

    def nda_nd(v):
        v = np.atleast_1d(np.asarray(v, np.float32))
        return NDA.from_array(v, [f"d{i}" for i in range(v.ndim)])

    entries = [("losses", nda1(np.asarray(losses, np.float64), "double")),
               ("rng/keys", nda1(rng_state[1].astype(np.uint32), "uint32_t")),
               ("rng/meta", nda1(np.asarray(
                   [rng_state[2], rng_state[3]], np.int64), "int64_t")),
               ("rng/gauss", nda1(np.asarray(
                   [rng_state[4]], np.float64), "double"))]
    for k, v in sorted(weights.items()):
        entries.append((f"w/{k}", nda_nd(v)))
    for k, v in sorted(_flatten_opt(vel).items()):
        entries.append((f"opt/{k}", nda_nd(v)))
    # write-to-temp + atomic rename: a crash mid-write must not destroy
    # the previous (only) checkpoint — the exact scenario snapshots are for
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(SNAP_MAGIC)
        f.write(f"(step={step},optimizer={optimizer},"
                f"consumed={consumed},n_losses={len(losses)},"
                f"n={len(entries)})\n".encode())
        for name, nda in entries:
            nb = name.encode()
            f.write(len(nb).to_bytes(4, "little") + nb + nda.bwrite())
    os.replace(tmp, path)


def read_snapshot(path) -> dict:
    """→ dict(step, optimizer, consumed, weights, opt_flat, losses,
    rng_state), numpy arrays. Raises RtErr on a non-snapshot, truncated, or
    corrupt file (a half-written file is the expected failure artifact of a
    crash, so it must surface as a clean error, not a traceback)."""
    buf = open(path, "rb").read()
    if not buf.startswith(SNAP_MAGIC):
        raise RtErr(f"'{path}' is not a boda_tpu snapshot "
                    f"(bad magic)")

    def want(hdr, k):
        kid = hdr.get_kid(k)
        if kid is None:
            raise RtErr(f"snapshot '{path}': header missing '{k}'")
        return kid.leaf_val

    try:
        off = len(SNAP_MAGIC)
        eol = buf.index(b"\n", off)
        hdr = parse_lexp(buf[off:eol].decode())
        off = eol + 1
        step = int(want(hdr, "step"))
        optimizer = want(hdr, "optimizer")
        consumed = int(want(hdr, "consumed"))
        n_losses = int(want(hdr, "n_losses"))
        n = int(want(hdr, "n"))
        ent = {}
        for _ in range(n):
            ln = int.from_bytes(buf[off:off + 4], "little")
            off += 4
            name = buf[off:off + ln].decode()
            off += ln
            nda, off = NDA.bread(buf, off)
            ent[name] = nda
        keys = ent["rng/keys"].v.astype(np.uint32)
        pos, has_gauss = (int(x) for x in ent["rng/meta"].v)
        rng_state = ("MT19937", keys, pos, has_gauss,
                     float(ent["rng/gauss"].v[0]))
        return {"step": step, "optimizer": optimizer,
                "consumed": consumed,
                "losses": [float(v) for v in ent["losses"].v][:n_losses],
                "rng_state": rng_state,
                "weights": {k[2:]: v.v for k, v in ent.items()
                            if k.startswith("w/")},
                "opt_flat": {k[4:]: v.v for k, v in ent.items()
                             if k.startswith("opt/")}}
    except RtErr:
        raise
    except Exception as e:
        raise RtErr(f"snapshot '{path}' is truncated or corrupt: "
                    f"{type(e).__name__}: {e}")


def _flatten_opt(vel: dict) -> dict:
    """Opt-state tree → flat {path: leaf} (paths like 'v/conv1_w',
    'm/conv1_w', 't')."""
    flat = {}

    def rec(prefix, x):
        if isinstance(x, dict):
            for k, v in x.items():
                rec(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = x
    rec("", vel)
    return flat


def _unflatten_opt(optimizer: str, weights: dict, flat: dict) -> dict:
    """Rebuild the opt-state tree (numpy) from a flat snapshot dict,
    validating leaf coverage against a fresh init_opt_state skeleton of
    the (numpy) weights."""
    skel = init_opt_state(optimizer, weights)
    want = _flatten_opt(skel)
    if set(want) != set(flat):
        missing = sorted(set(want) ^ set(flat))[:4]
        raise RtErr(f"snapshot optimizer state doesn't match "
                    f"optimizer '{optimizer}' (mismatched leaves: "
                    f"{missing})")

    def rec(prefix, x):
        if isinstance(x, dict):
            return {k: rec(f"{prefix}/{k}" if prefix else k, v)
                    for k, v in x.items()}
        v = flat[prefix]
        return v.reshape(np.shape(x)).astype(np.asarray(x).dtype) \
            if np.shape(x) else v.reshape(()).astype(np.asarray(x).dtype)
    return rec("", skel)


def _tree_map(fn, x):
    """fn over the leaves of an opt-state / weights tree of dicts."""
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    return fn(x)


def check_labels(labels, n_classes: int, what: str) -> None:
    """Out-of-range labels would index past the logits (and in the JAX
    package turn into NaN losses) — refuse them up front."""
    mx = int(np.max(labels)) if len(labels) else 0
    if mx >= n_classes or int(np.min(labels) if len(labels) else 0) < 0:
        raise RtErr(f"{what}: label {mx} out of range for {n_classes} "
                    f"output classes (labels must be in [0,{n_classes}))")


def train_top(pipe, plan) -> tuple[str, bool]:
    """(the node the loss reads, from_logits): the plan's prob output, or
    its last; where a Softmax op makes it, that op's input (the logits),
    trained through log_softmax — log(prob) has zero gradient once the
    softmax saturates."""
    top = "prob" if "prob" in plan.output_nodes else plan.output_nodes[-1]
    top_op = next((op for op in pipe.ops.values() if top in op.tops), None)
    if top_op is not None and top_op.type == "Softmax":
        return top_op.bots[0], True
    return top, False


def train_forward(plan, device, top: str):
    """fwd(inputs, weights) -> {top: ...} on build_forward, with `top` asked
    for where it is not a plan output (the logits node): keep_all_nodes
    would keep every intermediate alive."""
    from ..engine.torch_fwd import build_forward
    fwd = build_forward(plan, device)
    extra = () if top in plan.output_nodes else (top,)

    def run(inputs, weights):
        return fwd(inputs, weights, out_nodes=extra)
    return run


def deterministic_cudnn():
    """The trainer's cuDNN settings: deterministic algorithms (its default
    weight-gradient algorithms are not, and resume must be bit-identical),
    no benchmark search; TF32 as the caller left it."""
    import torch
    return torch.backends.cudnn.flags(
        enabled=True, benchmark=False, deterministic=True,
        allow_tf32=torch.backends.cudnn.allow_tf32)


@mode("cnet_train", help="train a net: fwd+bwd+update steps over a labeled "
                         "stream (or synthetic data) on the card")
class CnetTrain(_NetMode):
    op_tune = Attr(OpTune,
                   default="(use_culibs=1,prec=bf16,layout=nhwc,s2d=0,"
                           "fuse_siblings=1)",
                   help="tune record (bf16: mixed-precision training via "
                        "the ops/mxu_grad conv VJP)")
    op_tunes_pat = Attr(dict[str, str], default=None,
                        help="per-op tune overrides by TAG REGEX (e.g. "
                             "grad_q8=1 on a site set: int8 weight-"
                             "gradient training on kernel B6)")
    device = Attr(str, default="cuda", help="torch device: cuda[:i] or cpu")
    stream = Attr(DataStream, default=None,
                  help="labeled data source, e.g. (mode=lmdb-src,"
                       "fn=...,mean=128); blocks must match the net's "
                       "chan/y/x; labels ride the 'label' subblock. "
                       "Default: deterministic synthetic data")
    steps = Attr(int, default=20)
    lr = Attr(float, default=0.01)
    optimizer = Attr(str, default="sgd", help="sgd | momentum | adam")
    momentum = Attr(float, default=0.9)
    clip_gradients = Attr(float, default=0.0,
                          help="global-L2-norm gradient clipping threshold "
                               "(caffe SolverParameter.clip_gradients "
                               "semantics; 0 = off)")
    weight_decay = Attr(float, default=0.0,
                        help="L2 regularization strength (caffe "
                             "SolverParameter.weight_decay semantics: "
                             "g += wd*w before the momentum update; "
                             "0 = off)")
    num_classes = Attr(int, default=0,
                       help="label range for synthetic data (default: "
                            "the net's output channels)")
    train_dropout = Attr(bool, default=True,
                         help="lower Dropout ops in train mode "
                              "(deterministic seed-keyed masks — the "
                              "reference's det-dropout semantics); 0 = "
                              "inference-mode identity")
    log_every = Attr(int, default=5)
    loss_out_fn = Attr(str, default="", help="write one loss per line")
    weights_out_fn = Attr(str, default="",
                          help="export trained weights as a caffemodel")
    prototxt_out_fn = Attr(str, default="",
                           help="also export the net structure as a "
                                "prototxt (so the trained model round-"
                                "trips through the caffe importer)")
    artifact_out_fn = Attr(str, default="",
                           help="export trained weights as a compact bf16 "
                                "trained-weights artifact "
                                "(write_weights_artifact)")
    warmup_steps = Attr(int, default=0,
                        help="linear LR warmup over this many steps "
                             "(0 = constant lr) — deep BN-folded nets "
                             "trained from scratch need it")
    lr_policy = Attr(str, default="fixed",
                     help="caffe SolverParameter.lr_policy: fixed | "
                          "step (lr*gamma^floor(i/stepsize)) | exp "
                          "(lr*gamma^i) | poly (lr*(1-i/steps)^power) | "
                          "multistep (lr*gamma^#stepvalues-passed); "
                          "composes with warmup_steps")
    gamma = Attr(float, default=0.1, help="step/exp/multistep decay factor")
    stepsize = Attr(int, default=0, help="step policy period (required)")
    power = Attr(float, default=1.0, help="poly policy exponent")
    stepvalue = Attr(list[int], default=None,
                     help="multistep policy boundaries, e.g. '4000 6000'")
    zero_init_pats = Attr(list[str], default=None,
                          help="zero the filts of convs matching these "
                               "tag regexes before training (fixup-style "
                               "residual init, e.g. 'res.*_branch2c': "
                               "each residual block starts as identity, "
                               "which lets BN-folded resnets train from "
                               "scratch)")
    steps_per_call = Attr(int, default=1,
                          help="run this many optimizer steps per call, "
                               "their batches uploaded together and their "
                               "losses read back once; steps and "
                               "snapshot_every must be multiples of it")
    seed = Attr(int, default=0)
    snapshot_every = Attr(int, default=0,
                          help="write a solver snapshot (weights + "
                               "optimizer state + RNG + stream position) "
                               "every N steps and at the end; 0 = off")
    snapshot_fn = Attr(str, default="snapshot.boda",
                       help="rolling snapshot filename")
    resume_fn = Attr(str, default="",
                     help="resume from this snapshot: training continues "
                          "to --steps total steps, bit-identical to an "
                          "uninterrupted run (synthetic data via the "
                          "saved RNG state; streams via deterministic "
                          "skip-with-wrap to the saved position)")
    device_data = Attr(bool, default=False,
                       help="stage the ENTIRE dataset on the device once "
                            "(uint8 when the stream's mean/scale transform "
                            "is invertible) and gather batches + apply the "
                            "preprocessing there; batch order and "
                            "preprocessing match the streaming path")
    eval_stream = Attr(DataStream, default=None,
                       help="held-out labeled stream: staged on the device "
                            "like device_data and scored (top-1) every "
                            "eval_every steps and at the end")
    eval_every = Attr(int, default=0,
                      help="validation cadence in steps (0 = only at end; "
                           "requires eval_stream)")

    def _next_batch(self, d, rng, n_classes):
        """→ (x (img,chan,y,x) f32, labels (img,) i32). Stream blocks
        cycle (re-init on exhaustion) so steps > dataset size works."""
        if self.stream is None:
            x = (rng.randn(*d.shape) * 0.1).astype(np.float32)
            labels = rng.randint(0, n_classes, size=(d["img"],))
            return x, labels.astype(np.int32)
        xs, ls = [], []
        while len(xs) < d["img"]:
            db = self._next_stream_block()
            v = np.asarray(db.nda.v, np.float32)
            if v.shape != tuple(d.shape[1:]):
                raise RtErr(f"cnet_train: stream block shape {v.shape} != "
                            f"net input {tuple(d.shape[1:])} — resize the "
                            f"stream or set in_dims to match")
            lab = db.get_sdb("label")
            if lab is None:
                raise RtErr("cnet_train: stream block has no 'label' "
                            "subblock (use a labeled source)")
            xs.append(v)
            ls.append(int(np.asarray(lab.nda.v).reshape(-1)[0]))
        return np.stack(xs), np.asarray(ls, np.int32)

    def _stage_stream_on_device(self, stream, d, what: str):
        """Drain `stream` once and stage it on the device:
        → (ds (N,chan,y,x) u8|f32 tensor, labels (N,) int64 tensor, numpy
        labels, mean, scale) where the logical input is (ds.float() - mean)
        * scale — the host preprocessing ((u8 - mean) * scale in f32) when
        the stream's transform is invertible (pixels recover exactly as
        uint8), else staged as raw f32 with mean=0/scale=1."""
        import torch
        stream.data_stream_init()
        m = getattr(stream, "mean", None)
        s = getattr(stream, "scale", None)
        invertible = isinstance(m, float) and isinstance(s, float) and s
        imgs, labels = [], []
        while True:
            db = stream.proc_block(DataBlock())
            if not db.valid():
                break
            v = np.asarray(db.nda.v, np.float32)
            if v.shape != tuple(d.shape[1:]):
                raise RtErr(f"cnet_train {what}: stream block shape "
                            f"{v.shape} != net input {tuple(d.shape[1:])}")
            lab = db.get_sdb("label")
            if lab is None:
                raise RtErr(f"cnet_train {what}: stream block has no "
                            f"'label' subblock (use a labeled source)")
            if invertible:
                u = v / s + m
                ui = np.rint(u)
                if abs(u - ui).max() < 1e-3 and ui.min() >= 0 \
                        and ui.max() <= 255:
                    v = ui.astype(np.uint8)
                else:
                    raise RtErr(
                        f"cnet_train {what}: stream transform "
                        f"(mean={m},scale={s}) doesn't invert to uint8 "
                        f"pixels — stage a u8-exact stream or use the "
                        f"host streaming path")
            imgs.append(v)
            labels.append(int(np.asarray(lab.nda.v).reshape(-1)[0]))
        if not imgs:
            raise RtErr(f"cnet_train {what}: stream yielded no blocks")
        mean, scale = (float(m), float(s)) if invertible else (0.0, 1.0)
        ds = torch.from_numpy(np.stack(imgs)).to(self._dev)
        labs_np = np.asarray(labels, np.int32)
        labs = torch.from_numpy(labs_np.astype(np.int64)).to(self._dev)
        kind = "u8" if invertible else "f32"
        nbytes = ds.numel() * ds.element_size()
        print(f"{what}: staged {len(imgs)} {kind} images "
              f"({nbytes / 1e6:.0f} MB) on device", flush=True)
        return ds, labs, labs_np, mean, scale

    def _log_losses(self, i: int, new_losses, losses) -> int:
        for dloss in new_losses:
            losses.append(dloss)
            i += 1
            if not np.isfinite(dloss):
                raise RtErr(f"cnet_train: non-finite loss at step "
                            f"{i - 1}: {dloss} (reduce --lr)")
            if i % self.log_every == 0 or i == self.steps:
                print(f"step {i:4d}/{self.steps}: "
                      f"loss={dloss:.5f}", flush=True)
        return i

    def _eval_count(self, fwd, weights, ev, data_node, top, b) -> int:
        """Top-1 correct count over a device-staged (ds, labels) in
        net-batch slices (the short final batch zero-padded, its padding
        never counted), under the inference forward."""
        import torch
        ds, labs, _, mean, scale = ev
        n = ds.shape[0]
        pos = torch.zeros((), dtype=torch.int64, device=self._dev)
        with torch.no_grad():
            for i0 in range(0, n, b):
                nb = min(b, n - i0)
                xb = (ds[i0:i0 + nb].float() - mean) * scale
                if nb < b:
                    xb = torch.cat([xb, xb.new_zeros((b - nb,)
                                                     + tuple(xb.shape[1:]))])
                p = fwd({data_node: xb}, weights)[top]
                if p.dim() == 4:
                    p = p.mean(dim=(2, 3))
                pred = p.float().argmax(dim=1)[:nb]
                pos += (pred == labs[i0:i0 + nb]).sum()
        return int(pos)

    def _print_eval(self, eval_fn, weights, ev, i: int) -> None:
        pos = eval_fn(weights)
        n = int(ev[0].shape[0])
        self._last_eval = (pos, n)
        print(f"eval @ step {i}: top_1_acc={pos / n:g} "
              f"num_pos={pos} num_test={n}", flush=True)

    def _next_stream_block(self) -> DataBlock:
        """One valid stream block, wrapping on EOF; counts consumed
        blocks so snapshots can restore the stream position by replaying
        the same skip-with-wrap sequence."""
        db = self.stream.proc_block(DataBlock())
        if not db.valid():
            self.stream.data_stream_init()  # wrap around (epoch)
            db = self.stream.proc_block(DataBlock())
            if not db.valid():
                raise RtErr("cnet_train: stream yielded no blocks")
        self._consumed += 1
        return db

    def _write_snapshot(self, i, weights, vel, losses, rng) -> None:
        write_snapshot(
            self.out_path(self.snapshot_fn), step=i,
            optimizer=self.optimizer, consumed=self._consumed,
            weights={k: v.cpu().numpy() for k, v in weights.items()},
            vel=_tree_map(lambda v: v.cpu().numpy(), vel),
            losses=losses, rng_state=rng.get_state())

    def main(self):
        import torch

        from ..core.device import get_device
        from ..engine.lower import DROP_SEED_NODE, lower_pipe
        from ..engine.torch_fwd import pat_tunes, weights_to_torch
        from ..graph.modes import _load_pipe
        from ..ops.mxu_grad import check_trainable

        if self.optimizer not in OPTIMIZERS:
            raise RtErr(f"cnet_train: unknown optimizer '{self.optimizer}' "
                        f"({' | '.join(OPTIMIZERS)})")
        if self.steps < 1:
            raise RtErr("cnet_train: steps must be >= 1")
        dev = self._dev = get_device(self.device)
        pipe = _load_pipe(self)
        if self.zero_init_pats:
            import re

            rxs = [re.compile(p) for p in self.zero_init_pats]
            nz = 0
            for op in pipe.ops.values():
                if op.type not in ("Convolution", "Deconvolution",
                                   "InnerProduct") or len(op.bots) < 2:
                    continue
                if any(rx.fullmatch(op.tag) for rx in rxs):
                    nda = pipe.op_params.get(op.bots[1])
                    if nda is not None:
                        pipe.op_params[op.bots[1]] = \
                            NDA(nda.dims, np.zeros_like(nda.v))
                        nz += 1
            if not nz:
                raise RtErr("cnet_train: zero_init_pats matched no "
                            "weighted ops")
            print(f"zero-initialized filts of {nz} op(s) "
                  f"(fixup-style residual init)", flush=True)
        op_tunes = pat_tunes(pipe, self.op_tunes_pat or {})
        if self.op_tunes_pat:
            print(f"op_tunes_pat: tuned {len(op_tunes)} op(s)", flush=True)
        plan = lower_pipe(pipe, self.op_tune, op_tunes=op_tunes,
                          fused_storage=True,
                          train_dropout=self.train_dropout)
        check_trainable(plan.steps, "cnet_train")
        self._plan = plan
        weights = weights_to_torch(plan, pipe.op_params, dev)
        data_node = pipe.data_img_node_names[0]
        top, from_logits = train_top(pipe, plan)
        fwd = train_forward(plan, dev, top)
        d = pipe.get_data_img_dims()
        n_classes = self.num_classes or plan.node_dims[top].shape[1]
        n_out = plan.node_dims[top].shape[1]
        b = d["img"]
        if self.device_data:
            if self.stream is None:
                raise RtErr("cnet_train: device_data=1 requires a stream "
                            "(synthetic batches are host-generated)")
            ds_dev, labs_dev, labs_np, ds_mean, ds_scale = \
                self._stage_stream_on_device(self.stream, d, "train set")
            check_labels(labs_np, n_out, "cnet_train")
            n_ds = int(ds_dev.shape[0])
        elif self.stream is not None:
            self.stream.data_stream_init()
        ev = None
        eval_fn = None
        if self.eval_stream is not None:
            ev = self._stage_stream_on_device(self.eval_stream, d,
                                              "eval set")
            check_labels(ev[2], n_out, "cnet_train eval")
            # evaluation runs the INFERENCE forward (dropout = identity);
            # the trained weights feed it directly (same weight nodes —
            # dropout lowering adds none)
            plan_ev = lower_pipe(pipe, self.op_tune, op_tunes=op_tunes,
                                 fused_storage=True)
            fwd_ev = train_forward(plan_ev, dev, top)

            def eval_fn(w):
                return self._eval_count(fwd_ev, w, ev, data_node, top, b)
        elif self.eval_every:
            raise RtErr("cnet_train: eval_every requires eval_stream")
        self._consumed = 0
        rng = np.random.RandomState(self.seed)
        seed_node = DROP_SEED_NODE \
            if DROP_SEED_NODE in plan.input_nodes else ""
        # caffe ParamSpec mults (imported prototxts; zoo nets have none):
        # map pipe.param_mults through any weight-transform aliasing
        mults = {}
        for n in weights:
            src = plan.weight_transforms.get(n, (n, None))[0]
            if src in pipe.param_mults:
                mults[n] = pipe.param_mults[src]
        if mults:
            print(f"honoring caffe param mults on {len(mults)} "
                  f"weight blob(s)", flush=True)
        step = build_train_step(
            fwd, data_node, top, lr=self.lr, optimizer=self.optimizer,
            momentum=self.momentum, from_logits=from_logits,
            clip_gradients=self.clip_gradients,
            weight_decay=self.weight_decay, seed_node=seed_node,
            param_mults=mults)

        vel = init_opt_state(self.optimizer, weights)
        losses = []
        start = 0
        if self.resume_fn:
            snap = read_snapshot(self.resume_fn)
            if snap["optimizer"] != self.optimizer:
                raise RtErr(f"cnet_train: snapshot was taken with "
                            f"optimizer '{snap['optimizer']}', not "
                            f"'{self.optimizer}'")
            if set(snap["weights"]) != set(weights):
                raise RtErr("cnet_train: snapshot weights don't match "
                            "this net's parameter set")
            for k, v in weights.items():
                # snapshot arrays are stored flat-shaped-as-written; a
                # silent reshape across a mismatched net variant (e.g.
                # resized conv, changed in_dims) would scramble weights
                if snap["weights"][k].shape != tuple(v.shape):
                    raise RtErr(
                        f"cnet_train: snapshot weight '{k}' shape "
                        f"{snap['weights'][k].shape} != net's "
                        f"{tuple(v.shape)} — the snapshot is from a "
                        f"different net variant")
            start = snap["step"]
            if start >= self.steps:
                raise RtErr(f"cnet_train: snapshot is already at step "
                            f"{start} >= --steps={self.steps}")
            w_np = {k: snap["weights"][k] for k in weights}
            weights = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                       for k, v in w_np.items()}
            vel = _tree_map(
                lambda v: torch.from_numpy(np.array(v)).to(dev),
                _unflatten_opt(self.optimizer, w_np, snap["opt_flat"]))
            losses = snap["losses"]
            rng.set_state(snap["rng_state"])
            if self.device_data:
                # staged batches are pure functions of the step index — no
                # stream replay needed to restore the position
                self._consumed = snap["consumed"]
            elif self.stream is not None:
                for _ in range(snap["consumed"]):
                    self._next_stream_block()
                self._consumed = snap["consumed"]
            print(f"resumed from {self.resume_fn} at step {start}")
        warm = self.warmup_steps
        pol = self.lr_policy
        if pol not in ("fixed", "step", "exp", "poly", "multistep"):
            raise RtErr(f"cnet_train: unknown lr_policy '{pol}' (fixed | "
                        f"step | exp | poly | multistep)")
        if pol == "step" and self.stepsize < 1:
            raise RtErr("cnet_train: lr_policy=step requires stepsize >= 1")
        if pol == "multistep" and not self.stepvalue:
            raise RtErr("cnet_train: lr_policy=multistep requires "
                        "stepvalue boundaries")

        def policy_lr(i):
            # caffe SGDSolver::GetLearningRate formulas, keyed by the
            # GLOBAL step index (resume-stable)
            if pol == "step":
                return self.lr * self.gamma ** (i // self.stepsize)
            if pol == "exp":
                return self.lr * self.gamma ** i
            if pol == "poly":
                return self.lr * max(0.0, 1.0 - i / self.steps) ** self.power
            if pol == "multistep":
                return self.lr * self.gamma ** sum(
                    1 for sv in self.stepvalue if i >= sv)
            return self.lr

        def lr_at(i):
            v = policy_lr(i)
            return v * min(1.0, (i + 1) / warm) if warm else v

        dyn_lr = bool(warm) or pol != "fixed"

        K = self.steps_per_call
        if K < 1:
            raise RtErr("cnet_train: steps_per_call must be >= 1")
        if K > 1:
            if (self.steps - start) % K:
                raise RtErr(f"cnet_train: steps ({self.steps}) minus the "
                            f"resume point ({start}) must be a multiple of "
                            f"steps_per_call ({K})")
            if self.snapshot_every and self.snapshot_every % K:
                raise RtErr("cnet_train: snapshot_every must be a multiple "
                            "of steps_per_call")
        i = start
        with deterministic_cudnn():
            while i < self.steps:
                k_now = min(K, self.steps - i)
                lrs = [np.float32(lr_at(j)) if dyn_lr else None
                       for j in range(i, i + k_now)]
                if self.device_data:
                    # global step t covers staged indices [t*b, t*b+b) mod N:
                    # the skip-with-wrap order of the streaming path, with
                    # the same (u8 - mean) * scale f32 preprocessing
                    ar = torch.arange(b, device=dev)
                    batches = []
                    for j in range(i, i + k_now):
                        ix = (ar + (j * b) % n_ds) % n_ds
                        batches.append(((ds_dev[ix].float() - ds_mean)
                                        * ds_scale, labs_dev[ix]))
                    self._consumed += k_now * b
                else:
                    xs, ls = [], []
                    for _ in range(k_now):
                        x, labels = self._next_batch(d, rng, n_classes)
                        check_labels(labels, n_out, "cnet_train")
                        xs.append(x)
                        ls.append(labels)
                    # the call's batches in one upload each
                    xs_t = torch.from_numpy(np.stack(xs)).to(dev)
                    ls_t = torch.from_numpy(np.stack(ls).astype(np.int64)) \
                        .to(dev)
                    batches = list(zip(xs_t, ls_t))
                lk = []
                for j, (xb, lb) in enumerate(batches):
                    loss, weights, vel = step(weights, vel, xb, lb, lrs[j],
                                              i + j if seed_node else None)
                    lk.append(loss)
                new_losses = [float(v) for v in torch.stack(lk).cpu()]
                i = self._log_losses(i, new_losses, losses)
                if eval_fn is not None and self.eval_every \
                        and (i % self.eval_every == 0 and i < self.steps):
                    self._print_eval(eval_fn, weights, ev, i)
                if self.snapshot_every and (i % self.snapshot_every == 0
                                            or i == self.steps):
                    self._write_snapshot(i, weights, vel, losses, rng)
            if eval_fn is not None:
                self._print_eval(eval_fn, weights, ev, i)
        self.weights, self.losses = weights, losses
        print(f"cnet_train {self.model or self.ptt_fn} b{d['img']} "
              f"opt={self.optimizer} lr={self.lr}: "
              f"loss {losses[0]:.5f} -> {losses[-1]:.5f} "
              f"({self.steps} steps)")
        if self.loss_out_fn:
            self.out_path(self.loss_out_fn).write_text(
                "".join(f"{v:.6f}\n" for v in losses))
        w_np = {k: v.cpu().numpy() for k, v in weights.items()}
        if self.weights_out_fn:
            from ..graph.caffe_io import write_caffemodel
            for n, v in w_np.items():
                pipe.op_params[n] = NDA(pipe.op_params[n].dims,
                                        np.asarray(v, np.float32))
            write_caffemodel(pipe, self.out_path(self.weights_out_fn))
            print(f"wrote trained weights to {self.weights_out_fn}")
        if self.prototxt_out_fn:
            from ..graph.caffe_io import write_prototxt
            write_prototxt(pipe, self.out_path(self.prototxt_out_fn))
            print(f"wrote net structure to {self.prototxt_out_fn}")
        if self.artifact_out_fn:
            write_weights_artifact(
                self.out_path(self.artifact_out_fn), w_np,
                meta=f"{self.model or self.ptt_fn}:steps={self.steps}")
            print(f"wrote trained-weights artifact to "
                  f"{self.artifact_out_fn}")
