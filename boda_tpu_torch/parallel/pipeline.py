"""Pipeline parallelism over a 'pp' mesh axis of slots: the port of
boda_tpu/parallel/pipeline.py (GPipe and 1F1B).

Stage k of a K-stage network lives on slot k of the pp axis, with its own
weights there, and microbatches flow stage to stage on the schedule of the
JAX package: T = M + K - 1 ticks of fill, steady state and drain, stage k
running microbatch t - k at tick t, the outputs taken from the last stage.
The JAX package runs every stage at every tick inside one SPMD program
(lax.scan over a pad-to-max ring riding lax.ppermute, invalid ticks masked
out); here each tick runs only the stages that have a microbatch, and a
stage hands its real tensor to the next slot. On a mesh of more axes,
every pipeline row (each coordinate of the other axes) runs the same
schedule, as the replicated SPMD program does, and the first row's outputs
are returned. A pipeline runs within one process.

The training steps differentiate each stage with torch autograd (its
forward run again from the saved input: per-stage activation
checkpointing, the GPipe memory recipe) and accumulate each stage's weight
gradients on its slot. A stage that runs a template with no backward (the
hand kernels B1 and B2) raises before the first tick.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.error import RtErr


def gpipe_forward(stage_fn, stacked_params, x_mb, mesh, axis: str = "pp"):
    """Run a K-stage pipeline over mesh axis `axis`.

    stage_fn(params, x) -> y        (same shape as x)
    stacked_params: {name: array}, each with leading dim K (stage-major);
                    slot k gets stage k's slice
    x_mb: (M, mb, ...) microbatches
    returns (M, mb, ...) outputs on the first slot's device
    """
    from ._pipe_plan import as_tensor, pipeline_rows

    K = mesh.shape[axis]
    M = int(x_mb.shape[0])
    if M < 1:
        raise RtErr("gpipe_forward: need at least one microbatch")
    outs_rows = []
    for row in pipeline_rows(mesh, axis):
        devs = [mesh.device(p) for p in row]
        w = [_tree_index(stacked_params, k, devs[k]) for k in range(K)]
        outs = [None] * M
        recv = {}
        for t in range(M + K - 1):
            for k in range(K):
                m = t - k
                if not 0 <= m < M:
                    continue
                x = as_tensor(x_mb[m], devs[0]) if k == 0 \
                    else recv.pop((k, m))
                y = stage_fn(w[k], x)
                if k == K - 1:
                    outs[m] = y
                else:
                    recv[(k + 1, m)] = y.to(devs[k + 1])
        outs_rows.append(torch.stack([o.to(devs[0]) for o in outs]))
    return outs_rows[0]


def _tree_index(tree, k: int, device):
    """Stage k's slice of a stacked {name: array} tree on `device`."""
    from ._pipe_plan import as_tensor
    if isinstance(tree, dict):
        return {n: _tree_index(v, k, device) for n, v in tree.items()}
    return as_tensor(tree[k], device)


def stack_stage_params(per_stage_params: list):
    """[{name: arr}, ...] per stage -> {name: stacked arr} with leading dim
    K. All stages must share one parameter structure (GPipe shape rule)."""
    if not per_stage_params:
        raise RtErr("stack_stage_params: no stages")

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            if any(set(lf) != set(leaves[0]) for lf in leaves):
                raise RtErr("stack_stage_params: the stages' parameter "
                            "structures differ")
            return {n: stack(*[lf[n] for lf in leaves]) for n in leaves[0]}
        return np.stack([np.asarray(lf) for lf in leaves])
    return stack(*per_stage_params)


def gpipe_plan_forward(plan, segments, weights: dict, x_mb, mesh,
                       axis: str = "pp"):
    """Heterogeneous GPipe over a segmented imported plan: real per-stage
    shapes and weights.

    plan/segments: lower_pipe output + engine.segments.build_plan_segments
                   over it (stage k+1's in_node must be stage k's out_node)
    weights:       resolve_plan_weights dict (numpy or tensors)
    x_mb:          (M, img, chan, y, x) LOGICAL NCHW microbatches; img must
                   equal the plan's lowered batch
    returns        (M, *out_storage_shape) storage-form outputs of the
                   last segment, on the first slot's device
    """
    from ._pipe_plan import build_plan_pipe_ctx, prep_microbatch

    c = build_plan_pipe_ctx(plan, segments, weights, mesh, axis,
                            what="gpipe_plan_forward")
    M = int(x_mb.shape[0])
    if M < 1:
        raise RtErr("gpipe_plan_forward: need at least one microbatch")
    K = c.K
    outs_rows = []
    with torch.no_grad():
        for row in c.rows:
            devs = [mesh.device(p) for p in row]
            outs = [None] * M
            recv = {}
            for t in range(M + K - 1):
                for k in range(K):
                    m = t - k
                    if not 0 <= m < M:
                        continue
                    x = prep_microbatch(c, x_mb[m], devs[0]) if k == 0 \
                        else recv.pop((k, m))
                    y = segments[k].fn(x, *c.stage_w[row[k]])
                    if k == K - 1:
                        outs[m] = y
                    else:
                        recv[(k + 1, m)] = y.to(devs[k + 1])
            outs_rows.append(torch.stack([o.to(devs[0]) for o in outs]))
    return outs_rows[0]


def _check_labels(labels_mb, M: int, what: str) -> None:
    if M < 1:
        raise RtErr(f"{what}: need at least one microbatch")
    if int(labels_mb.shape[0]) != M:
        raise RtErr(f"{what}: {labels_mb.shape[0]} label "
                    f"microbatches != {M} data microbatches")


def _loss_and_cot(loss_fn, y, lab):
    """(loss value, d loss / d y) of one microbatch's last-stage output."""
    with torch.enable_grad():
        yr = y.detach().requires_grad_(True)
        lval = loss_fn(yr, lab).float()
        (g,) = torch.autograd.grad(lval, [yr])
    return lval.detach(), g


def gpipe_plan_train_step(plan, segments, weights: dict, x_mb, labels_mb,
                          mesh, loss_fn, axis: str = "pp"):
    """Pipeline-parallel TRAINING step over the segmented imported plan:
    GPipe microbatch gradient accumulation. The forward runs as
    gpipe_plan_forward's (T = M + K - 1 ticks; slot d runs microbatch m at
    tick m + d) and saves each slot's stage inputs; the loss
    (`loss_fn(y_storage, labels) -> scalar`, summed over microbatches) and
    its output cotangents are formed from the last slot's outputs; then
    backward tick b has slot d run the VJP of microbatch m = b - (K-1-d)
    from its saved input, sending the input cotangent to slot d-1, which
    takes it at tick b+1, and accumulating its weight gradients.

    labels_mb: (M, img) int labels per microbatch.
    Returns (total_loss: f32 0-d tensor, grads: {weight_name: tensor}) for
    every float weight (int8/prequant tensors ride as constants).
    """
    from ._pipe_plan import (as_tensor, build_plan_pipe_ctx,
                             check_stages_trainable, float_weights,
                             prep_microbatch, stage_vjp)

    what = "gpipe_plan_train_step"
    c = build_plan_pipe_ctx(plan, segments, weights, mesh, axis, what=what)
    M = int(x_mb.shape[0])
    _check_labels(labels_mb, M, what)
    check_stages_trainable(c, what)
    K = c.K
    f_names = float_weights(c)
    results = []
    for row in c.rows:
        devs = [mesh.device(p) for p in row]
        saved = [dict() for _ in range(K)]   # slot d: m -> stage input
        outs = [None] * M
        recv = {}
        with torch.no_grad():
            for t in range(M + K - 1):
                for k in range(K):
                    m = t - k
                    if not 0 <= m < M:
                        continue
                    x = prep_microbatch(c, x_mb[m], devs[0]) if k == 0 \
                        else recv.pop((k, m))
                    saved[k][m] = x
                    y = segments[k].fn(x, *c.stage_w[row[k]])
                    if k == K - 1:
                        outs[m] = y
                    else:
                        recv[(k + 1, m)] = y.to(devs[k + 1])
        lval = torch.zeros((), dtype=torch.float32, device=devs[-1])
        gout = []
        for m in range(M):
            lm, g = _loss_and_cot(loss_fn, outs[m],
                                  as_tensor(labels_mb[m], devs[-1]))
            lval = lval + lm
            gout.append(g)
        acc: dict = {}
        cot = {}
        for b in range(M + K - 1):
            for d in range(K - 1, -1, -1):
                m = b - (K - 1 - d)
                if not 0 <= m < M:
                    continue
                g_in = gout[m] if d == K - 1 else cot.pop((d, m))
                dx, dw = stage_vjp(c, d, row[d], saved[d].pop(m), g_in,
                                   f_names)
                for n, g in dw.items():
                    acc[n] = g if n not in acc else acc[n] + g
                if d > 0:
                    cot[(d - 1, m)] = dx.to(devs[d - 1])
        results.append((lval, acc))
    return results[0]


def sched_1f1b(K: int, M: int):
    """Static 1F1B (one-forward-one-backward) schedule tables.

    Greedy unit-time simulation of the standard synchronous 1F1B
    pipeline schedule (Megatron-LM's non-interleaved form): device d
    runs up to `K - d` outstanding forwards (its warmup depth), then
    strictly prefers a backward whenever one is ready — so at most
    `K - d` microbatch activations are ever live on device d, versus
    GPipe's `M + K - 1`. Dependencies respected in tick time: fwd(m,d)
    needs fwd(m,d-1) at an earlier tick (activation arrives over the
    ring one tick after send), bwd(m,d) needs bwd(m,d+1) earlier and
    fwd(m,d) done.

    Returns (T, act, mb): act[d,t] in {0 idle, 1 fwd, 2 bwd},
    mb[d,t] = microbatch index. All arrays are host numpy.
    """
    f_done = [[-1] * M for _ in range(K)]   # tick fwd(m,d) ran
    b_done = [[-1] * M for _ in range(K)]
    next_f, next_b = [0] * K, [0] * K
    acts: list[list[int]] = [[] for _ in range(K)]
    mbs: list[list[int]] = [[] for _ in range(K)]
    t = 0
    while any(nb < M for nb in next_b):
        if t > 4 * (M + K) + 8:  # simulation safety net
            raise RtErr(f"sched_1f1b: no progress (K={K}, M={M})")
        for d in range(K):
            nf, nb = next_f[d], next_b[d]
            can_f = (nf < M and nf - nb < K - d
                     and (d == 0 or 0 <= f_done[d - 1][nf] < t))
            can_b = (nb < M and nb < nf
                     and (d == K - 1 or 0 <= b_done[d + 1][nb] < t))
            if can_b and (nf - nb >= K - d or not can_f):
                acts[d].append(2), mbs[d].append(nb)
            elif can_f:
                acts[d].append(1), mbs[d].append(nf)
            elif can_b:
                acts[d].append(2), mbs[d].append(nb)
            else:
                acts[d].append(0), mbs[d].append(0)
        for d in range(K):  # commit simultaneously (decisions saw < t)
            if acts[d][t] == 1:
                f_done[d][mbs[d][t]] = t
                next_f[d] += 1
            elif acts[d][t] == 2:
                b_done[d][mbs[d][t]] = t
                next_b[d] += 1
        t += 1
    return t, np.asarray(acts, np.int32), np.asarray(mbs, np.int32)


def plan_train_step_1f1b(plan, segments, weights: dict, x_mb, labels_mb,
                         mesh, loss_fn, axis: str = "pp"):
    """1F1B pipeline-parallel training step over the segmented imported
    plan: gpipe_plan_train_step's contract and results (loss summed over
    microbatches, grads for every float weight), on the 1F1B schedule of
    sched_1f1b's static (K, T) tables. Each tick, each slot does what its
    table says: a forward keeps its stage input in slot buffer m mod K
    until that microbatch's backward (at most K - d of them live on slot
    d, where GPipe keeps all M), the last slot keeps its output for the
    loss; a backward forms the loss cotangent on the last slot, or takes
    the cotangent slot d+1 sent, runs the stage VJP from the saved input
    and accumulates the weight gradients. What a slot sends at tick t
    (an activation forward, a cotangent back) lands in the receiver's
    slot buffer for tick t+1.
    """
    from ._pipe_plan import (as_tensor, build_plan_pipe_ctx,
                             check_stages_trainable, float_weights,
                             prep_microbatch, stage_vjp)

    what = "plan_train_step_1f1b"
    c = build_plan_pipe_ctx(plan, segments, weights, mesh, axis, what=what)
    M = int(x_mb.shape[0])
    _check_labels(labels_mb, M, what)
    check_stages_trainable(c, what)
    K = c.K
    T, act, mbt = sched_1f1b(K, M)
    f_names = float_weights(c)
    results = []
    for row in c.rows:
        devs = [mesh.device(p) for p in row]
        in_buf = [dict() for _ in range(K)]    # slot m % K -> stage input
        cot_buf = [dict() for _ in range(K)]   # slot m % K -> cotangent
        out_buf: dict = {}                     # last stage: slot -> output
        lval = torch.zeros((), dtype=torch.float32, device=devs[-1])
        acc: dict = {}
        live = [0] * K   # slot d: inputs saved whose backward is to come
        for t in range(T):
            sends = []   # (buffers, receiver slot d, buffer slot, value)
            for d in range(K):
                a, m = int(act[d, t]), int(mbt[d, t])
                slot = m % K
                if a == 1:
                    if d == 0:
                        in_buf[0][slot] = prep_microbatch(c, x_mb[m], devs[0])
                    x = in_buf[d][slot]
                    live[d] += 1
                    with torch.no_grad():
                        y = segments[d].fn(x, *c.stage_w[row[d]])
                    if d == K - 1:
                        out_buf[slot] = y
                    else:
                        sends.append((in_buf, d + 1, slot, y))
                elif a == 2:
                    if d == K - 1:
                        lm, g_in = _loss_and_cot(
                            loss_fn, out_buf.pop(slot),
                            as_tensor(labels_mb[m], devs[-1]))
                        lval = lval + lm
                    else:
                        g_in = cot_buf[d].pop(slot)
                    dx, dw = stage_vjp(c, d, row[d], in_buf[d].pop(slot),
                                       g_in, f_names)
                    live[d] -= 1
                    for n, g in dw.items():
                        acc[n] = g if n not in acc else acc[n] + g
                    if d > 0:
                        sends.append((cot_buf, d - 1, slot, dx))
                if live[d] > K - d:
                    raise RtErr(f"{what}: slot {d} holds {live[d]} saved "
                                f"inputs > K - d = {K - d}")
            for bufs, d, slot, v in sends:
                if slot in bufs[d]:
                    raise RtErr(f"{what}: slot buffer {slot} of stage {d} "
                                f"still in use at tick {t}")
                bufs[d][slot] = v.to(devs[d])
        results.append((lval, acc))
    return results[0]
