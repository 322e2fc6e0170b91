"""Shared machinery for plan-level GPipe and 1F1B (forward and training
step): the port of boda_tpu/parallel/_pipe_plan.py.

Both pipelines need the same segment validation and per-stage weight
placement. The JAX package packs every stage's boundary value into one
flat pad-to-max f32 ring, and every stage's weights into per-dtype
(K, Wmax) buffers, because one SPMD program needs static shapes on every
device. Here a stage passes its real storage-form tensor to the next slot
and each slot holds its own stage's weights as they are, so nothing needs
the flat form and it is not kept.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.error import RtErr


class PlanPipeCtx:
    """Everything x-independent about a (plan, segments, weights, mesh)
    pipeline: K, the pipeline rows of the mesh (each the K positions along
    `axis` at one coordinate of the other axes) and each position's stage
    weights on its slot's device."""

    __slots__ = ("K", "axis", "rows", "stage_w", "plan", "segments",
                 "mesh")


def pipeline_rows(mesh, axis: str) -> list[list[tuple]]:
    """The mesh's pipelines: for each coordinate of the other axes, the
    positions along `axis` in order. The pipeline runs within one process:
    a mesh over several processes is refused."""
    if mesh.spans_ranks():
        raise RtErr("pipeline: the stages pass their tensors between the "
                    "slots of one process; this mesh spans processes")
    ax = mesh.axis_names.index(axis)
    rows = []
    for p in mesh.positions():
        if p[ax] == 0:
            rows.append(mesh.group(p, axis))
    return rows


def as_tensor(v, device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on `device`."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.ascontiguousarray(v))
    return v.to(device)


def build_plan_pipe_ctx(plan, segments, weights: dict, mesh,
                        axis: str = "pp",
                        what: str = "gpipe_plan_forward") -> PlanPipeCtx:
    c = PlanPipeCtx()
    c.plan, c.segments, c.mesh, c.axis = plan, segments, mesh, axis
    c.K = mesh.shape[axis]
    if len(segments) != c.K:
        raise RtErr(f"{what}: {len(segments)} segments != "
                    f"mesh '{axis}' size {c.K}")
    for a, b in zip(segments, segments[1:]):
        if b.in_node != a.out_node:
            raise RtErr(f"{what}: stage '{b.name}' consumes "
                        f"'{b.in_node}' but stage '{a.name}' produces "
                        f"'{a.out_node}' — stages must chain (regroup)")
    if segments[0].in_node not in plan.node_dims:
        raise RtErr(f"{what}: unknown input node "
                    f"'{segments[0].in_node}'")
    all_names = [n for s in segments for n in s.weight_names]
    if len(all_names) != len(set(all_names)):
        dups = sorted({n for n in all_names if all_names.count(n) > 1})
        raise RtErr(f"{what}: weight node(s) {dups} appear in more than "
                    f"one stage — unpack_grads keeps only the last "
                    f"stage's contribution, silently dropping gradient "
                    f"terms; segment the plan so each weight has one "
                    f"owning stage")
    c.rows = pipeline_rows(mesh, axis)
    # each slot holds only its own stage's weights
    c.stage_w = {p: [as_tensor(weights[n], mesh.device(p))
                     for n in segments[k].weight_names]
                 for row in c.rows for k, p in enumerate(row)}
    return c


def prep_microbatch(c: PlanPipeCtx, x, device) -> torch.Tensor:
    """One logical NCHW microbatch -> stage 0's storage-form input on
    `device`."""
    from ..engine.torch_fwd import _storage_in
    n = c.segments[0].in_node
    return _storage_in(as_tensor(x, device), c.plan.node_dims[n], c.plan)


def float_weights(c: PlanPipeCtx) -> set:
    """The weights that receive grads: the floating ones (bf16/f32 master
    weights train; a prequantized int8 plan's int8/scale tensors ride as
    constants)."""
    row = c.rows[0]
    return {n for k, p in enumerate(row)
            for n, w in zip(c.segments[k].weight_names, c.stage_w[p])
            if w.is_floating_point()}


def check_stages_trainable(c: PlanPipeCtx, what: str) -> None:
    """Raise, naming the step, where a stage runs a template with no
    backward (ops/mxu_grad.check_trainable)."""
    from ..ops.mxu_grad import check_trainable
    check_trainable([st for s in c.segments for st in s.steps], what)


def stage_vjp(c: PlanPipeCtx, k: int, p, x: torch.Tensor,
              g: torch.Tensor, f_names: set):
    """Stage k's VJP at position p: its forward run again from the saved
    input x under autograd, then (dx or None for stage 0, {weight: dW} for
    its float weights)."""
    seg = c.segments[k]
    ws = c.stage_w[p]
    with torch.enable_grad():
        xr = x.detach().requires_grad_(k > 0 and x.is_floating_point())
        wr = [w.detach().requires_grad_(n in f_names)
              for n, w in zip(seg.weight_names, ws)]
        y = seg.fn(xr, *wr)
        leaves = ([xr] if xr.requires_grad else []) + \
            [w for w in wr if w.requires_grad]
        gs = torch.autograd.grad(y, leaves, g.to(y.dtype), allow_unused=True)
    gs = list(gs)
    dx = gs.pop(0) if xr.requires_grad else None
    dw = {}
    for n, w in zip(seg.weight_names, wr):
        if w.requires_grad:
            gw = gs.pop(0)
            dw[n] = torch.zeros_like(w) if gw is None else gw
    return dx, dw
