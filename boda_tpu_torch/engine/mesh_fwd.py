"""How the fused executor runs over a ('dp','mp') mesh of slots: the port of
the JAX engine's mesh execution (rtc_fwd.py:433-451, :506-508), where GSPMD
partitioned one jitted forward.

torch_fwd.build_forward(plan, mesh=mesh) is the executor; one slot of a
device is its (1, 1) mesh. It takes global inputs and the global weights
and returns global outputs. Inside, every slot of the mesh that this
process holds runs its share, step by step in lockstep; this module holds
the pieces it does that with:

- dp: where plan_shardings shards the input's img over 'dp' (the batch
  divides by dp), each dp row of the mesh takes its slice of the batch and
  every step runs at the local batch, on a copy of the plan whose img dims
  are B/dp (plan_at_batch), so each kernel is built for the shapes it gets.
- mp: a step whose weights plan_shardings splits over 'mp' (out_chan) runs
  column-parallel where its template is one conv or fc (COL_TEMPLATES):
  each mp slot computes its out_chan slice of the output from its slice of
  the filter, bias and, for int8, the per-channel scales (a sig of its own
  at out_chan/mp), and the slices are gathered along the channel axis of
  the storage form (NCHW: 1, NHWC: 3). Any other step that reads a split
  weight (the sibling-fused xla_conv2, fused_stem, resblock, deconv, a
  conv in groups) runs on the gathered weight: each process keeps every
  weight whole, so that gather is the weight itself. A step that reads no
  split weight runs on every slot, as GSPMD's replicated compute does.
- the outputs are gathered over 'dp' along img (gather_rows).

fwd.routes counts the steps that read a split weight, by route. Under
autograd the column-parallel gather is differentiable within a process;
where an mp group spans processes, steps take the gathered route instead.
Two steps compute a function of the whole batch that GSPMD reduced over
the global batch, and under a dp split each slot takes its part of it
(slot_kwargs): a dropout step in train mode draws its mask over the
batch's flat positions, so each slot passes its first row (row0=, where
the step's function has takes_row0) and gets its rows of the whole mask;
an int8 step with a dynamic activation scale quantizes at the batch's
absmax, so each slot takes its own (the function's slot_absmax), pmax
over the dp group gives the batch's, and every slot quantizes at it
(amax=). Both then equal the unsharded forward bit for bit.
"""

from __future__ import annotations

import torch

from ..core.dims import NDA, Dims
from ..core.error import RtErr
from ..parallel.mesh import Mesh, all_gather, exchange, pmax
from .lower import Plan, Step

# templates that compute one conv or fc from (in, filts[, filts_scale]
# [, biases]) into `out`: the steps that can run column-parallel
COL_TEMPLATES = ("k1conv", "conv", "ipconv", "tconv", "xla_conv",
                 "s2d_conv")
COL_WEIGHT_ARGS = ("filts", "filts_scale", "biases")


def plan_batch(plan: Plan) -> int:
    """The one img size of the plan's nodes."""
    sizes = {d["img"] for d in plan.node_dims.values() if "img" in d}
    if len(sizes) != 1:
        raise RtErr(f"mesh: the plan's nodes hold img sizes {sorted(sizes)}, "
                    f"not one batch")
    return sizes.pop()


def _sig_with(sig, fn):
    """A copy of sig with fn(arg, dims) applied to each dims-only entry."""
    s2 = sig.copy()
    for k, v in sig.nda_vals.items():
        if v.v is None and v.dims.tn != "none":
            s2.nda_vals[k] = NDA.dims_only(fn(k, v.dims))
    return s2


def plan_at_batch(plan: Plan, b: int) -> Plan:
    """A copy of plan whose img dims are b (node dims, step sigs, temps)."""
    B = plan_batch(plan)
    if b == B:
        return plan

    def img(_k, d: Dims) -> Dims:
        return d.with_dim("img", b) if "img" in d else d
    steps = [Step(_sig_with(s.sig, img), dict(s.arg_nodes), s.call_tag,
                  {n: img(n, d) for n, d in s.temps.items()})
             for s in plan.steps]
    return Plan(steps, {n: img(n, d) for n, d in plan.node_dims.items()},
                list(plan.input_nodes), list(plan.weight_nodes),
                list(plan.output_nodes), plan.storage_nhwc, plan.edge_prec,
                dict(plan.weight_transforms))


def column_sig(sig, mp: int):
    """A conv step's sig for one mp slot: out_chan / mp in its filter, bias,
    per-channel scale and output."""
    def cut(k, d: Dims) -> Dims:
        if k in COL_WEIGHT_ARGS:
            return d.with_dim("out_chan", d["out_chan"] // mp)
        if k == "out":
            return d.with_dim("chan", d["chan"] // mp)
        return d
    s2 = _sig_with(sig, cut)
    if "out_chans" in s2.str_vals:
        s2.str_vals["out_chans"] = str(int(s2.str_vals["out_chans"]) // mp)
    return s2


def chan_axis(plan: Plan, dims: Dims) -> int:
    """The channel axis of a node's storage form."""
    return 3 if plan.storage_nhwc and len(dims) == 4 else 1


def slot_kwargs(mesh: Mesh, f, ins: dict, local_batch: int) -> dict:
    """{local position: the keyword arguments that make step function f,
    run on that slot's inputs ins[position] under a dp split, compute its
    part of the whole batch's function}: row0 (the slot's first row of the
    batch) where f.takes_row0, amax (pmax over the dp group of each slot's
    f.slot_absmax) where f has one; else {}."""
    kw = {p: {} for p in ins}
    if getattr(f, "takes_row0", False):
        for p in ins:
            kw[p]["row0"] = mesh.coord(p, "dp") * local_batch
    if hasattr(f, "slot_absmax"):
        m = pmax(mesh, {p: f.slot_absmax(*v) for p, v in ins.items()}, "dp")
        for p in ins:
            kw[p]["amax"] = m[p]
    return kw


class _GatherRows(torch.autograd.Function):
    """A node's global value on every process: the dp rows' values (each
    row's mp-column-0 one) concatenated along dim 0 where the batch is
    split, else position (0, 0)'s value. Backward: each of those positions
    takes its slice of the cotangent, the others none; every process
    computes the same loss of the gathered value, so no reduction is
    needed, and a process's grads count each row once."""

    @staticmethod
    def forward(ctx, mesh, positions, split, *vals):
        full = exchange(mesh, dict(zip(positions, vals)))
        rows = [p for p in mesh.positions() if mesh.coord(p, "mp") == 0] \
            if split else [mesh.positions()[0]]
        dev = vals[0].device
        ctx.layout = (positions, [full[p].shape[0] for p in rows], rows)
        return torch.cat([full[p].to(dev) for p in rows], dim=0)

    @staticmethod
    def backward(ctx, g):
        positions, sizes, rows = ctx.layout
        slices = dict(zip(rows, g.split(sizes, dim=0)))
        return (None, None, None) + tuple(
            slices[p] if p in slices else None for p in positions)


def gather_rows(mesh: Mesh, vals: dict, split: bool) -> torch.Tensor:
    """The global value of a node from its per-position values: the dp rows
    concatenated along dim 0 where the batch is split, else position
    (0, 0)'s value (every row holds the whole batch)."""
    local = mesh.local_positions()
    if not mesh.spans_ranks():
        if not split:
            return vals[local[0]]
        rows = [p for p in local if mesh.coord(p, "mp") == 0]
        return torch.cat([vals[p].to(mesh.device(local[0])) for p in rows],
                         dim=0)
    return _GatherRows.apply(mesh, tuple(local), split,
                             *[vals[p] for p in local])


def gather_mp(mesh: Mesh, vals: dict, axis: int) -> dict:
    """The column-parallel slices of every local position gathered along the
    channel axis over 'mp': one torch.cat per dp row within the process,
    else all_gather through the processes."""
    local = list(vals)
    if not all(mesh.group_is_local(p, "mp") for p in local):
        return all_gather(mesh, vals, "mp", axis)
    out = {}
    for p in local:
        if p not in out:
            grp = mesh.group(p, "mp")
            cat = torch.cat([vals[q] for q in grp], dim=axis)
            out.update({q: cat.to(mesh.device(q)) for q in grp})
    return out
