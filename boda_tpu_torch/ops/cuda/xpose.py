"""Layout-transform templates: xpose (a transpose and reshape driven by
named dims) and xpose_filts (a conv filter to the (y, x, in_chan,
out_chan) form).

Port of boda_tpu/ops/pallas/xpose.py, which lowers both to XLA transpose
and reshape; here they are torch permute and reshape, returned
contiguous.
"""

from __future__ import annotations

import numpy as np

from ...core.dims import Dims
from ..op_base import OpBase
from ..registry import IN, OUT, KernelTemplate, adecl, template


@template
class Xpose(KernelTemplate):
    """Generic named-dims transpose+reshape: rearrange `in` so that its dims
    match the declared `out` dims. The out dims' names must be derivable
    from in's names: same name set → pure transpose; otherwise sizes must
    factor (handled by executor-planned reshape)."""

    name = "xpose"
    # dims checked dynamically — any rank
    args = []
    sig_nda_keys = ["in", "out"]

    @classmethod
    def check_args(cls, op: OpBase) -> OpBase:
        rfs = OpBase({"func_name": cls.name})
        for k in ("in", "out"):
            rfs.nda_vals[k] = op.nda_vals[k]
        return rfs

    @classmethod
    def in_args(cls):
        return ["in"]

    @classmethod
    def out_args(cls):
        return ["out"]

    @classmethod
    def io_args(cls):
        return []

    @classmethod
    def _plan(cls, ind: Dims, outd: Dims):
        if sorted(ind.names()) == sorted(outd.names()):
            perm = [ind.ix(n) for n in outd.names()]
            return perm, outd.shape
        # fallback: same total size, reshape only
        if ind.sz() == outd.sz():
            return None, outd.shape
        raise ValueError(f"xpose: can't map {ind} -> {outd}")

    @classmethod
    def build(cls, rfs: OpBase):
        ind, outd = rfs.get_dims("in"), rfs.get_dims("out")
        perm, shape = cls._plan(ind, outd)

        def fn(x):
            if perm is not None:
                x = x.permute(*perm)
            return x.reshape(shape).contiguous()
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, x):
        ind, outd = rfs.get_dims("in"), rfs.get_dims("out")
        perm, shape = cls._plan(ind, outd)
        x = np.asarray(x)
        if perm is not None:
            x = np.transpose(x, perm)
        return x.reshape(shape)


# CompiledFunc plan needs in_specs; provide the dims of 'in' only.
Xpose.args = [adecl("in", IN, ""), adecl("out", OUT, "")]
Xpose.args[0].tmpl = Dims((), tn="any")
Xpose.args[1].tmpl = Dims((), tn="any")


@template
class XposeFilts(KernelTemplate):
    """Filter transpose for matmul-layout convs (reference: xpose_filts.cucl):
    (out_chan,in_chan,ky,kx) → (ky,kx,in_chan,out_chan) 'HWIO-flat' form."""

    name = "xpose_filts"
    args = [adecl("filts", IN, "out_chan in_chan y x"),
            adecl("filts_xp", OUT, "y x in_chan out_chan")]

    @classmethod
    def build(cls, rfs: OpBase):
        def fn(f):
            return f.permute(2, 3, 1, 0).contiguous()
        return fn

    @classmethod
    def ref_impl(cls, rfs: OpBase, f):
        return np.transpose(np.asarray(f), (2, 3, 1, 0))
