"""Test-harness CLI modes: comp_ndas and test_compute_multi.

The port's copy of that part of boda_tpu/testing/modes.py (CompNdas :46-58,
TestComputeMulti :217-272), on the port's testing/comp.py:

  * test_compute_multi (test_compute.cc:24) — run N engines on the same
    net and inputs, compare all vars within per-var mrd tolerances, write
    digest files, compare against a known-good digest stream. The default
    engines are ref=(engine=ref) and torch=(engine=torch,keep_all_nodes=1).
  * comp_ndas (test_nesi.cc:91) — compare two saved tensor files.

The JAX package's test_cmds, test_dense and test_all are not on the port's
paths and are left out.
"""

from __future__ import annotations

from pathlib import Path

from ..core.config import Attr
from ..core.dims import NDA
from ..core.error import RtErr
from ..core.has_main import HasMain, mode
from ..engine.iface import ConvFwd
from ..graph.modes import _NetMode
from .comp import comp_digests, comp_vars, read_digest_stream, \
    write_digest_stream


@mode("comp_ndas", help="compare two saved nda files within a tolerance")
class CompNdas(HasMain):
    a_fn = Attr(str, req=True)
    b_fn = Attr(str, req=True)
    mrd_toler = Attr(float, default=5e-4)

    def main(self):
        a, _ = NDA.bread(Path(self.a_fn).read_bytes())
        b, _ = NDA.bread(Path(self.b_fn).read_bytes())
        errs = comp_vars({"nda": a}, {"nda": b}, self.mrd_toler)
        if errs:
            raise RtErr("comp_ndas FAILED: " + "; ".join(errs))
        print("comp_ndas PASSED")


@mode("test_compute_multi", help="multi-engine numerical comparison on one net")
class TestComputeMulti(_NetMode):
    engines = Attr(dict[str, ConvFwd], default=None,
                   help="named engines; default (ref=(engine=ref),"
                        "torch=(engine=torch,keep_all_nodes=1))")
    vars = Attr(list[str], default=None, help="nodes to compare (default: top)")
    all_vars = Attr(bool, default=False, help="compare every node")
    mrd_toler = Attr(float, default=5e-4)
    var_mrd_toler = Attr(dict[str, float], default=None)
    tpd = Attr(int, default=0, help="test-pattern mode for input")
    write_digests = Attr(bool, default=True)
    kg_digests_fn = Attr(str, default="", help="known-good digest stream to compare")

    def main(self):
        from ..engine.iface import make_engine
        from ..graph.modes import _load_pipe
        from ..ops.cuda.gen_data import gen_test_nda
        pipe = _load_pipe(self)
        engines = self.engines or {
            "ref": make_engine("ref"),
            "torch": make_engine("(engine=torch,keep_all_nodes=1)")}
        d = pipe.get_data_img_dims()
        blob = NDA(d, gen_test_nda(d, self.tpd, 0.1))
        data_node = pipe.data_img_node_names[0]
        if self.all_vars:
            to_get = [n for n, nd in pipe.nodes.items()
                      if nd.dims is not None and nd.top_for]
        else:
            to_get = list(self.vars) if self.vars else [pipe.get_single_top_node().name]
        results: dict[str, dict[str, NDA]] = {}
        for en, eng in engines.items():
            eng.init(pipe)
            results[en] = eng.run_fwd({data_node: blob}, to_get)
            if self.write_digests:
                write_digest_stream(self.out_path(f"digest-{en}.boda"),
                                    results[en], self_cmp_mrd=self.mrd_toler)
        names = sorted(results)
        base = names[0]
        all_errs = []
        for other in names[1:]:
            errs = comp_vars(results[base], results[other], self.mrd_toler,
                             self.var_mrd_toler, tag_a=base, tag_b=other)
            all_errs += errs
            print(f"comp {base} vs {other}: "
                  + ("PASS" if not errs else f"{len(errs)} mismatches"))
        if self.kg_digests_fn:
            kg = read_digest_stream(self.kg_digests_fn)
            for en in names:
                errs = comp_digests(results[en], kg, self.mrd_toler,
                                    ignore_missing=True)
                all_errs += [f"[kg:{en}] {e}" for e in errs]
                print(f"kg digests vs {en}: "
                      + ("PASS" if not errs else f"{len(errs)} mismatches"))
        for e in all_errs:
            print("MISMATCH " + e)
        if all_errs:
            raise RtErr(f"test_compute_multi: {len(all_errs)} mismatches")
