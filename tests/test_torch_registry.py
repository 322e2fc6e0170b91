"""The port registers the JAX package's CLI: every mode and every stream
stage under the same name, with the JAX mode's attributes.

The exceptions are closed lists that may only shrink: the modes not ported
yet (none since ROADMAP item 9 brought mh_test and pp_test), and three
attributes that name a TPU compiler's options (ROADMAP item 11, not carried
into the port).
"""

import boda_tpu.modes  # noqa: F401  (register the JAX package's modes)
import boda_tpu_torch.modes  # noqa: F401  (register the port's)
from boda_tpu.core.config import Config as JConfig
from boda_tpu.core.has_main import HasMain as JHasMain
from boda_tpu.io.data_stream import DataStream as JDataStream
from boda_tpu_torch.core.config import Config
from boda_tpu_torch.core.has_main import HasMain
from boda_tpu_torch.io.data_stream import DataStream

# JAX modes the port does not register yet
NOT_PORTED_MODES = set()
# JAX attributes the port leaves out (ROADMAP item 11: TPU compiler options)
NOT_PORTED_ATTRS = {("cnet_bench", "compiler_options"),
                    ("cnet_xprof", "compiler_options"),
                    ("train_bench", "compiler_options")}


def _pairs(jbase, base):
    """(the JAX registry, the port's) of one base, each with the classes of
    its own package only: test files register helpers too (the JAX tests'
    _hrn_echo mode and velo-pkt-list-test stage), and a worker that imports
    them holds those in the same registry."""
    return tuple({k: v for k, v in cfg.registered(b).items()
                  if v.__module__.split(".")[0] == pkg}
                 for cfg, b, pkg in ((JConfig, jbase, "boda_tpu"),
                                     (Config, base, "boda_tpu_torch")))


def test_every_jax_mode_is_registered_under_its_name():
    jax, port = _pairs(JHasMain, HasMain)
    assert set(jax) - set(port) == NOT_PORTED_MODES
    assert set(port) - set(jax) == set()


def test_every_jax_stream_stage_is_registered_under_its_name():
    jax, port = _pairs(JDataStream, DataStream)
    assert set(jax) == set(port)
    assert len(port) > 40


def test_modes_and_stages_keep_the_jax_attributes():
    missing = set()
    for jbase, base in ((JHasMain, HasMain), (JDataStream, DataStream)):
        jax, port = _pairs(jbase, base)
        for name in set(jax) & set(port):
            missing |= {(name, a) for a in jax[name]._attrs
                        if a not in port[name]._attrs}
    assert missing == NOT_PORTED_ATTRS


def test_the_lifted_refusals_are_attributes_again():
    _, port = _pairs(JHasMain, HasMain)
    assert "anno_fn" in port["cnet_predict"]._attrs
    assert "anno_fn" in port["conv_pyra"]._attrs
    _, stages = _pairs(JDataStream, DataStream)
    assert {"feats_node", "feats_max_chans"} <= set(stages["cnet-infer"]._attrs)
