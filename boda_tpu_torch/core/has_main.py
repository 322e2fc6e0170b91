"""CLI mode base + dispatch.

Capability parity with the reference's has_main_t / create_and_run_has_main_t
(has_main.H:13, has_main.cc:20): every CLI subcommand ("mode") is a config
struct with a main(); global site config vars merge in as an outer scope
(like lib/boda_cfg.xml), and modes are selected polymorphically by `mode=`.

The port's copy of boda_tpu/core/has_main.py; `mode=` resolves against the port's own
mode hub (modes.py).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union

from .config import Attr, Config, register
from .error import RtErr
from .lexp import Lexp, NameValScope, parse_lexp


class HasMain(Config):
    """Base of all CLI modes; select concrete mode with mode=<type_id>."""

    TID_KEY = "mode"
    boda_output_dir = Attr(str, default=".", help="directory for mode output files")

    def main(self) -> None:
        raise NotImplementedError

    def out_path(self, fn: str) -> Path:
        p = Path(self.boda_output_dir)
        p.mkdir(parents=True, exist_ok=True)
        return p / fn


def mode(type_id: str, help: str = ""):
    """Decorator: register a HasMain subclass as CLI mode `type_id`."""
    return register(HasMain, type_id, help)


def default_global_vars() -> dict[str, str]:
    """Site config vars (reference: lib/boda_cfg.xml merged at has_main.cc:24).

    Sourced from a lexp file named by $BODA_TPU_CFG or ./boda_cfg.lexp, plus
    built-in defaults for the test/model dirs.
    """
    repo_root = Path(__file__).resolve().parents[2]
    out = {
        "boda_test_dir": str(repo_root / "tests" / "data"),
        "models_dir": str(repo_root / "nets"),
        "datasets_dir": str(repo_root / "tests" / "data" / "datasets"),
    }
    cfg_fn = os.environ.get("BODA_TPU_CFG", "boda_cfg.lexp")
    if Path(cfg_fn).exists():
        l = parse_lexp(Path(cfg_fn).read_text().strip())
        for n, v in l.iter_kids():
            if not v.is_leaf:
                raise RtErr(f"global config var '{n}' must be a leaf value")
            out[n] = v.leaf_val
    return out


def create_and_run_has_main(l: Union[Lexp, str],
                            global_vars: Optional[dict[str, str]] = None) -> HasMain:
    from .. import modes  # noqa: F401  (registers all CLI modes)
    if isinstance(l, str):
        l = parse_lexp(l)
    gscope = NameValScope()
    gscope.insert_leafs_from(default_global_vars() if global_vars is None else global_vars)
    hm = HasMain.init_from_lexp(l, parent=gscope)
    hm.main()
    return hm
