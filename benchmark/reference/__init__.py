"""The plain references: one file per configuration, named as the
configuration is (`resnet50.py` for `configs/resnet50.json`), each with
`build(cfg) -> graph.Net`. They import torch and nothing of the program."""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def net_of(cfg: dict):
    """The reference Net of a loaded configuration: `build` of the file
    named as the configuration."""
    fn = HERE / f"{cfg['name']}.py"
    if not fn.is_file():
        raise FileNotFoundError(f"no plain reference {fn} for configuration "
                                f"'{cfg['name']}'")
    spec = importlib.util.spec_from_file_location(
        f"{__name__}.{cfg['name'].replace('-', '_').replace('.', '_')}", fn)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build(cfg)
