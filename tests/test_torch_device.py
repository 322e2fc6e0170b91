"""Device selection, feature probes, the plat tag and the kernel dispatch
rule of the port (boda_tpu_torch/core/device.py, ops/cuda/util.py)."""

import pytest
import torch

from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.ops.op_base import OpBase
from boda_tpu_torch.core.device import get_device, is_feature_enabled, \
    plat_tag
from boda_tpu_torch.ops.cuda.util import storage_io, use_kernel


def test_feature_probes():
    assert is_feature_enabled("torch")
    assert is_feature_enabled("cuda") == torch.cuda.is_available()
    assert not is_feature_enabled("tpu")


def test_get_device_and_plat_tag():
    assert get_device("cpu") == torch.device("cpu")
    assert plat_tag(get_device("cpu")) == "torch:cpu:cpu"
    with pytest.raises(RtErr, match="unsupported device 'meta'"):
        get_device("meta")
    if torch.cuda.is_available():
        dev = get_device("cuda")
        assert plat_tag(dev) == \
            f"torch:cuda:{torch.cuda.get_device_name(dev)}"
    else:
        # asking for a card that is not there raises: no CPU fallback
        with pytest.raises(RtErr, match="CUDA is not available"):
            get_device("cuda")


def test_dispatch_rule():
    cpu = torch.zeros(2)
    assert use_kernel(cpu, None, cpu) is False
    with pytest.raises(RtErr, match="mixed devices"):
        use_kernel(cpu, cpu.to("meta"))
    with pytest.raises(RtErr, match="no kernel for device 'meta'"):
        use_kernel(cpu.to("meta"))


@pytest.mark.parametrize("str_vals,want", [
    ({}, (False, None)),
    ({"io_layout": "nhwc"}, (True, None)),
    ({"io_layout": "nhwc", "edge_prec": "bf16"}, (True, torch.bfloat16)),
])
def test_storage_io(str_vals, want):
    op = OpBase({"type": "Convolution", "func_name": "k1conv"})
    op.str_vals.update(str_vals)
    assert storage_io(op) == want
