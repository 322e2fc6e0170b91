"""Device selection, feature probes and the platform tag of the port.

Counterpart of boda_tpu/core/features.py and of the device part of
boda_tpu/backend/xla.py (XlaBackend.init / get_plat_tag). A device is asked
for by name ('cuda', 'cuda:0', 'cpu'); asking for CUDA where there is none
raises. Nothing falls back to the CPU.

The caller may ask for the CPU for a whole run, the processes it spawns
included (the be=ipc worker, stream-src), by setting BODA_TORCH_DEVICE=cpu
in the environment: every device name then resolves to the CPU. This is
the port's counterpart of JAX_PLATFORMS=cpu, and the only place that reads
it. Unset, names resolve as they read.

A process's device list is N *slots* of one device (local_devices): the
counterpart of the XLA virtual devices that --xla_force_host_platform_
device_count gives the JAX package. A mesh (parallel/mesh.py) may hold one
device several times, each slot running its own share of the work. The
caller sets N for a run, spawned processes included, with
BODA_TORCH_LOCAL_DEVICES=N (default 1), read here only.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

import torch

from .error import RtErr

# the CUDA toolkit's own default root, where CUDA_HOME names none
_CUDA_DEFAULT_ROOT = "/usr/local/cuda"

# the environment variable by which a caller asks for the CPU for a run
DEVICE_ENV = "BODA_TORCH_DEVICE"
# the environment variable that sets how many slots a process's device list
# holds
LOCAL_DEVICES_ENV = "BODA_TORCH_LOCAL_DEVICES"


def _run_device() -> str:
    """'cpu' where the caller asked for the CPU for the whole run, else ''."""
    v = os.environ.get(DEVICE_ENV, "")
    if v not in ("", "cpu"):
        raise RtErr(f"{DEVICE_ENV}={v!r}: the only value is 'cpu' (unset: "
                    "devices resolve as named)")
    return v


def nvcc_path() -> str:
    """The nvcc to build the kernels with: on PATH, else under $CUDA_HOME
    (or the toolkit's default root); raises if there is none."""
    p = shutil.which("nvcc")
    if p:
        return p
    root = os.environ.get("CUDA_HOME") or _CUDA_DEFAULT_ROOT
    nvcc = Path(root) / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    raise RtErr(f"nvcc not found (not on PATH, not at {nvcc}): the port's "
                "CUDA kernels cannot be built")


def is_feature_enabled(name: str) -> bool:
    """Probe a capability of this process: torch, cuda or nvcc."""
    if name == "torch":
        return True
    if name == "cuda":
        return torch.cuda.is_available()
    if name == "nvcc":
        try:
            nvcc_path()
        except RtErr:
            return False
        return True
    return False


def get_device(name: str) -> torch.device:
    """torch.device for `name`, checked: CUDA must exist when asked for.
    Under BODA_TORCH_DEVICE=cpu every valid name is the CPU."""
    dev = torch.device(name)
    if dev.type in ("cuda", "cpu") and _run_device() == "cpu":
        return torch.device("cpu")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RtErr(f"device '{name}' requested but CUDA is not available")
        if dev.index is None:  # tensors report their index: name it
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RtErr(f"device '{name}' out of range "
                        f"({torch.cuda.device_count()} CUDA devices)")
    elif dev.type != "cpu":
        raise RtErr(f"unsupported device '{name}' (cuda or cpu)")
    return dev


def local_device_count() -> int:
    """The slots of this process's device list (BODA_TORCH_LOCAL_DEVICES,
    default 1)."""
    v = os.environ.get(LOCAL_DEVICES_ENV, "") or "1"
    if not v.isdigit() or int(v) < 1:
        raise RtErr(f"{LOCAL_DEVICES_ENV}={v!r}: a count of slots >= 1")
    return int(v)


def local_devices(name: str = "cuda") -> list[torch.device]:
    """This process's device list: local_device_count() slots of the device
    `name` (get_device: the CPU under the CPU ask)."""
    dev = get_device(name)
    return [dev] * local_device_count()


def plat_tag(dev: torch.device) -> str:
    """Platform tag for wisdom and reports: torch:cuda:<device name> or
    torch:cpu:cpu."""
    if dev.type == "cuda":
        return f"torch:cuda:{torch.cuda.get_device_name(dev)}"
    return "torch:cpu:cpu"
