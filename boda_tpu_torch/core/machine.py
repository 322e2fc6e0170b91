"""Peaks of the card the port runs on, by device name: the port's machine
model (counterpart of boda_tpu/core/machine.py, which knows only TPUs).

The numbers are NVIDIA's data-sheet peaks, dense (no sparsity), at the
part's full power limit; they are not measurements. A card set below its
limit runs slower, so a share of peak is stated with the power limit
beside it. f32 is FFMA on the CUDA cores; bf16 and int8 are the tensor
cores. A device this table does not know raises: the caller passes its own
peak (cnn_op_info's peak_flops) rather than being scored against a guess.
"""

from __future__ import annotations

from dataclasses import dataclass

from .error import RtErr

PRECS = ("f32", "bf16", "int8")


@dataclass(frozen=True)
class CardPeaks:
    part: str
    f32: float      # FLOP/s, FFMA
    bf16: float     # FLOP/s, dense tensor cores
    int8: float     # OP/s, dense tensor cores
    hbm_bw: float   # B/s

    def flops(self, prec: str) -> float:
        if prec not in PRECS:
            raise RtErr(f"no peak for precision '{prec}' (have: "
                        f"{','.join(PRECS)})")
        return getattr(self, prec)


H100_SXM = CardPeaks("H100 SXM5", 67e12, 989e12, 1979e12, 3.35e12)
H100_PCIE = CardPeaks("H100 PCIe", 51e12, 756e12, 1513e12, 2.0e12)


def card_peaks(device_kind: str) -> CardPeaks:
    """Peaks of the card named `device_kind` (torch.cuda.get_device_name):
    'NVIDIA H100 PCIe' is the PCIe part, 'NVIDIA H100 80GB HBM3' (or a name
    with SXM) the SXM5 part; anything else raises."""
    if "H100" in device_kind:
        if "PCIe" in device_kind:
            return H100_PCIE
        if "HBM3" in device_kind or "SXM" in device_kind:
            return H100_SXM
    raise RtErr(f"no peaks known for device '{device_kind}' (known: NVIDIA "
                f"H100 SXM5 and PCIe); give the peak explicitly")


def peak_flops(device_kind: str, prec: str = "f32") -> float:
    """Peak FLOP/s (OP/s for int8) of the named card in `prec`."""
    return card_peaks(device_kind).flops(prec)
