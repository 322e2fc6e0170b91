"""Weights and images made from the run's seed, on the run's device.

Every stream is a `torch.Generator` on the device, seeded from (seed, stream
name), so the weights, the request pool and the calibration batch are
independent of one another and the same seed gives the same values. Each is
made in a few large calls in float32, the type the program takes them in.
"""

from __future__ import annotations

import hashlib

import torch
import torch.nn.functional as F


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator on `device` for one named stream of one seed (any whole
    number: it is hashed down to 63 bits)."""
    h = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(h[:8], "little") >> 1)
    return g


def make_weights(shapes: list, rule: dict, seed: int, device) -> dict:
    """{blob: float32 tensor on device} for [(name, shape, fan_in)]: one
    normal draw for all blobs, each filter scaled by sqrt(2 / fan_in) (the
    MSRA rule of the port's zoo), each bias by rule['bias_std']."""
    if rule.get("rule") != "msra":
        raise ValueError(f"unknown weight rule {rule}")
    sizes = [int(torch.Size(s).numel()) for _, s, _ in shapes]
    flat = torch.randn(sum(sizes), generator=generator(seed, "weights",
                                                       device),
                       device=device, dtype=torch.float32)
    out, at = {}, 0
    for (name, shape, fan_in), n in zip(shapes, sizes):
        std = (2.0 / fan_in) ** 0.5 if fan_in else float(rule["bias_std"])
        out[name] = flat[at:at + n].view(shape).mul_(std)
        at += n
    return out


def make_images(n: int, hw: tuple, img: dict, seed: int, stream: str,
                device) -> torch.Tensor:
    """(n, H, W, 3) uint8 images: a smooth random field (a grid x grid
    field per channel, bilinearly enlarged) plus pixel noise about a base
    level, clamped to 0-255 and rounded."""
    g = generator(seed, stream, device)
    h, w = hw
    gr = int(img["grid"])
    field = torch.randn(n, 3, gr, gr, generator=g, device=device)
    field = F.interpolate(field, size=(h, w), mode="bilinear",
                          align_corners=False)
    noise = torch.randn(n, 3, h, w, generator=g, device=device)
    x = img["base"] + img["field_amp"] * field + img["noise_amp"] * noise
    return x.round_().clamp_(0, 255).to(torch.uint8).permute(0, 2, 3, 1) \
        .contiguous()


def preprocess(u8: torch.Tensor, pre: dict) -> torch.Tensor:
    """The reference's preprocessing of (n, H, W, 3) uint8 RGB images:
    float32, channels reversed to BGR when pre['bgr'], the BGR mean
    subtracted, NCHW."""
    x = u8.float()
    if pre["bgr"]:
        x = x.flip(-1)
    x = x - torch.tensor(pre["mean_bgr"], dtype=torch.float32,
                         device=x.device)
    return x.permute(0, 3, 1, 2).contiguous()
