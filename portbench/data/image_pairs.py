"""Pairs of images resident on the device: a validation set's predictions and
targets, cut into batches that the loop cycles through.

The field is ``chip_smoke.py``'s ``_e4_images``, made on the device with a
``torch.Generator`` in chunks: the target is 0.5 plus three products of random
sinusoids a channel (in [0.14, 0.86]), the prediction the target plus
N(0, sigma^2) noise, clipped to [0, 1]. Every seed gives the same shapes and
batches; only the values change.
"""
from typing import Any, Dict

import torch

from portbench.seeds import part_seed

CHUNK = 50  # images made at once: the draws of a seed do not depend on anything else


def make_pairs(spec: Dict[str, Any], seed: int, device: torch.device):
    """(preds, target) of the whole set, float32, (crops, channels, height, width)."""
    n, c, h, w = spec["crops"], spec["channels"], spec["height"], spec["width"]
    g = torch.Generator(device=device)
    g.manual_seed(part_seed(seed, 0))
    yy = torch.linspace(0, 1, h, device=device)[:, None]
    xx = torch.linspace(0, 1, w, device=device)[None, :]
    preds = torch.empty((n, c, h, w), dtype=torch.float32, device=device)
    target = torch.empty_like(preds)

    def uniform(lo, hi, m):
        return torch.rand((m, c, 1, 1), generator=g, device=device) * (hi - lo) + lo

    for lo in range(0, n, CHUNK):
        m = min(CHUNK, n - lo)
        t = torch.full((m, c, h, w), 0.5, device=device)
        for _ in range(3):
            fy, fx, phase = uniform(2, 12, m), uniform(2, 12, m), uniform(0, 6.3, m)
            t += 0.12 * torch.sin(fy * yy + phase) * torch.cos(fx * xx - phase)
        target[lo:lo + m] = t
        noise = torch.randn((m, c, h, w), generator=g, device=device)
        preds[lo:lo + m] = (t + spec["noise_sigma"] * noise).clamp_(0, 1)
    return preds, target


def make(spec: Dict[str, Any], seed: int, rank: int, world: int, device: torch.device) -> Dict[str, Any]:
    """The whole set on every rank (the loop's batches are views of it)."""
    if world != 1:
        raise ValueError("image_pairs makes the set of one rank")
    preds, target = make_pairs(spec, seed, device)
    b = spec["batch"]
    batches = [{"preds": preds[i:i + b], "target": target[i:i + b]} for i in range(0, len(preds), b)]
    return {"arrays": {"preds": preds, "target": target}, "batches": batches}
