"""Seeded random weights, made on the card in a few large calls.

Embeddings ~ N(0, 1/hidden); every matrix ~ N(0, 1/fan_in) cut at two
standard units; biases 0; norm scales 1 (the distributions flax's
``lecun_normal`` init gives). One ``torch.Generator`` on the device draws
one flat buffer for all the matrices; each tensor is a scaled view of it.
The same seed gives the same bits, so the reference remakes the weights
after the window instead of keeping a copy.
"""

from __future__ import annotations

import torch

from ..reference.modernbert import param_shapes


def make_weights(cfg: dict, seed: int, device, dtype=torch.float32) -> dict[str, torch.Tensor]:
    shapes = param_shapes(cfg)
    mats = {k: s for k, s in shapes.items() if len(s) == 2}
    total = sum(s[0] * s[1] for s in mats.values())
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.empty(total, device=device, dtype=torch.float32).normal_(generator=gen)
    flat.clamp_(-2.0, 2.0)
    out: dict[str, torch.Tensor] = {}
    at = 0
    for name, shape in shapes.items():
        if len(shape) == 1:
            fill = 0.0 if name.endswith(".bias") else 1.0
            out[name] = torch.full(shape, fill, device=device, dtype=dtype)
            continue
        n = shape[0] * shape[1]
        std = shape[1] ** -0.5
        out[name] = (flat[at : at + n].view(shape) * std).to(dtype)
        at += n
    return out
