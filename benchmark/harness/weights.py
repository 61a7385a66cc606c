"""Seeded weights, made on the device, that the program and the reference
both get, whatever the model family (`benchmark/families/<family>.py`
names the leaves and their shapes).

Every leaf of every layer comes from a generator of its own, seeded from
(run seed, leaf name, layer), so the reference can make any one layer
again, alone, after the program's state is freed, and get the very values
the program was handed: normal x 0.02 (the published configs'
`initializer_range`), norms 1 + 0.02 x normal, drawn in float32 on the
device in one call a leaf and a layer, then cast to the served dtype.
"""

from __future__ import annotations

import hashlib

SCALE = 0.02


def leaf_seed(seed: int, name: str, layer: int) -> int:
    digest = hashlib.sha256(f"{seed}/{name}/{layer}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1  # under 2**63


def draw(torch, seed: int, name: str, layer: int, shape, norm: bool, device, dtype):
    """One leaf of one layer (layer -1: the model's own leaves): 1 + 0.02 x
    normal for a norm, 0.02 x normal otherwise."""
    g = torch.Generator(device).manual_seed(leaf_seed(seed, name, layer))
    x = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    x = 1.0 + SCALE * x if norm else x.mul_(SCALE)
    return x.to(dtype)
