"""Random weights for a configuration file, drawn from the seed on the
device the run uses, in the port's parameter layout.

One flat f32 buffer holds every leaf; it is filled with standard normals
by a ``torch.Generator`` on the device in a few large calls, and each leaf
(a view into it) is then scaled as the port's own initialisers scale it:
``1/sqrt(fan_in)`` for projections and experts, 0.02 for the embedding,
ones for the norms.  The port and the reference are handed the same
tensors, so one copy of the weights fits on the card.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import families

__all__ = ["Leaf", "layout", "make", "vocab_padded"]

_CHUNK = 1 << 30  # elements a normal_ call fills

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], float]  # path, shape, scale


def vocab_padded(v: int) -> int:
    """The port's embedding and head rows: ``v`` up to a multiple of 256."""
    return -(-v // 256) * 256


def layout(c: dict) -> List[Leaf]:
    """Every leaf of configuration file ``c`` in the port's tree, as its
    family lays them out (``families``)."""
    return families.of(c).layout(c)


def make(c: dict, seed: int, device) -> Dict:
    """The weight tree of configuration file ``c`` for ``seed`` on
    ``device`` (f32)."""
    leaves = layout(c)
    sizes = [torch.Size(shape).numel() for _, shape, _ in leaves]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    for lo in range(0, flat.numel(), _CHUNK):
        flat[lo:lo + _CHUNK].normal_(generator=gen)
    tree: Dict = {}
    at = 0
    for (path, shape, scale), n in zip(leaves, sizes):
        leaf = flat[at:at + n].view(shape)
        at += n
        if scale:
            leaf.mul_(scale)
        else:
            leaf.fill_(1.0)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree
