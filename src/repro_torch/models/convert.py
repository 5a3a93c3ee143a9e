"""Parameter trees from numpy: the bridge the tests use to run the port on
the reference's weights.

``params_from_numpy(cfg, tree, device, dtype)`` takes a nested dict of numpy
arrays in the reference's layout (for example ``repro.models.init_params``
with every leaf converted by ``numpy.asarray``) and returns the port's tree
of tensors.  The port imports nothing of the reference to do this: the
caller hands numpy arrays in.
"""

from __future__ import annotations

import numpy as np
import torch

from .model import segments_of

__all__ = ["params_from_numpy"]

# Leaves the reference keeps in f32 whatever the model dtype.
_F32_LEAVES = ("A_log", "D", "dt_bias")


def _convert(tree, device, dtype, name=""):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype, k) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind != "f" and arr.dtype.name != "bfloat16":
        raise TypeError(f"leaf {name!r} is not floating point: {arr.dtype}")
    t = torch.tensor(np.asarray(arr, dtype=np.float32))
    return t.to(device=device,
                dtype=torch.float32 if name in _F32_LEAVES else dtype)


def params_from_numpy(cfg, tree, device=None, dtype=torch.float32):
    """The port's parameter tree from a numpy tree in the reference layout.

    Raises:
        KeyError: a top-level entry the port's model expects is missing.
    """
    want = ["embed", "final_norm"] + [f"seg{i}" for i, _ in
                                      enumerate(segments_of(cfg))]
    if not cfg.tie_embeddings:
        want.append("head")
    missing = [k for k in want if k not in tree]
    if missing:
        raise KeyError(f"parameter tree lacks {missing}")
    return {k: _convert(tree[k], device, dtype, k) for k in want}
