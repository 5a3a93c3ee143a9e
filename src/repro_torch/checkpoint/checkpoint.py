"""Fault-tolerant checkpointing: atomic, async, keep-N (the port of
``repro.checkpoint.checkpoint``, in the same layout and manifest, so a
checkpoint written by either package restores in the other).

Layout (one directory per step):

  <root>/step_000123/
     manifest.json         # step, leaf paths, shapes, dtypes
     arr_000.npy ...       # one .npy per leaf, in jax.tree order
  <root>/LATEST            # atomic pointer (written last via rename)

Leaves are named as the reference names them (``repro_torch.tree``: dict
keys sorted, ``(params, opt)`` as ``0/...`` and ``1/.step``, ``1/.mu/...``,
``1/.nu/...``).  Atomicity: the step directory is staged as ``.tmp-<step>``
and renamed only after every leaf and the manifest are written; LATEST is
written as LATEST.tmp and renamed.  A crash mid-write leaves a ``.tmp-``
directory that ``restore`` ignores.  ``AsyncCheckpointer`` copies the state
to host memory synchronously and writes it in a background thread.

Mesh-shape-agnostic, as the reference's: a DTensor leaf is saved as its
full logical array (``full_tensor``, a collective every rank of its mesh
takes part in), written by rank 0 alone, and every rank waits for the
write before ``save`` (or ``AsyncCheckpointer.wait``) returns.  ``restore``
hands each leaf back as its ``tree_like`` leaf is: a plain tensor, or a
DTensor of that leaf's mesh and placements (each rank cut its shard from
the file), so a checkpoint taken on one mesh restores onto another or onto
none.

One departure: a bfloat16 leaf raises ``TypeError``.  numpy holds bf16 only
through ``ml_dtypes``, which a machine with a card may lack; the training
path keeps f32 parameters and moments and an int32 step (ROADMAP A.12).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from ..distributed.sharding import is_dtensor, whole
from ..tree import leaves_with_paths, tree_map, unflatten

__all__ = ["AsyncCheckpointer", "cleanup_keep_n", "latest_step", "restore",
           "save"]

_BF16 = ("bfloat16 checkpoint leaves are not supported: numpy needs "
         "ml_dtypes for them; keep parameters and moments in f32 "
         "(ROADMAP A.12)")


def _on_mesh(state) -> bool:
    """Whether ``state`` holds a DTensor (a multi-rank save)."""
    return any(is_dtensor(leaf) for _, leaf in leaves_with_paths(state))


def _writer() -> bool:
    """Whether this rank writes a multi-rank save: rank 0."""
    return torch.distributed.get_rank() == 0


def _host(leaf, keep: bool = True):
    """A leaf as a host array of its own dtype (a copy for tensors; a
    DTensor's full logical value), or None where ``keep`` is false: a rank
    that does not write still joins each DTensor's gather, one leaf at a
    time, and drops its result, so only the writer holds the state."""
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        raise TypeError(_BF16)
    leaf = whole(leaf)
    if not keep:
        return None
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        raise TypeError(_BF16)
    return arr


def save(root: str, step: int, state, *, keep_n: int = 3) -> str:
    """Blocking atomic save of a tree of tensors or arrays (DTensors: on
    every rank of their mesh; rank 0 writes).

    Raises:
        TypeError: a bfloat16 leaf.
    """
    mesh = _on_mesh(state)
    keep = not mesh or _writer()
    named = [(name, _host(leaf, keep))
             for name, leaf in leaves_with_paths(state)]
    final = os.path.join(root, f"step_{step:09d}")
    if keep:
        _write(root, step, named, keep_n)
    if mesh:
        torch.distributed.barrier()
    return final


def _write(root: str, step: int, named, keep_n: int) -> None:
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:09d}")
    tmp = os.path.join(root, f".tmp-{step:09d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "leaves": []}
    for i, (name, arr) in enumerate(named):
        fn = f"arr_{i:04d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append(
            {"name": name, "file": fn, "shape": list(arr.shape),
             "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    latest_tmp = os.path.join(root, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.rename(latest_tmp, os.path.join(root, "LATEST"))
    cleanup_keep_n(root, keep_n)


def _steps(root: str) -> list:
    return sorted(
        int(d.split("_")[1]) for d in os.listdir(root)
        if d.startswith("step_") and os.path.isdir(os.path.join(root, d)))


def latest_step(root: str) -> Optional[int]:
    try:
        with open(os.path.join(root, "LATEST")) as f:
            step = int(f.read().strip())
    except (FileNotFoundError, ValueError):
        return None
    if os.path.isdir(os.path.join(root, f"step_{step:09d}")):
        return step
    # pointer ahead of a crashed write: fall back to newest complete dir
    steps = _steps(root)
    return steps[-1] if steps else None


def restore(root: str, tree_like, step: Optional[int] = None):
    """Restore into the structure of ``tree_like``, a tree of tensors: each
    leaf comes back on its ``tree_like`` leaf's device, in its dtype (a
    DTensor leaf as a DTensor of its mesh and placements).

    Returns (state, step).

    Raises:
        FileNotFoundError: no checkpoint under ``root``.
        ValueError: another leaf count, or a leaf of another shape.
        TypeError: a bfloat16 leaf, in the checkpoint or in ``tree_like``.
    """
    if step is None:
        step = latest_step(root)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {root}")
    d = os.path.join(root, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = [leaf for _, leaf in leaves_with_paths(tree_like)]
    if len(flat_like) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, "
            f"expected {len(flat_like)}")
    out = []
    for want, entry in zip(flat_like, manifest["leaves"]):
        if entry["dtype"] == "bfloat16" or want.dtype == torch.bfloat16:
            raise TypeError(_BF16)
        arr = np.load(os.path.join(d, entry["file"]))
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(
                f"leaf {entry['name']}: shape {arr.shape} != "
                f"{tuple(want.shape)}")
        got = torch.from_numpy(arr).to(device=want.device, dtype=want.dtype)
        if is_dtensor(want):
            from torch.distributed.tensor import distribute_tensor

            got = distribute_tensor(got, want.device_mesh, want.placements,
                                    src_data_rank=None)
        out.append(got)
    return unflatten(tree_like, out), step


def cleanup_keep_n(root: str, keep_n: int) -> None:
    for s in _steps(root)[:-keep_n] if keep_n > 0 else []:
        shutil.rmtree(os.path.join(root, f"step_{s:09d}"), ignore_errors=True)


class AsyncCheckpointer:
    """Background-thread checkpoint writer with at most one save in flight.

    ``save()`` copies the state to host memory synchronously (cheap against
    a device-to-disk stall in the step loop) and writes in the background.
    """

    def __init__(self, root: str, keep_n: int = 3):
        self.root = root
        self.keep_n = keep_n
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._mesh = False  # the last save was a multi-rank one

    def save(self, step: int, state) -> None:
        self.wait()
        self._mesh = _on_mesh(state)
        keep = not self._mesh or _writer()
        host_state = tree_map(lambda leaf: _host(leaf, keep), state)
        if not keep:
            return

        def run():
            try:
                save(self.root, step, host_state, keep_n=self.keep_n)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight (after a multi-rank save, every rank
        waits for rank 0's) and raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh:
            self._mesh = False
            torch.distributed.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err
