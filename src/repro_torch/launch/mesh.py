"""Mesh construction (the port of ``repro.launch.mesh``): functions, so
importing this module touches no process group.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, which the caller initialises first
(``torch.distributed.init_process_group`` with its address, world size and
rank: nothing on a machine tells a program of a cluster).  Its device type
follows ``kernels.runtime.default_device()``: ``cuda`` on the card, ``cpu``
under ``REPRO_TORCH_DEVICE=cpu``.
"""

from __future__ import annotations

import contextlib

from ..kernels.runtime import default_device

__all__ = ["make_mesh", "make_production_mesh", "one_rank_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16x16 = 256 devices per pod; multi_pod adds a leading pod=2 axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_mesh(shape, axes, device_type=None):
    """A mesh of ``shape`` named ``axes`` (reduced meshes for tests, elastic
    rescale) over the default process group's ranks, in rank order.

    Raises:
        RuntimeError: the shape's size is not the process group's world
            size, or no process group is initialised.
    """
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or default_device().type,
                            tuple(shape), mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def one_rank_mesh(tmp_dir, device=None):
    """A (1, 1) ("data", "model") mesh over a one-rank process group of
    this process on ``device`` (default ``default_device()``): ``nccl`` on
    the card, ``gloo`` on the CPU, its store a file under ``tmp_dir``.  A
    context manager; the group is destroyed on exit."""
    import torch
    import torch.distributed as dist

    dev = torch.device(device) if device is not None else default_device()
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{tmp_dir}/pg", rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), dev.type)
    finally:
        dist.destroy_process_group()
