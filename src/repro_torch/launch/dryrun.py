"""Dry-run sizing of every (arch x shape x mesh) cell for the H100 (the port
of ``repro.launch.dryrun``): a tool of the host, which allocates no device
memory and needs no card.

Each cell's step is the one the card runs (``launch.steps.jit_train_step``,
``jit_prefill_step``, ``jit_decode_step``), traced on ``FakeTensor``s
(shapes, dtypes and a device, no memory) placed on a production mesh
(``launch.mesh.make_production_mesh``: (16, 16), or (2, 16, 16) for two
pods) over a fake process group of 256 or 512 ranks, of which this process
is rank 0.  The kernel wrappers take their shape-only route on fake
operands (``kernels.runtime.shape_only``): they allocate what a launch
allocates and report the call, which the trace counts as a predicted
launch.  The backward is the card's too: the kernels' autograd routes
recompute the plain version (``runtime.plain_vjp``), whose temporaries the
trace holds as the card would.

Everything is counted on rank 0's **local** tensors: an op on DTensors is
handed on to DTensor, and the trace sees the ops on the local shards (and
the collectives) that DTensor issues below it.  DTensor's own shapes are
global, so a mode that stopped at them would count every rank's work.

Per cell:
  1. Memory (the gate): the peak bytes rank 0 holds over one step (its
     inputs' shards included), each storage counted as the CUDA caching
     allocator rounds it (512 bytes), against the card's memory.  The
     reference's auto-fit picks the first microbatch count (and, for
     training, f32 then bf16 Adam moments) that fits.  A decode cell also
     reports ``mandatory_bytes_per_chip``: bf16 parameters over the ranks
     plus the rank's cache shard, which every step must stream.
  2. Cost (single pod): the same step at ``num_layers`` L1 = first dense
     layers + 2 and L2 = L1 + 1 (and, for the hybrid, one more shared
     attention application), extrapolated to full depth by the
     reference's rule (``cost_levels`` says why L1 is one layer deeper).  Per rank: matrix-product operations (``torch.utils.flop_counter``'s
     formulas on the local ops) plus the kernels' own, the bytes each local
     op reads and writes (eager PyTorch moves each op's inputs and
     outputs; views move nothing) plus the kernels', and the collectives
     (``distributed.record_collectives``) priced by ``collective_bytes``.
     The roofline terms use the H100 constants below.

On a host where this process has no card the fake tensors lie on the
``meta`` device in place of ``cuda`` (``trace_device``); the kernel
wrappers take them as the card's, and every byte and operation counts the
same.

Usage:
  python -m repro_torch.launch.dryrun --cell ARCH SHAPE single|multi
  python -m repro_torch.launch.dryrun --test-cell ARCH
  python -m repro_torch.launch.dryrun --sweep [--arch A] [--shape S]
      [--meshes single,multi] [--out build/dryrun.json] [--timeout T]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
import weakref
from collections import Counter
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..configs import ARCH_NAMES, SHAPES, cell_is_runnable, get_config, \
    get_shape
from ..distributed import collective_bytes
from ..distributed.collectives import collectives_of
from ..distributed.sharding import (MeshAxes, batch_specs, cache_specs,
                                    opt_state_specs, param_specs, placements)
from ..kernels import runtime
from ..optim.adamw import AdamWConfig, OptState, init_opt_state
from ..tree import leaves, tree_map
from . import specs as S
from . import steps
from .mesh import make_mesh, make_production_mesh

__all__ = ["CUBLAS_WORKSPACE_BYTES", "HBM_BW", "HBM_LIMIT", "NVLINK_BW",
           "PEAK_FLOPS", "StepTrace", "cells", "combine", "cost_levels",
           "fake_group", "fake_mode", "level_costs", "main",
           "mandatory_bytes", "mesh_step", "micro_attempts", "run_cell", "run_test_cell",
           "sweep", "trace_cell", "trace_device", "trace_step",
           "track"]

# NVIDIA H100 SXM5 constants.  A 16-wide "model" axis spans two 8-GPU
# NVLink domains on real H100 clusters, so the collective term there is a
# lower bound (the links between domains are slower).
PEAK_FLOPS = 989.4e12  # bf16 dense, tensor cores (H100 SXM5 datasheet)
HBM_BW = 3.35e12  # bytes/s, HBM3 (H100 SXM5 datasheet)
# bytes/s, NVLink 4, both directions (as the reference counts its ICI)
NVLINK_BW = 900e9
# The per-rank budget: torch.cuda.get_device_properties(0).total_memory of
# an NVIDIA H100 80GB HBM3 at a 700.00 W limit, as chip_smoke.py's dryrun
# phase prints it.
HBM_LIMIT = 85_017_493_504
ALLOC_GRANULE = 512  # the CUDA caching allocator rounds every block to it
# The cuBLAS and cuBLASLt workspaces PyTorch allocates through the caching
# allocator once a product has run (32 MiB each on Hopper): part of what a
# rank holds, and no op's output.  chip_smoke.py's dryrun phase measures
# them (the bytes held before a step beyond its inputs, once a product ran).
CUBLAS_WORKSPACE_BYTES = 2 * 32 * 2**20

ROOT = Path(__file__).resolve().parents[3]
SRC = Path(__file__).resolve().parents[2]


def _cell_key(arch: str, shape: str, mesh: str) -> str:
    return f"{arch}|{shape}|{mesh}"


# -------------------------------------------------------- fake group, mode
@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks (this process rank 0):
    collectives return at once and move nothing.  Destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def trace_device() -> str:
    """Where the trace's fake tensors lie: ``cuda`` where this process can
    use a card, else ``meta``.  Autograd asks a CUDA tensor's device for its
    stream, which a host without the card (or without a CUDA build of
    PyTorch) cannot answer even for a fake tensor; the kernel wrappers take
    a fake ``meta`` operand for a card's."""
    return "cuda" if torch.cuda.is_available() else "meta"


class _TraceFakeMode(FakeTensorMode):
    """A ``FakeTensorMode`` that counts how deep it is entered: DTensor
    enters the active fake mode once more to work out an op's global
    output shape (its sharding propagation), and ``StepTrace`` counts no
    op run at that depth."""

    depth = 0

    def __enter__(self):
        self.depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self.depth -= 1


def fake_mode():
    """A fake tensor mode to trace in: every tensor made inside holds no
    memory.  It takes real inputs too: ``torch.tensor(data,
    device="meta")`` makes a real meta tensor even inside the mode."""
    return _TraceFakeMode(allow_non_fake_inputs=True)


def _shadow() -> bool:
    """Whether the op being dispatched is DTensor's global-shape shadow of
    one (run under a fake mode entered for it, not the trace's own)."""
    mode = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
    return mode is not None and getattr(mode, "depth", 2) > 1


# ------------------------------------------------------------------ tracking
def _granule(n: int) -> int:
    return -(-n // ALLOC_GRANULE) * ALLOC_GRANULE


class StepTrace(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts one rank's side of a block: the bytes its storages hold (live
    and at the peak, each rounded as the caching allocator rounds it), the
    matrix-product operations and the bytes its ops read and write, the
    collectives (``distributed.collectives_of``) and the kernels'
    shape-only calls.  Ops on DTensors are handed on to DTensor, so what
    is counted is the local ops below it, not the global-shape shadows
    that DTensor runs to propagate shapes (``_shadow``)."""

    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.collectives: list = []  # ``distributed.Collective``s
        self.live = 0
        self.peak = 0
        self.flops = 0.0
        self.bytes = 0.0
        self.kernel_calls: Counter = Counter()
        self._held = {}  # id(storage) -> (weakref, bytes)

    # storages
    def hold(self, t) -> None:
        """Count ``t``'s storage (a DTensor's local shard's) as live until
        it is freed."""
        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        key = id(st)
        ref = self._held.get(key)
        if ref is not None and ref[0]() is st:
            return
        n = _granule(st.nbytes())

        def freed(_, key=key, n=n):
            if self._held.pop(key, None) is not None:
                self.live -= n

        self._held[key] = (weakref.ref(st, freed), n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def hold_tree(self, tree) -> None:
        for t in leaves(tree):
            if isinstance(t, torch.Tensor):
                self.hold(t)

    def _kernel(self, name: str, ops: float, nbytes: float) -> None:
        self.kernel_calls[name] += 1
        self.flops += ops
        self.bytes += nbytes

    def __enter__(self):
        runtime.SHAPE_ONLY_HOOKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        runtime.SHAPE_ONLY_HOOKS.remove(self._kernel)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator) or _shadow():
            return out
        self.collectives.extend(collectives_of(func, args, kwargs, out,
                                               self.mesh))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self.hold(t)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if outs and not any(r.alias_info is not None
                            and not r.alias_info.is_write
                            for r in func._schema.returns):
            # a view, or an op that returns no tensor, moves nothing
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.nbytes for t in ins + outs)
        return out


def track(fn, *inputs, mesh=None) -> dict:
    """Run ``fn(*inputs)`` under a ``StepTrace`` (the inputs' storages held
    from the start; collectives named by ``mesh``'s axes): the rank's peak
    bytes, its inputs' bytes, operations, bytes moved, kernel calls and
    collectives (priced by ``collective_bytes``)."""
    with StepTrace(mesh) as tr:
        tr.hold_tree(inputs)
        held = tr.live
        out = fn(*inputs)
        del out
    return {"peak_bytes": int(tr.peak), "input_bytes": int(held),
            "flops": float(tr.flops), "bytes": float(tr.bytes),
            "kernel_calls": dict(tr.kernel_calls),
            "coll": collective_bytes(tr.collectives)}


# ---------------------------------------------------------------- the step
class _Shard:
    """Rank 0's side of one leaf: its placements and local shape."""

    def __init__(self, placements, shape):
        self.placements, self.shape = placements, shape


def _shards(tree, specs, mesh):
    """Each leaf's ``_Shard`` under its spec, for a tree of meta tensors;
    made outside a fake mode (the mesh's coordinates are real tensors)."""
    def one(t, spec):
        pl = placements(spec, mesh)
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        return _Shard(pl, tuple(local))

    return tree_map(one, tree, specs)


def _placed(tree, shards, mesh, device):
    """Fake DTensors for a tree of meta tensors: each leaf rank 0's shard
    (``_shards``), made as a fake tensor of the shard's shape and wrapped
    with the global shape, so ``place`` passes it through as it is."""
    def one(t, sh):
        local = torch.empty(sh.shape, dtype=t.dtype, device=device)
        return DTensor.from_local(
            local, mesh, sh.placements, run_check=False, shape=t.shape,
            stride=torch.empty(t.shape, device="meta").stride())

    return tree_map(one, tree, shards)


def mesh_step(kind: str, cfg, mesh, args, **step_kw):
    """(the mesh step of ``kind``, the specs it places its first three
    arguments by): ``launch.steps.jit_train_step`` ("train"),
    ``jit_prefill_step`` ("prefill") or ``jit_decode_step`` ("decode"),
    for ``args`` (params, opt, batch), (params, cache, batch) or (params,
    cache, tokens, pos).  ``step_kw`` goes to the step factory
    (``q_chunk``, ``n_micro``, ``opt_cfg``)."""
    ax = MeshAxes(mesh)
    ps = param_specs(args[0], ax, cfg)
    if kind == "train":
        os_ = opt_state_specs(args[0], ax, cfg)
        return (steps.jit_train_step(cfg, mesh, *args, **step_kw),
                (ps, OptState(step=(), mu=os_, nu=os_),
                 batch_specs(cfg, ax, args[2])))
    if kind == "prefill":
        return (steps.jit_prefill_step(cfg, mesh, *args, **step_kw),
                (ps, cache_specs(args[1], ax, cfg),
                 batch_specs(cfg, ax, args[2])))
    if kind == "decode":
        tok = batch_specs(cfg, ax, {"tokens": args[2]})["tokens"]
        return (steps.jit_decode_step(cfg, mesh, args[0], args[1],
                                      args[2].shape[0], **step_kw),
                (ps, cache_specs(args[1], ax, cfg), tok))
    raise ValueError(f"kind must be train, prefill or decode, got {kind!r}")


def trace_step(kind: str, cfg, mesh, args, *, device=None, **step_kw):
    """Trace ``mesh_step``'s step on fake tensors and count rank 0's side
    of it (``track``).

    ``args`` are the step's arguments as meta tensors (``pos`` an int);
    each is placed as the step places it, as rank 0's shards on ``device``
    (default ``trace_device()``).  On the card's device ``peak_bytes``
    adds ``CUBLAS_WORKSPACE_BYTES`` (``workspace_bytes``) to the
    tracker's.
    """
    step, specs = mesh_step(kind, cfg, mesh, args, **step_kw)
    device = device or trace_device()
    shards = [_shards(a, sp, mesh) for a, sp in zip(args[:3], specs)]
    with fake_mode():
        placed = [_placed(a, sh, mesh, device)
                  for a, sh in zip(args[:3], shards)]
        res = track(step, *placed, *args[3:], mesh=mesh)
    # the card's path holds cuBLAS's workspaces beside the step's tensors
    res["workspace_bytes"] = CUBLAS_WORKSPACE_BYTES if torch.device(
        device).type in ("cuda", "meta") else 0
    res["peak_bytes"] += res["workspace_bytes"]
    return res


def cell_args(cfg, shape, *, moment_dtype=torch.float32):
    """The meta arguments of a cell's step (``launch.specs``), with
    ``trace_step``'s step keywords: the reference's ``q_chunk`` (the whole
    sequence for training, 2048 for prefill)."""
    p = S.params_shape(cfg)
    b = S.input_specs(cfg, shape)
    if shape.kind == "train":
        return ((p, S.opt_shape(p, moment_dtype), b),
                {"q_chunk": shape.seq_len,
                 "opt_cfg": AdamWConfig(moment_dtype=moment_dtype)})
    if shape.kind == "prefill":
        c = (S.cache_shape(cfg, shape.global_batch, shape.seq_len)
             if cfg.supports_decode else {})
        return (p, c, b), {"q_chunk": 2048}
    c = S.cache_shape(cfg, shape.global_batch, shape.seq_len)
    return (p, c, b["tokens"], shape.seq_len - 1), {}


def micro_attempts(shape) -> list:
    """The reference's auto-fit: (n_micro, Adam moment dtype) in the order
    tried, microbatch counts dividing the per-row-of-16 batch, bf16
    moments last for training."""
    if shape.kind == "train":
        opts = [1, 2, 4, 8, 16]
    elif shape.kind == "prefill":
        opts = [1, 2]  # chunked prefill (serving-style)
    else:
        opts = [1]
    per_dev_batch = max(shape.global_batch // 16, 1)
    opts = [m for m in opts if per_dev_batch % m == 0] or [1]
    attempts = [(m, torch.float32) for m in opts]
    if shape.kind == "train":  # last resort: bf16 Adam moments
        attempts.append((opts[-1], torch.bfloat16))
    return attempts


def mandatory_bytes(cfg, shape, mesh) -> tuple:
    """(the rank's cache bytes under ``cache_specs``, bf16 parameters over
    the ranks plus those): what every decode step must stream.  ``mesh``
    is a ``DeviceMesh`` or a ``(shape, names)`` pair."""
    ax = MeshAxes(mesh)
    c = S.cache_shape(cfg, shape.global_batch, shape.seq_len)

    def dev_bytes(leaf, spec):
        shards = math.prod(ax.shape[a] for e in spec if e is not None
                           for a in (e if isinstance(e, tuple) else (e,)))
        return math.prod(leaf.shape) * leaf.element_size() // shards

    cache_dev = sum(leaves(tree_map(dev_bytes, c, cache_specs(c, ax, cfg))))
    n_chips = math.prod(ax.shape.values())
    return cache_dev, float(2 * cfg.param_count() / n_chips + cache_dev)


# -------------------------------------------------------------- single cell
def run_cell(arch: str, shape_name: str, mesh_kind: str,
             skip_cost: bool = False, overrides: dict | None = None):
    """Size one (arch x shape x mesh) cell: its memory pass and, on one
    pod, its cost pass (module docstring), as a JSON-ready dict."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = get_shape(shape_name)
    runnable, why = cell_is_runnable(cfg, shape)
    if not runnable:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": why}

    multi = mesh_kind == "multi"
    t0 = time.perf_counter()
    padded = dataclasses.replace(cfg, q_head_pad_multiple=16)

    with fake_group(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device_type="cuda")
        n_chips = mesh.size()
        # ---- 1. memory: auto-fit microbatching to the card's memory
        attempts = micro_attempts(shape)
        for n_micro, moment_dtype in attempts:
            mem = trace_cell(padded, shape, mesh, n_micro, moment_dtype)
            if mem["peak_bytes"] <= HBM_LIMIT or \
                    (n_micro, moment_dtype) == attempts[-1]:
                break
        peak = mem["peak_bytes"]
        result = {
            "arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "status": "ok", "n_chips": int(n_chips), "n_micro": n_micro,
            "moment_dtype": str(moment_dtype).removeprefix("torch."),
            "peak_bytes": int(peak),
            "fits_hbm": bool(peak <= HBM_LIMIT),
            "input_bytes": mem["input_bytes"],
            "workspace_bytes": mem["workspace_bytes"],
            "kernel_calls": mem["kernel_calls"],
        }
        if shape.kind == "decode":
            cache_dev, need = mandatory_bytes(cfg, shape, mesh)
            result["mandatory_bytes_per_chip"] = need
            result["cache_bytes_per_chip"] = int(cache_dev)
        result["full_trace_s"] = round(time.perf_counter() - t0, 1)
        if skip_cost or multi:
            return result

        # ---- 2. cost decomposition (single-pod roofline terms)
        levels = cost_levels(cfg)
        costs = level_costs(padded, shape, mesh, levels, n_micro,
                            moment_dtype)
    result.update(roofline(cfg, shape, n_chips, costs, levels))
    result["total_s"] = round(time.perf_counter() - t0, 1)
    return result


def trace_cell(cfg, shape, mesh, n_micro: int = 1,
               moment_dtype=torch.float32) -> dict:
    """``trace_step`` of a cell's step (``cell_args``) at ``n_micro``
    microbatches (training and prefill) and the Adam moments' dtype."""
    args, kw = cell_args(cfg, shape, moment_dtype=moment_dtype)
    if shape.kind != "decode":
        kw["n_micro"] = n_micro
    return trace_step(shape.kind, cfg, mesh, args, **kw)


def cost_levels(cfg) -> list:
    """The depths the cost pass traces: L1 = the first dense layers + 2,
    L2 = L1 + 1, and for the hybrid the depth of its second
    shared-attention application.  The reference starts at the first
    dense layers + 1; here a stack of one layer is DTensor's edge case
    (it places a one-layer stack's gradients otherwise than a deeper
    stack's), so the step from L1 to L2 would not be a layer's cost."""
    fd = cfg.first_dense_layers if cfg.is_moe else 0
    levels = [fd + 2, fd + 3]
    if cfg.family == "hybrid":
        levels.append(cfg.hybrid_attn_every + 1)
    return levels


def level_costs(cfg, shape, mesh, levels, n_micro: int = 1,
                moment_dtype=torch.float32) -> dict:
    """Per-rank operations, bytes and collectives of the cell's step at
    each depth of ``levels``."""
    costs = {}
    for lv in levels:
        c = trace_cell(dataclasses.replace(cfg, num_layers=lv), shape, mesh,
                       n_micro, moment_dtype)
        costs[lv] = {"flops": c["flops"], "bytes": c["bytes"],
                     "ici_bytes": c["coll"]["ici_bytes"], "coll": c["coll"]}
    return costs


def combine(cfg, costs: dict, levels: list, field: str) -> float:
    """Full-depth ``field`` from the level costs: L1's, plus (L - L1) of
    the per-layer step L2 - L1, plus, for the hybrid, the extra shared
    attention applications at their own cost (the reference's rule)."""
    L1, L2 = levels[0], levels[1]
    c1, c2 = costs[L1][field], costs[L2][field]
    per_layer = max(c2 - c1, 0.0)
    total = c1 + (cfg.num_layers - L1) * per_layer
    if cfg.family == "hybrid":
        c7 = costs[levels[-1]][field]
        attn_cost = max(c7 - c1 - (levels[-1] - L1) * per_layer, 0.0)
        n_apps = -(-cfg.num_layers // cfg.hybrid_attn_every)
        total += (n_apps - 1) * attn_cost
    return total


def roofline(cfg, shape, n_chips: int, costs: dict, levels: list) -> dict:
    """The reference's roofline terms from the level costs, at the H100's
    constants."""
    flops = combine(cfg, costs, levels, "flops")
    bytes_ = combine(cfg, costs, levels, "bytes")
    ici = combine(cfg, costs, levels, "ici_bytes")
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_ / HBM_BW
    t_coll = ici / NVLINK_BW
    dominant = max([("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)], key=lambda kv: kv[1])[0]
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * (cfg.active_param_count() if cfg.is_moe
                          else cfg.param_count()) * tokens
    model_flops_per_chip = model_flops / n_chips
    return {
        "flops_per_chip": flops,
        "bytes_per_chip": bytes_,
        "collective_bytes_per_chip": ici,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_per_chip": model_flops_per_chip,
        "useful_flop_ratio": model_flops_per_chip / flops if flops else 0.0,
        "roofline_bound_s": max(t_compute, t_memory, t_coll),
        "collective_detail": costs[levels[1]]["coll"]["bytes_by_kind"],
        "levels": {str(k): v for k, v in costs.items()},
    }


# --------------------------------------------------------------------- sweep
def cells(meshes, only_arch=None, only_shape=None) -> list:
    """The sweep's (arch, shape, mesh) cells, in the reference's order."""
    return [(arch, shape, mesh) for arch in ARCH_NAMES
            if not only_arch or arch == only_arch
            for shape in SHAPES if not only_shape or shape == only_shape
            for mesh in meshes]


def sweep(out_path: str, meshes, only_arch=None, only_shape=None,
          timeout=3600):
    """Every cell in its own process (``--cell``), with a timeout; the
    results accumulate in ``out_path`` (cells already there are kept)."""
    try:
        with open(out_path) as f:
            results = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        results = {}

    todo = [c for c in cells(meshes, only_arch, only_shape)
            if _cell_key(*c) not in results]
    print(f"[dryrun] {len(todo)} cells to run", flush=True)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p)}
    for i, (arch, shape, mesh) in enumerate(todo):
        key = _cell_key(arch, shape, mesh)
        print(f"[dryrun] ({i+1}/{len(todo)}) {key}", flush=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--cell",
               arch, shape, mesh]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=timeout, env=env)
            if proc.returncode == 0:
                payload = json.loads(proc.stdout.strip().splitlines()[-1])
            else:
                payload = {"arch": arch, "shape": shape, "mesh": mesh,
                           "status": "error",
                           "error": proc.stderr.strip()[-2000:]}
        except subprocess.TimeoutExpired:
            payload = {"arch": arch, "shape": shape, "mesh": mesh,
                       "status": "timeout", "timeout_s": timeout}
        results[key] = payload
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1, sort_keys=True)
        status = payload.get("status")
        extra = ""
        if status == "ok" and "dominant" in payload:
            extra = (f" dominant={payload['dominant']}"
                     f" bound={payload['roofline_bound_s']:.4f}s"
                     f" useful={payload['useful_flop_ratio']:.2f}")
        print(f"[dryrun]   -> {status}{extra}", flush=True)
    print("[dryrun] sweep complete", flush=True)


def run_test_cell(arch: str):
    """The CI cell: the reduced config's train step on a fake (2, 2) mesh,
    batch 8 x 32 (the frontends' input shapes), f32 parameters."""
    cfg = get_config(arch).reduced()

    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    p = S.params_shape(cfg, dtype=torch.float32)
    o = init_opt_state(p)
    b = {"tokens": meta(8, 32), "labels": meta(8, 32)}
    if cfg.frontend == "audio_frames":
        b = {"embeddings": meta(8, 32, cfg.d_model, dtype=torch.float32),
             "labels": meta(8, 32)}
    if cfg.frontend == "vision_patches":
        fs = cfg.frontend_seq
        b = {"embeddings": meta(8, fs, cfg.d_model, dtype=torch.float32),
             "tokens": meta(8, 32 - fs), "labels": meta(8, 32 - fs)}
    with fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cuda")
        res = trace_step("train", cfg, mesh, (p, o, b), q_chunk=32)
    return {"arch": arch, "status": "ok",
            "temp_bytes": res["peak_bytes"] - res["input_bytes"],
            "peak_bytes": res["peak_bytes"],
            "kernel_calls": res["kernel_calls"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", nargs=3, metavar=("ARCH", "SHAPE", "MESH"))
    ap.add_argument("--test-cell", default=None,
                    help="CI smoke: reduced config on a 2x2 mesh")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg overrides key=value (hillclimb variants)")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--out", default=str(ROOT / "build" / "dryrun.json"))
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args(argv)

    if args.test_cell:
        try:
            res = run_test_cell(args.test_cell)
        except Exception as e:
            res = {"arch": args.test_cell, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-1500:]}
        print(json.dumps(res))
        return 0 if res["status"] == "ok" else 1
    if args.cell:
        overrides = {}
        for kv in args.set:
            k, v = kv.split("=", 1)
            overrides[k] = (v.lower() == "true") if v.lower() in (
                "true", "false") else (int(v) if v.lstrip("-").isdigit()
                                       else v)
        try:
            res = run_cell(*args.cell, overrides=overrides or None)
        except Exception as e:  # surfaced as JSON for the sweep
            res = {"arch": args.cell[0], "shape": args.cell[1],
                   "mesh": args.cell[2], "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-1500:]}
        print(json.dumps(res))
        return 0
    if args.sweep:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        sweep(args.out, args.meshes.split(","), args.arch, args.shape,
              args.timeout)
        return 0
    print("use --cell ARCH SHAPE MESH, --test-cell ARCH or --sweep")
    return 2


if __name__ == "__main__":
    sys.exit(main())
