"""The one-token decode step replayed as a CUDA graph.

``models.model.decode_step`` hands every step to ``DECODE`` (a
``DecodeGraphs``).  A step is eligible for a graph when it runs on CUDA,
off a mesh (``ctx.mesh is None`` and no parameter or cache leaf a
DTensor), and the active ``RoutingLog``, if any, forces nothing.  An
eligible step is keyed by its config (``id(cfg)``), its tokens' shape,
dtype and device, and the address, shape, strides and dtype of every
parameter and cache leaf:

- the first call of a key runs the eager step, on the runner's own stream,
  so that cuBLAS's state for that stream exists before a capture;
- the second captures the step into a ``torch.cuda.CUDAGraph`` on that
  stream, with static tokens and a 0-d int64 position on the device, in
  one memory pool shared by every graph of the device, in
  ``capture_error_mode="thread_local"`` (so another thread's CUDA work,
  the dashboard's, does not break it), then replays it;
- later calls copy the tokens in, fill the position and replay.

A replay launches the eager step's kernels, in the same order, on the
same addresses, so it gives the eager step's bits.  Each call returns a
fresh copy of the graph's logits, which the next replay overwrites; as
every output is copied before another graph replays, graphs sharing the
pool may replay in any order.  The
MoE layers record their routing into the runner's own ``RoutingLog``
while the step is captured, so the graph's ``Routing`` tensors are
static; a replay made while the caller's log records appends copies of
them, one ``Routing`` a call as the eager step appends.  A replayed step
has no autograd history.  A key whose capture raises runs eager for good.
A replaced tensor (a new cache) is a new key; the runner holds
``MAX_GRAPHS`` keys and drops the oldest.  One thread at a time steps a
runner.

``COUNTS`` counts captures, replays and eager steps by reason (``cpu``,
``mesh``, ``forced``, ``first``, ``capture_failed``).  Under a tracer the
step's ``model.decode_step`` span carries ``graph``: ``"replay"``,
``"capture"`` or ``"eager"``.  A replay runs none of the step's Python, so
no span opens inside its ``model.decode_step``.
"""

from __future__ import annotations

import collections
import dataclasses
import traceback
import warnings
from typing import Callable, Optional

import torch

from .. import tree
from ..obs.trace import region
from . import layers as L

__all__ = ["COUNTS", "DecodeGraphs", "GraphCounts", "MAX_GRAPHS"]

MAX_GRAPHS = 8


@dataclasses.dataclass
class GraphCounts:
    """Decode steps by how they ran: graphs captured (``captures``, each
    step that captured one), steps replayed from an earlier capture
    (``replays``) and eager steps by reason (``eager``); ``error`` the last
    failed capture's traceback."""

    captures: int = 0
    replays: int = 0
    eager: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    error: str = ""


COUNTS = GraphCounts()


def _eager_reason(ctx, tokens, leaves, log) -> Optional[str]:
    """Why a step with these tokens, parameter and cache ``leaves``, and
    active routing ``log`` runs eager (``"mesh"``, ``"forced"``, ``"cpu"``),
    or None when it may replay a graph."""
    from torch.distributed.tensor import DTensor  # once, not once a leaf

    if ctx.mesh is not None or any(isinstance(t, DTensor) for t in leaves):
        return "mesh"
    if log is not None and log.forcing:
        return "forced"
    if tokens.device.type != "cuda":
        return "cpu"
    return None


@dataclasses.dataclass
class _Graph:
    """One key's captured step: the graph, its static inputs and outputs.
    ``cfg`` keeps the config alive, so its ``id`` names no other while the
    key lives."""

    cfg: object
    graph: "torch.cuda.CUDAGraph"
    tokens: torch.Tensor
    pos: torch.Tensor
    logits: Optional[torch.Tensor] = None
    routing: tuple = ()


def _abandon(graph, dev, pool) -> None:
    """End a capture that raised.  Where ``capture_end`` raises too (the
    capture was invalidated), the stream has left capture but the
    allocator still records into ``pool`` for it: end that too, where
    this PyTorch names the call."""
    try:
        graph.capture_end()
        return
    except RuntimeError:
        pass
    end = getattr(torch._C, "_cuda_endAllocateToPool", None)
    if end is not None:
        try:
            end(dev.index, pool)
        except RuntimeError:
            pass


class DecodeGraphs:
    """Replays ``body`` (``body(cfg, params, cache, tokens, pos, ctx) ->
    logits``, the eager decode step, cache written in place) as a CUDA
    graph where the step is eligible (module docstring)."""

    def __init__(self, body: Callable):
        self._body = body
        self._graphs = collections.OrderedDict()  # key -> _Graph or None
        self._failed = set()
        self._streams = {}
        self._pools = {}

    def step(self, cfg, params, cache, tokens, pos, ctx):
        """The step's logits (B, V), the cache written in place."""
        log = L.ROUTING
        leaves = tree.leaves(params) + tree.leaves(cache)
        why = _eager_reason(ctx, tokens, leaves, log)
        key = None
        if why is None:
            key = self._key(cfg, tokens, leaves)
            if key in self._failed:
                why = "capture_failed"
            elif key not in self._graphs:
                why = "first"
                self._admit(key, None)
        g = self._graphs.get(key)
        mode = "eager" if why else "capture" if g is None else "replay"
        with region("model.decode_step", batch=tokens.shape[0], pos=pos,
                    graph=mode) as sp:
            if why == "first":
                COUNTS.eager[why] += 1
                return self._on_own_stream(
                    tokens.device, self._body, cfg, params, cache, tokens,
                    pos, ctx)
            if why:
                COUNTS.eager[why] += 1
                return self._body(cfg, params, cache, tokens, pos, ctx)
            if g is None:
                try:
                    g = self._capture(cfg, params, cache, tokens, ctx)
                except RuntimeError as e:
                    COUNTS.error = "".join(traceback.format_exception(e))
                    warnings.warn(f"decode step capture failed, its key "
                                  f"runs eager: {e!r}", RuntimeWarning)
                    del self._graphs[key]
                    self._failed.add(key)
                    COUNTS.eager["capture_failed"] += 1
                    sp.set(graph="eager")
                    return self._body(cfg, params, cache, tokens, pos, ctx)
                self._admit(key, g)
                COUNTS.captures += 1
            else:
                self._graphs.move_to_end(key)
                COUNTS.replays += 1
            return self._replay(g, tokens, pos, log)

    @staticmethod
    def _key(cfg, tokens, leaves) -> tuple:
        return (id(cfg), tuple(tokens.shape), tokens.dtype, tokens.device,
                tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                      for t in leaves))

    def _admit(self, key, entry) -> None:
        self._graphs[key] = entry
        self._graphs.move_to_end(key)
        while len(self._graphs) > MAX_GRAPHS:
            self._graphs.popitem(last=False)

    def _on_own_stream(self, device, fn, *args):
        """``fn(*args)`` on the device's own stream, ordered after the
        current stream's work and before its later work.  Every use of the
        stream begins with that wait, so a tensor it allocated and the
        caller frees is reused there only after the caller's reads."""
        cur = torch.cuda.current_stream(device)
        own = self._streams.get(device)
        if own is None:
            own = self._streams[device] = torch.cuda.Stream(device)
        own.wait_stream(cur)
        with torch.cuda.device(device), torch.cuda.stream(own):
            out = fn(*args)
        cur.wait_stream(own)
        return out

    def _capture(self, cfg, params, cache, tokens, ctx) -> _Graph:
        dev = tokens.device
        g = _Graph(cfg, torch.cuda.CUDAGraph(), torch.empty_like(tokens),
                   torch.zeros((), dtype=torch.int64, device=dev))
        if dev not in self._pools:
            with torch.cuda.device(dev):
                self._pools[dev] = torch.cuda.graph_pool_handle()
        own = L.RoutingLog()

        def capture():
            pool = self._pools[dev]
            g.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                with L.recording(own), torch.no_grad():
                    g.logits = self._body(cfg, params, cache, g.tokens,
                                          g.pos, ctx)
            except BaseException:
                _abandon(g.graph, dev, pool)
                del self._pools[dev]  # later captures take a pool of their own
                raise
            g.graph.capture_end()

        self._on_own_stream(dev, capture)
        g.routing = tuple(own.calls)
        return g

    @staticmethod
    def _replay(g: _Graph, tokens, pos, log):
        g.tokens.copy_(tokens)
        g.pos.fill_(pos)
        g.graph.replay()
        if log is not None:
            log.calls.extend(
                L.Routing(*(getattr(r, f.name).clone()
                            for f in dataclasses.fields(L.Routing)))
                for r in g.routing)
        return g.logits.clone()
