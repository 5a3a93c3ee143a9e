"""The vet optimality measure (paper §4.2-4.4), batched in PyTorch.

The port of ``repro.core.vet``:

    PR  = sum_r Y_r                       (profiled real cost)
    EI  = sum_{r<=t} Y_r + sum_{r>t} g(r) (estimated ideal cost)
    OC  = sum_{r>t} (Y_r - g(r))          (estimated overhead cost)
    vet_task = PR / EI,   vet_job = mean_i vet_task^(i)

``vet_pipeline`` takes one profile ``(n,)`` or a batch ``(rows, n)`` of
equal-length profiles and runs every stage on the whole batch at once (the
reference maps its single-profile function with ``vmap``; here the batch
dimension is written out).  Estimator modes match the reference:
``cut_space`` "log" (framework default) or "raw" (paper-literal), and
``buckets`` (cut and slope estimated on the B-bucket mean curve once a
profile has at least ``4*B`` records, mapped back to record rank).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .changepoint import estimate_changepoint, xla_order_log

__all__ = ["VetJobResult", "VetResult", "ei_oc", "vet_job", "vet_pipeline",
           "vet_task"]

_TINY = 1e-12


class VetResult(NamedTuple):
    """Per-task vet diagnostics (0-dim tensors; .item() for floats)."""

    vet: torch.Tensor  # PR / EI
    ei: torch.Tensor  # estimated ideal cost (seconds)
    oc: torch.Tensor  # estimated overhead cost (seconds)
    pr: torch.Tensor  # profiled real cost (seconds) == EI + OC
    t: torch.Tensor  # change-point (1-indexed record-rank prefix size)
    n: int  # number of records


class VetJobResult(NamedTuple):
    vet_job: torch.Tensor
    tasks: tuple  # tuple[VetResult, ...]

    def _stack(self, field: str) -> torch.Tensor:
        return torch.stack([getattr(r, field) for r in self.tasks])

    @property
    def ei_mean(self):
        return self._stack("ei").mean()

    @property
    def ei_std(self):
        return self._stack("ei").std(correction=0)

    @property
    def pr_mean(self):
        return self._stack("pr").mean()

    @property
    def pr_std(self):
        return self._stack("pr").std(correction=0)


def _pick(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``values[r, index[r]]`` for every row; a negative index wraps, as
    jnp indexing does."""
    m = values.shape[-1]
    return torch.gather(values, -1, (index % m).unsqueeze(-1)).squeeze(-1)


def _cut_and_slope(y: torch.Tensor, omega: int, buckets, cut_space: str,
                   changepoint_fn=None):
    """Change-point on the (optionally bucketed, optionally logged) sorted
    rows ``y`` (rows, n); returns ``(t_records, anchor, per-record slope)``,
    one entry per row.

    ``changepoint_fn(z, omega=...) -> t`` swaps the SSE-scan implementation
    (the CUDA kernel on the engine's ``cuda`` backend); the default is the
    plain prefix-sum scan.
    """
    rows, n = y.shape
    use_buckets = buckets is not None and n >= 4 * buckets
    if use_buckets:
        per = n // buckets
        curve = y[:, :per * buckets].reshape(rows, buckets, per).mean(dim=-1)
    else:
        per = 1
        curve = y
    z = xla_order_log(torch.clamp(curve, min=_TINY)) if cut_space == "log" \
        else curve
    m = curve.shape[-1]
    if m < 2 * omega:
        # Degenerate profile, shorter than the probing span: no valid split
        # exists.  The pipeline's fallback is t=1 (the argmin of the all-inf
        # landscape), which the fused window-vet kernel reproduces.
        tb = torch.ones(rows, dtype=torch.int64, device=y.device)
    else:
        cp = estimate_changepoint if changepoint_fn is None else changepoint_fn
        tb = cp(z, omega=omega).to(torch.int64)  # 1-indexed on the curve
    i = torch.clamp(tb - 1, 1, m - 1)
    anchor = _pick(curve, i)
    slope = torch.clamp(anchor - _pick(curve, i - 1), min=0.0) / per
    t = tb * per  # record-rank prefix size
    return t.to(torch.int32), anchor, slope


def ei_oc(y_sorted, t, anchor=None, slope=None):
    """EI and OC per sorted row with change-point ``t`` (record rank).

    g(r) = anchor + (r - t) * slope for r > t, capped elementwise at the
    observation (a record's ideal time cannot exceed its actual time), so
    EI <= PR, OC >= 0 and EI + OC = PR.  Defaults reproduce the paper's g
    (anchor = Y_t, slope = Y_t - Y_{t-1}).
    """
    y = torch.as_tensor(y_sorted).to(torch.float32)
    squeeze = y.dim() == 1
    y = y.reshape(-1, y.shape[-1])
    n = y.shape[-1]
    t = torch.as_tensor(t, device=y.device).to(torch.int64).reshape(-1)
    t = t.expand(y.shape[0])
    i = torch.clamp(t - 1, 1, n - 1)
    if anchor is None:
        anchor = _pick(y, i)
    if slope is None:
        slope = torch.clamp(_pick(y, i) - _pick(y, i - 1), min=0.0)
    anchor = torch.as_tensor(anchor, device=y.device).reshape(-1, 1)
    slope = torch.as_tensor(slope, device=y.device).reshape(-1, 1)
    ranks = torch.arange(1, n + 1, device=y.device)
    prefix = ranks <= t[:, None]
    g = anchor + slope * (ranks - t[:, None]).to(torch.float32)
    g = torch.minimum(g, y)  # ideal never exceeds observed
    ei = torch.where(prefix, y, g).sum(dim=-1)
    oc = torch.where(prefix, 0.0, y - g).sum(dim=-1)
    if squeeze:
        return ei[0], oc[0]
    return ei, oc


def vet_pipeline(times, omega: int = 3, buckets: int | None = 1000,
                 cut_space: str = "log", changepoint_fn=None):
    """Raw (unsorted) record times -> ``(vet, ei, oc, pr, t)``.

    ``times`` is one profile ``(n,)`` (0-dim outputs) or a batch
    ``(rows, n)`` (``(rows,)`` outputs), on any device; every stage runs
    batched on that device.  f32 throughout, as in the reference.
    """
    if cut_space not in ("raw", "log"):
        raise ValueError(f"cut_space must be 'raw' or 'log', got {cut_space!r}")
    x = torch.as_tensor(times).to(torch.float32)
    squeeze = x.dim() == 1
    x = x.reshape(-1, x.shape[-1])
    y = torch.sort(x, dim=-1).values
    t, anchor, slope = _cut_and_slope(y, omega, buckets, cut_space,
                                      changepoint_fn)
    ei, oc = ei_oc(y, t, anchor, slope)
    pr = y.sum(dim=-1)
    out = (pr / ei, ei, oc, pr, t)
    return tuple(a[0] for a in out) if squeeze else out


def vet_task(times, omega: int = 3, buckets: int | None = 1000,
             cut_space: str = "log") -> VetResult:
    """vet for one task from its raw (unsorted) record times: the scalar
    per-row oracle (on the host for host input).

    Defaults are the framework estimator (bucketed log-cut); the paper's
    literal estimator is ``buckets=None, cut_space="raw"``.
    """
    x = torch.as_tensor(times)
    vet, ei, oc, pr, t = vet_pipeline(x.reshape(-1), omega, buckets,
                                      cut_space)
    return VetResult(vet=vet, ei=ei, oc=oc, pr=pr, t=t, n=int(x.numel()))


def vet_job(task_times: Sequence, omega: int = 3,
            buckets: int | None = 1000, cut_space: str = "log") -> VetJobResult:
    """vet_job = simple average of per-task vet scores (paper §4.4).

    Tasks may have different record counts, so this loops over tasks.
    """
    results = tuple(
        vet_task(t, omega=omega, buckets=buckets, cut_space=cut_space)
        for t in task_times
    )
    if not results:
        raise ValueError("vet_job needs at least one task profile")
    return VetJobResult(
        vet_job=torch.stack([r.vet for r in results]).mean(), tasks=results)
