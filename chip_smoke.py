#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Builds the CUDA kernel library from ``src/repro_torch/kernels/csrc`` and
drives the port's main paths on one GPU, in five phases:

1. ``kernels``  — each kernel against its plain PyTorch version on the card,
   at the shapes the main paths give it, with CUDA-event times and bounds;
2. ``job``      — the paper's post-hoc measure on a 1024-task x 65,536-record
   Hadoop job (``VetEngine("cuda").vet_batch`` and ``vet_job``);
3. ``fleet_fused``  — a 4096-stream ``VetMux`` on the fused window-vet path;
4. ``fleet_gather`` — a 1024-stream ``VetMux`` on the bucketed gather path;
5. ``serve``    — ``repro_torch.launch.serve.serve`` on full-width
   mamba2-130m (batch 4, 512-token prompts, 331 generated tokens): the SSD
   kernel in every layer's prefill, the decode loop and its live vet
   dashboard.  Prefill logits through the kernel are held against the plain
   SSD path on the same card and weights (|kernel - plain| <= 1e-3 of the
   largest logit), the greedy tokens of the first decode steps must be
   equal, and the reduced config's prefill on the card is held against the
   same weights on the CPU.

Every engine result is held against the ``torch`` backend (the plain path)
on the card under the near-tie contract: where the change-point agrees,
vet/ei/oc/pr agree to 1e-5 (relative); where it differs, the plain path's
own SSE landscape puts the two cuts within 1e-4 (relative) of each other,
and the values equal the plain pipeline evaluated at the same cut to 1e-5.
Against the CPU oracle (16 job rows) a flip above 1e-4 is reported, not
failed (see ``hold``).  Kernel launch counters are zeroed just before
the CUDA path of each main-path phase and read just after it.

Usage: ``python3 chip_smoke.py`` (needs one CUDA device and nvcc).
``--phases`` runs a subset, for development.  Exits non-zero, printing no
result, when no CUDA device is available or a phase fails.  Prints one JSON
line per phase, the card's name and power limit, the kernel table, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
RTOL = 1e-5  # vet/ei/oc/pr where the cut agrees
GAP = 1e-4  # relative SSE gap allowed between two near-tie cuts
PHASES = ("kernels", "job", "fleet_fused", "fleet_gather", "serve")
SSD_RTOL = {"float32": 2e-4, "bfloat16": 5e-2}  # tests/test_kernels.py TestSSD
LOGIT_TOL = 1e-3  # serve: kernel vs plain prefill logits, of the largest


class SmokeError(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------------ timing
def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls (CUDA
    events); ``fn`` returning a non-zero CUDA error code fails the run."""
    import torch
    for _ in range(warmup):
        code = fn()
        require(not isinstance(code, int) or code == 0,
                f"kernel launch failed while timing (CUDA error {code})")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- contract
def landscape_gap(z_sorted: np.ndarray, t_a: int, t_b: int) -> float:
    """Relative SSE gap between cuts t_a and t_b on the plain landscape of
    one sorted (optionally logged) curve."""
    import torch
    from repro_torch.core.changepoint import two_segment_sse
    sse = two_segment_sse(torch.as_tensor(z_sorted, dtype=torch.float32),
                          omega=3).double().cpu().numpy()
    a, b = sse[t_a - 1], sse[t_b - 1]
    return abs(a - b) / max(abs(b), 1e-30)


def plain_at_cut(times: np.ndarray, t: int, buckets, device) -> tuple:
    """The plain pipeline on one profile with its cut forced to record rank
    ``t``: ``(vet, ei, oc)``."""
    import torch
    from repro_torch.core.vet import vet_pipeline
    from repro_torch.kernels.runtime import resolve_device
    device = resolve_device(device)
    per = sorted_curve(times, buckets)[1]
    tb = torch.tensor([int(t) // per], device=device)
    x = torch.as_tensor(np.asarray(times, np.float32), device=device)[None]
    vet, ei, oc, _, t_out = vet_pipeline(x, buckets=buckets,
                                         changepoint_fn=lambda z, omega: tb)
    require(int(t_out[0]) == int(t), "forced cut not taken")
    return float(vet[0]), float(ei[0]), float(oc[0])


def hold(got: dict, ref: dict, times_of, buckets, context: str,
         device=None, cross_device: bool = False) -> dict:
    """Near-tie contract between two per-row result sets.

    ``got``/``ref`` map vet/ei/oc/pr/t to host arrays; ``times_of(i)``
    returns row ``i``'s raw record times.  Where the cut agrees, every value
    agrees to RTOL.  Where it differs, the cuts are a near-tie (GAP on the
    plain landscape) and ``got`` equals the plain pipeline evaluated at its
    own cut to RTOL.  vet may still move across a flip (the slope is a local
    difference at the cut); the largest such move is reported.

    ``cross_device``: ``ref`` ran on the CPU, whose cumsum, mean and log
    round differently; a flip there whose gap exceeds GAP is counted in
    ``flips_over_gap`` (the cuts ROADMAP queue C logs) instead of failing,
    and must still equal the plain pipeline at its own cut.
    """
    t_got, t_ref = np.asarray(got["t"]), np.asarray(ref["t"])
    require(t_got.shape == t_ref.shape, f"{context}: row counts differ")
    same = t_got == t_ref
    err = 0.0
    for name in ("vet", "ei", "oc", "pr"):
        a = np.asarray(got[name], np.float64)
        b = np.asarray(ref[name], np.float64)
        require(np.all(np.isfinite(a)), f"{context}: non-finite {name}")
        a, b = a[same], b[same]
        if a.size:
            rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-12)
            require(rel.max() <= RTOL,
                    f"{context}: {name} off by {rel.max():.3g} (rel) on "
                    f"rows with the same cut")
            if name == "vet":
                err = max(err, float(np.abs(a - b).max()))
    max_gap, spread, over = 0.0, 0.0, 0
    for i in np.flatnonzero(~same):
        times = times_of(int(i))
        z, per = sorted_curve(times, buckets)
        gap = landscape_gap(z, int(t_got[i]) // per, int(t_ref[i]) // per)
        require(gap <= GAP or cross_device,
                f"{context}: row {i} cuts {t_got[i]} vs {t_ref[i]} differ "
                f"by SSE gap {gap:.3g}")
        over += int(gap > GAP)
        want = plain_at_cut(times, t_got[i], buckets, device)
        have = [float(got[k][i]) for k in ("vet", "ei", "oc")]
        rel = max(abs(h - w) / max(abs(w), 1e-12) for h, w in zip(have, want))
        require(rel <= RTOL, f"{context}: row {i} differs {rel:.3g} from the "
                             f"plain pipeline at its own cut")
        max_gap = max(max_gap, gap)
        spread = max(spread, abs(got["vet"][i] - ref["vet"][i])
                     / abs(ref["vet"][i]))
    return {"rows": int(t_ref.size), "cut_flips": int((~same).sum()),
            "flips_over_gap": over, "max_flip_gap": max_gap,
            "max_flip_vet_spread": float(spread), "max_abs_err_vet": err}


def sorted_curve(times: np.ndarray, buckets, log: bool = True):
    """(z_sorted, per) of one profile as core.vet._cut_and_slope forms it."""
    y = np.sort(np.asarray(times, np.float32))
    n = y.size
    per = 1
    if buckets is not None and n >= 4 * buckets:
        per = n // buckets
        y = y[:per * buckets].reshape(buckets, per).mean(axis=1,
                                                         dtype=np.float32)
    z = np.log(np.maximum(y, np.float32(1e-12))) if log else y
    return z, per


def as_rows(res) -> dict:
    return {k: np.asarray(getattr(res, k)) for k in ("vet", "ei", "oc", "pr",
                                                       "t")}


# ----------------------------------------------------------------- phases
def sim_rows(rows: int, n: int, seed0: int = 0) -> np.ndarray:
    from repro_torch.profiling import simulate_records
    return np.stack([simulate_records(n, seed=seed0 + i).times
                     for i in range(rows)])


def phase_kernels(card: str, device: str = "cuda") -> dict:
    import torch
    from repro_torch.kernels.changepoint import ops as cp
    from repro_torch.kernels.windowvet import ops as wv

    from repro_torch.kernels import runtime

    out = {"phase": "kernels", "card": card, "changepoint": [],
           "windowvet": [], "ssd": []}
    dev = torch.device(device)
    lib = runtime.load_library()

    def stream_ptr():
        return torch.cuda.current_stream().cuda_stream

    # ---- changepoint: sorted log curves at the main path's shapes -------
    for rows, n in ((1024, 1000), (1, 8192), (4096, 64)):
        z = np.log(np.sort(sim_rows(rows, n, seed0=100), axis=1)) \
            .astype(np.float32)
        ops_in = cp.prefix_inputs(torch.from_numpy(z).to(dev))
        sse_k, t_k = cp.sse_scan(*ops_in)
        sse_p, t_p = cp.sse_scan_plain(*ops_in)
        torch.cuda.synchronize()
        sse_k, sse_p = sse_k.cpu().numpy(), sse_p.cpu().numpy()
        t_k, t_p = t_k.cpu().numpy(), t_p.cpu().numpy()
        fin = np.isfinite(sse_p)
        require(np.array_equal(fin, np.isfinite(sse_k)),
                f"changepoint {rows}x{n}: +inf mask differs")
        rel = np.abs(sse_k[fin] - sse_p[fin]) / np.maximum(
            np.abs(sse_p[fin]), 1e-30)
        require(rel.max() <= RTOL,
                f"changepoint {rows}x{n}: landscape off by {rel.max():.3g}")
        flips = np.flatnonzero(t_k != t_p)
        for i in flips:
            gap = abs(sse_p[i, t_k[i] - 1] - sse_p[i, t_p[i] - 1]) / abs(
                sse_p[i, t_p[i] - 1])
            require(gap <= GAP, f"changepoint {rows}x{n}: row {i} cut gap "
                                f"{gap:.3g}")
        cy, cyy, cxy, totals, forms = ops_in
        sse_o = torch.empty_like(cy)
        t_o = torch.empty(rows, dtype=torch.int32, device=dev)
        args = ([x.data_ptr() for x in (cy, cyy, cxy, totals, *forms, sse_o,
                                        t_o)] + [rows, n, 3, stream_ptr()])
        ms = cuda_ms(lambda: lib.changepoint_sse_argmin(*args), iters=200)
        call_ms = cuda_ms(lambda: cp.sse_scan(*ops_in))
        plain_ms = cuda_ms(lambda: cp.sse_scan_plain(*ops_in))
        nbytes = 4 * (3 * rows * n + 3 * rows + 4 * n) + 4 * rows * n + 4 * rows
        bms, by = bound_ms(nbytes, 37.0 * rows * n)
        out["changepoint"].append({
            "rows": rows, "n": n, "cut_flips": int(flips.size),
            "max_abs_err": float(np.abs(sse_k[fin] - sse_p[fin]).max()),
            "max_rel_err": float(rel.max()), "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by})

    # ---- windowvet: ragged fleet tick, long rows, degenerate rows -------
    rng = np.random.default_rng(7)
    cases = {
        "ragged_64_128_192": np.tile([64, 128, 192], 8192 // 3 + 1)[:8192],
        "long_to_4000": rng.integers(2000, 4001, 512),
        "degenerate_2_5": np.tile([2, 3, 4, 5], 16),
    }
    for name, lengths in cases.items():
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        arena = sim_rows(1, int(lengths.sum()), seed0=200)[0]
        tensors, lmax, pr64, _ = wv.launch_inputs(arena, starts, lengths, dev)
        res_k = wv.fused_window_vet_scan(*tensors, lmax=lmax)
        res_p = wv.fused_window_vet_plain(*tensors, lmax=lmax)
        torch.cuda.synchronize()
        rows = lengths.size
        res_k, res_p = res_k.cpu().numpy()[:rows], res_p.cpu().numpy()[:rows]
        lanes = ("vet", "ei", "oc", "pr", "t")
        got = {k: res_k[:, j] for j, k in enumerate(lanes)}
        ref = {k: res_p[:, j] for j, k in enumerate(lanes)}
        got["t"], ref["t"] = got["t"].astype(int), ref["t"].astype(int)
        require(np.array_equal(res_k[:, 5], lengths), f"windowvet {name}: n")
        summary = hold(got, ref, lambda i: arena[starts[i]:starts[i]
                                                  + lengths[i]],
                       None, f"windowvet {name}", device=dev)
        out_o = torch.empty((tensors[1].shape[0], wv.LANES),
                            dtype=torch.float32, device=dev)
        args = ([x.data_ptr() for x in (*tensors, out_o)]
                + [tensors[1].shape[0], lmax, 3, 1, stream_ptr()])
        ms = cuda_ms(lambda: lib.windowvet_fused(*args), iters=200)
        call_ms = cuda_ms(lambda: wv.fused_window_vet_scan(*tensors,
                                                           lmax=lmax))
        plain_ms = cuda_ms(lambda: wv.fused_window_vet_plain(*tensors,
                                                             lmax=lmax))
        n = lengths.astype(np.float64)
        nbytes = 4 * arena.size + 4 * 3 * rows + 4 * 8 * rows
        # comparison sort n*log2(n), then ~60 f32 operations per record
        ops = float((n * np.log2(n) + 60.0 * n).sum())
        bms, by = bound_ms(nbytes, ops)
        out["windowvet"].append({
            "case": name, "rows": int(rows), "lmax": lmax, **summary,
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by})

    out["ssd"] = ssd_cases(dev, lib, stream_ptr)
    return out


def ssd_inputs(b, t, h, p, n, dtype, dev, seed=0):
    """TestSSD's inputs (tests/test_kernels.py), made with numpy: x, b, c
    normal; dt softplus(normal); A_log = log(linspace(1, 8, H)); D ones."""
    import torch
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    x = f(rng.standard_normal((b, t, h, p))).to(dtype)
    dt = torch.nn.functional.softplus(f(rng.standard_normal((b, t, h))))
    a_log = torch.log(torch.linspace(1.0, 8.0, h, device=dev))
    bb = f(rng.standard_normal((b, t, n))).to(dtype)
    cc = f(rng.standard_normal((b, t, n))).to(dtype)
    return x, dt, a_log, bb, cc, torch.ones(h, device=dev)


def ssd_flops(b, t, h, p, n, chunk) -> float:
    """f32 operations the chunked SSD needs: C B^T once per (batch, chunk)
    (shared by the heads), the intra-chunk scores X over the lower triangle,
    C h^T and the state update per (batch, head, chunk)."""
    nc = t // chunk
    cb = 2.0 * chunk * chunk * n * b * nc
    per_head = chunk * (chunk + 1) * p + 4.0 * chunk * p * n
    return cb + per_head * b * h * nc


def ssd_cases(dev, lib, stream_ptr, shape=(4, 512, 24, 64, 128)) -> list:
    """SSD kernel against its plain version at the serve shape (B=4, T=512,
    H=24, P=64, N=128): f32 and bf16 at chunk 64, and chunk 32 against
    chunk 64 in f32; elementwise |a - b| <= rtol + rtol |b|."""
    import torch
    from repro_torch.kernels.ssd import ops as sd
    from repro_torch.kernels.ssd.ref import ssd_scan_plain

    rows = []
    ref64 = None
    for dtype, chunk in ((torch.float32, 64), (torch.bfloat16, 64),
                         (torch.float32, 32)):
        name = str(dtype).split(".")[-1]
        tol = SSD_RTOL[name]
        x, dt, a_log, bb, cc, d = ssd_inputs(*shape, dtype, dev)
        a_neg = -torch.exp(a_log)
        y_k = sd.ssd_scan(x, dt, a_neg, bb, cc, d, chunk=chunk)
        if chunk == 32:  # state carried across chunks: 32 against 64
            y_p, against = ref64, "kernel chunk 64"
        else:
            y_p, against = ssd_scan_plain(x, dt, a_neg, bb, cc, d,
                                          chunk=chunk), "plain"
        torch.cuda.synchronize()
        if dtype == torch.float32 and chunk == 64:
            ref64 = y_k
        a, b = y_k.float().cpu().numpy(), y_p.float().cpu().numpy()
        require(np.all(np.isfinite(a)), f"ssd {name}/{chunk}: non-finite")
        err = np.abs(a - b)
        worst = float((err / (tol + tol * np.abs(b))).max())
        require(worst <= 1.0, f"ssd {name} chunk {chunk} vs {against}: "
                              f"{worst:.3g} x the tolerance {tol}")
        y_o = torch.empty_like(x)
        entry = getattr(lib, sd._ENTRY[dtype])
        args = ([t.data_ptr() for t in (x, dt, a_neg, bb, cc, d, y_o)]
                + [shape[0], shape[1], shape[2], shape[3], shape[4], chunk,
                   stream_ptr()])
        ms = cuda_ms(lambda: entry(*args), iters=50)
        call_ms = cuda_ms(lambda: sd.ssd_scan(x, dt, a_neg, bb, cc, d,
                                              chunk=chunk))
        plain_ms = cuda_ms(lambda: ssd_scan_plain(x, dt, a_neg, bb, cc, d,
                                                  chunk=chunk), iters=5)
        b_, t_, h_, p_, n_ = shape
        el = x.element_size()
        nbytes = (2 * el * b_ * t_ * h_ * p_ + 2 * el * b_ * t_ * n_
                  + 4 * b_ * t_ * h_ + 2 * 4 * h_)
        bms, by = bound_ms(nbytes, ssd_flops(*shape, chunk))
        rows.append({"dtype": name, "chunk": chunk, "against": against,
                     "shape": list(shape), "tol": tol,
                     "max_abs_err": float(err.max()),
                     "max_err_over_tol": worst, "ms": ms, "call_ms": call_ms,
                     "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                     "smem_bytes": sd.smem_bytes(p_, n_, chunk),
                     "blocks": b_ * h_})
    return rows


def zero_counts():
    from repro_torch.kernels.changepoint import ops as cp
    from repro_torch.kernels.ssd import ops as sd
    from repro_torch.kernels.windowvet import ops as wv
    cp.LAUNCHES = 0
    wv.LAUNCHES = 0
    sd.LAUNCHES = 0


def read_counts() -> dict:
    from repro_torch.kernels.changepoint import ops as cp
    from repro_torch.kernels.ssd import ops as sd
    from repro_torch.kernels.windowvet import ops as wv
    return {"changepoint": cp.LAUNCHES, "windowvet": wv.LAUNCHES,
            "ssd": sd.LAUNCHES}


def phase_job(card: str, tasks: int = 1024, records: int = 65536) -> dict:
    import torch
    from repro_torch.engine import VetEngine

    t0 = time.perf_counter()
    m = sim_rows(tasks, records)
    gen_s = time.perf_counter() - t0
    eng = VetEngine("cuda")  # device cuda, buckets=1000: the gather path
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    res = eng.vet_batch(m)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    job = eng.vet_job(list(m))
    torch.cuda.synchronize()
    job_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    require(launches["changepoint"] == 2,
            f"job: expected 2 changepoint launches, got {launches}")

    plain = VetEngine("torch").vet_batch(m)
    vs_torch = hold(as_rows(res), as_rows(plain), lambda i: m[i], 1000,
                    "job vs torch")
    oracle = VetEngine("numpy").vet_batch(m[:16])
    sub = {k: v[:16] for k, v in as_rows(res).items()}
    vs_numpy = hold(sub, as_rows(oracle), lambda i: m[i], 1000,
                    "job vs numpy", cross_device=True)
    require(np.isfinite(job) and abs(job - res.vet_job) <= 1e-9 * job,
            f"job: vet_job {job} != mean of vet_batch {res.vet_job}")
    require(res.vet.shape == (tasks,) and np.array_equal(
        res.n, np.full(tasks, records)), "job: result shape")
    require(np.all(res.vet >= 1.0 - 1e-6), "job: vet below 1")
    return {"phase": "job", "card": card, "tasks": tasks,
            "records_per_task": records, "gen_s": gen_s,
            "vet_batch_s": batch_s, "vet_job_s": job_s,
            "records_per_s": tasks * records / batch_s,
            "peak_device_bytes": int(peak), "vet_job": job,
            "launches": launches, "vs_torch": vs_torch,
            "vs_numpy_16": vs_numpy}


def run_fleet(engine, specs, chunks, ticks):
    """Feed + tick a mux; returns (mux, per-tick records, tick seconds)."""
    import torch
    from repro_torch.fleet import VetMux
    mux = VetMux(engine)
    for sid, (w, s) in enumerate(specs):
        mux.register(sid, window=w, stride=s, capacity=4 * w)
    per_tick, secs = [], []
    for k in range(ticks):
        t0 = time.perf_counter()
        for sid in range(len(specs)):
            mux.feed(sid, chunks[sid][k])
        tick = mux.tick()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        rows = {f: [] for f in ("vet", "ei", "oc", "pr", "t")}
        index = []
        for sid, count in tick.serviced.items():
            res = tick.results[sid]
            st = mux.stream(sid)
            first = st.first_retained + res.workers - count
            for f in rows:
                rows[f].append(np.asarray(getattr(res, f))[-count:])
            index.extend((sid, first + j) for j in range(count))
        per_tick.append({
            "rows": {f: np.concatenate(v) for f, v in rows.items()},
            "index": index, "dispatches": tick.dispatches,
            "n_rows": tick.rows, "flags": tick.flags})
    return mux, per_tick, secs


def first_flags(per_tick) -> dict:
    firsts = {}
    for t in per_tick:
        for f in t["flags"]:
            firsts.setdefault(f.stream_id, f.onset)
    return firsts


def compare_fleets(name, got, ref, specs, records, buckets):
    summaries = []
    for k, (a, b) in enumerate(zip(got, ref)):
        require(a["n_rows"] == b["n_rows"] and a["index"] == b["index"],
                f"{name} tick {k}: rows differ")
        require(a["dispatches"] == b["dispatches"],
                f"{name} tick {k}: dispatches {a['dispatches']} vs "
                f"{b['dispatches']}")

        def window(i, index=a["index"]):
            sid, win = index[i]
            w, s = specs[sid]
            return records[sid][win * s:win * s + w]

        summaries.append(hold(a["rows"], b["rows"], window, buckets,
                              f"{name} tick {k}"))
    fa, fb = first_flags(got), first_flags(ref)
    require(set(fa) == set(fb), f"{name}: flagged streams differ: "
                                f"{sorted(set(fa) ^ set(fb))}")
    require(all(abs(fa[s] - fb[s]) <= 2 for s in fa),
            f"{name}: flag onsets differ by more than 2 windows")
    return {"flagged_streams": len(fa),
            "cut_flips": sum(s["cut_flips"] for s in summaries),
            "rows": sum(s["rows"] for s in summaries),
            "max_flip_gap": max(s["max_flip_gap"] for s in summaries),
            "max_flip_vet_spread": max(s["max_flip_vet_spread"]
                                       for s in summaries),
            "max_abs_err_vet": max(s["max_abs_err_vet"] for s in summaries)}


def phase_fleet(card: str, name: str, specs, ticks: int, buckets: int,
                fused: bool) -> dict:
    from repro_torch.engine import VetEngine
    from repro_torch.profiling import simulate_records

    records = [simulate_records(ticks * w, seed=1000 + sid).times
               for sid, (w, _) in enumerate(specs)]
    chunks = [[r[k * w:(k + 1) * w] for k in range(ticks)]
              for r, (w, _) in zip(records, specs)]
    eng = VetEngine("cuda", buckets=buckets)
    zero_counts()
    mux, got, secs = run_fleet(eng, specs, chunks, ticks)
    launches = read_counts()
    require(mux.monitor is not None and mux.monitor.method == "cuda",
            f"{name}: monitor is not on the cuda method")
    if fused:
        require(all(t["dispatches"] == 1 for t in got),
                f"{name}: expected 1 dispatch per tick")
        require(launches["windowvet"] == ticks,
                f"{name}: windowvet launches {launches} != ticks {ticks}")
    else:
        require(launches["changepoint"] >= ticks,
                f"{name}: changepoint launches {launches} < ticks")
    plain_eng = VetEngine("torch", buckets=buckets, fused=fused)
    _, ref, plain_secs = run_fleet(plain_eng, specs, chunks, ticks)
    summary = compare_fleets(name, got, ref, specs, records, buckets)
    return {"phase": name, "card": card, "streams": len(specs),
            "ticks": ticks, "buckets": buckets,
            "rows_per_tick": [t["n_rows"] for t in got],
            "dispatches_per_tick": [t["dispatches"] for t in got],
            "tick_ms": [s * 1e3 for s in secs],
            "plain_tick_ms": [s * 1e3 for s in plain_secs],
            "launches": launches, "vs_torch": summary}


def phase_serve(card: str, cfg=None, device: str = "cuda", batch: int = 4,
                prompt_len: int = 512, gen_len: int = 331,
                decode_check: int = 8) -> dict:
    """Full-width mamba2-130m (or ``cfg``) through the port's serve entry
    point, then the kernel path's prefill held against the plain path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve, serve_inputs
    from repro_torch.models import decode_step, init_cache, prefill

    cfg = cfg if cfg is not None else get_config("mamba2-130m")
    dev = torch.device(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res = serve(cfg, batch=batch, prompt_len=prompt_len, gen_len=gen_len,
                device=dev, verbose=False)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    require(launches["ssd"] == cfg.num_layers,
            f"serve: expected {cfg.num_layers} SSD launches (one per layer's "
            f"prefill), got {launches}")
    require(res.tokens.shape == (batch, gen_len), "serve: token shape")
    require(np.all((res.tokens >= 0) & (res.tokens < cfg.vocab_size)),
            "serve: token outside the vocabulary")
    require(res.vet is not None and np.isfinite(res.vet) and res.vet >= 1.0
            - 1e-6, f"serve: vet {res.vet}")
    require(res.windows is not None and res.windows.workers >= 2,
            "serve: fewer than two window snapshots")
    require(np.all(np.isfinite(res.windows.vet)), "serve: window vets")

    # Kernel path against the plain path: same card, same weights.
    params, prompts = serve_inputs(cfg, batch=batch, prompt_len=prompt_len,
                                   seed=0, dtype=torch.float32, device=dev)
    cache = init_cache(cfg, batch, prompt_len + gen_len, device=dev)
    logits_k, _ = prefill(cfg, params, cache, {"tokens": prompts})
    logits_p, _ = prefill(cfg, params, cache, {"tokens": prompts}, plain=True)
    live = torch.arange(logits_k.shape[-1], device=dev) < cfg.vocab_size
    lk, lp = logits_k[:, live].double(), logits_p[:, live].double()
    require(bool(torch.isfinite(lk).all()), "serve: non-finite logits")
    err = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    require(err <= LOGIT_TOL * scale, f"serve: prefill logits kernel vs "
                                      f"plain off by {err:.3g} (scale "
                                      f"{scale:.3g})")
    tk = torch.argmax(logits_k, -1)[:, None]
    tp = torch.argmax(logits_p, -1)[:, None]
    require(np.array_equal(res.tokens[:, 0], tk[:, 0].cpu().numpy()),
            "serve: first token differs from a fresh prefill on the same "
            "weights")
    ck = cp = cache
    same = [bool(torch.equal(tk, tp))]
    for i in range(decode_check):
        lk_i, ck = decode_step(cfg, params, ck, tk, prompt_len + i)
        lp_i, cp = decode_step(cfg, params, cp, tp, prompt_len + i)
        tk, tp = torch.argmax(lk_i, -1)[:, None], torch.argmax(lp_i, -1)[:, None]
        same.append(bool(torch.equal(tk, tp)))
    require(all(same), f"serve: greedy tokens differ between the kernel and "
                       f"plain paths at steps {same}")
    small = reduced_vs_cpu(dev)
    ms = res.mux
    return {"phase": "serve", "card": card, "arch": cfg.name,
            "params": cfg.param_count(), "batch": batch,
            "prompt_len": prompt_len, "gen_len": gen_len,
            "prefill_ms": res.prefill_s * 1e3, "launches": launches,
            "tokens_per_s": res.tokens_per_s, "vet": res.vet, "ei": res.ei,
            "pr": res.pr, "window_vets": [float(v) for v in res.windows.vet],
            "mux_ticks": ms.ticks, "mux_dispatches": ms.dispatches,
            "anomaly_flags": len(res.flags),
            "decode_units": int(res.unit_times.size),
            "peak_device_bytes": int(peak),
            "prefill_logits_max_abs_err": err, "logit_scale": scale,
            "greedy_equal_steps": len(same), "reduced_vs_cpu": small}


def reduced_vs_cpu(dev) -> dict:
    """The reduced mamba2-130m's prefill through the kernel on the card
    against the same weights on the CPU (plain path): 1e-4 of the largest
    logit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_inputs
    from repro_torch.models import init_cache, prefill

    cfg = get_config("mamba2-130m").reduced()
    out = {}
    for where in ("cpu", dev):
        params, prompts = serve_inputs(cfg, batch=2, prompt_len=64, seed=3,
                                       dtype=torch.float32, device=where)
        logits, _ = prefill(cfg, params, init_cache(cfg, 2, 64, device=where),
                            {"tokens": prompts})
        out[str(where)] = logits.double().cpu()
    ref, got = out["cpu"], out[str(dev)]
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    require(err <= 1e-4 * scale, f"reduced prefill card vs cpu off by "
                                 f"{err:.3g} (scale {scale:.3g})")
    return {"max_abs_err": err, "scale": scale}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    require(set(phases) <= set(PHASES), f"unknown phase in {phases}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import runtime
    except ImportError as exc:
        print(f"chip_smoke: the port is not next to this script ({exc})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()
    lib = runtime.build_library()
    runtime.load_library()
    emit({"phase": "build", "card": card, "library": lib.name,
          "seconds": time.perf_counter() - t0})

    results = {}
    if "kernels" in phases:
        results["kernels"] = phase_kernels(card)
        emit(results["kernels"])
    if "job" in phases:
        results["job"] = phase_job(card)
        emit(results["job"])
    if "fleet_fused" in phases:
        specs = [(w, w // 2) for w in np.tile([64, 128, 192], 1366)[:4096]]
        results["fleet_fused"] = phase_fleet(card, "fleet_fused", specs, 8,
                                             64, fused=True)
        emit(results["fleet_fused"])
    if "fleet_gather" in phases:
        specs = [(1024, 512)] * 1024
        results["fleet_gather"] = phase_fleet(card, "fleet_gather", specs, 4,
                                              64, fused=False)
        emit(results["fleet_gather"])
    if "serve" in phases:
        results["serve"] = phase_serve(card)
        emit(results["serve"])

    launches = {"changepoint": 0, "windowvet": 0, "ssd": 0}
    for p in ("job", "fleet_fused", "fleet_gather", "serve"):
        for k, v in results.get(p, {}).get("launches", {}).items():
            launches[k] += v
    table = []
    if "kernels" in results:
        cpk = results["kernels"]["changepoint"][0]  # (1024, 1000): the job
        wvk = results["kernels"]["windowvet"][0]  # the ragged fleet tick
        sdk = results["kernels"]["ssd"][0]  # f32, the serve prefill shape
        table = [
            {"name": "changepoint", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/changepoint.cu",
             "replaces": "src/repro/kernels/changepoint/kernel.py:78",
             "launches": launches["changepoint"],
             "max_abs_err": max(c["max_abs_err"]
                                for c in results["kernels"]["changepoint"]),
             "ms": cpk["ms"], "plain_ms": cpk["plain_ms"],
             "bound_ms": cpk["bound_ms"], "bound_by": cpk["bound_by"],
             "library_ms": None},
            {"name": "windowvet", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/windowvet.cu",
             "replaces": "src/repro/kernels/windowvet/kernel.py:226",
             "launches": launches["windowvet"],
             "max_abs_err": max(c["max_abs_err_vet"]
                                for c in results["kernels"]["windowvet"]),
             "ms": wvk["ms"], "plain_ms": wvk["plain_ms"],
             "bound_ms": wvk["bound_ms"], "bound_by": wvk["bound_by"],
             "library_ms": None},
            {"name": "ssd", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/ssd.cu",
             "replaces": "src/repro/kernels/ssd/kernel.py:80",
             "launches": launches["ssd"],
             "max_abs_err": sdk["max_abs_err"],
             "ms": sdk["ms"], "plain_ms": sdk["plain_ms"],
             "bound_ms": sdk["bound_ms"], "bound_by": sdk["bound_by"],
             "library_ms": None},
        ]
    if set(phases) == set(PHASES):
        require(all(k["launches"] > 0 for k in table),
                f"a kernel of the main path was never launched: {launches}")
    print(card, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
