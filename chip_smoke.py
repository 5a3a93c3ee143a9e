#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Builds the CUDA kernel library from ``src/repro_torch/kernels/csrc`` (and,
alongside, the flash-attention, SSD, change-point and window-vet sources
once more with ``-Xptxas -v``: their kernels' registers and spills, none
allowed in the flash, SSD and window-vet kernels, and the tensor-core
instructions of the flash and SSD kernels from ``cuobjdump -sass`` (HGMMA
required in flash, HMMA in SSD) print on the ``compiled`` line) and drives
the port's main paths on one GPU, in fifteen phases:

1. ``kernels``  — each kernel against its plain PyTorch version on the card,
   at the shapes the main paths give it, with CUDA-event times, bounds and,
   for flash attention, ``scaled_dot_product_attention`` on the same inputs
   as a yardstick (timed here, never called by the port), flash attention
   also at the ``serve_moe`` and ``frontends`` phases' three shapes in f32
   (deepseek-moe-16b's 16 x 128 causal, internvl2-26b's 48/8 x 128 causal,
   hubert-xlarge's bidirectional 16 x 80, zamba2-7b's 32 x 112 causal),
   the flash kernel's wide entries (D above 128, ``wgmma``, V at its own
   width) at deepseek-v2-lite-16b's MLA prefill shape (16 heads, Q and K
   of 192, V of 128) and at D = 136 (GQA, windowed) and 256
   (bidirectional, MHA and GQA; V as wide as D, two V panels) in f32
   and bf16, SSD also at zamba2-7b's shape (112 heads of 64, state 64,
   2048 positions) in f32 and bf16; flash attention's
   and SSD's bounds are on the tensor cores (bf16 at 989 TFLOP/s, TF32 at
   495 TFLOP/s with three passes a product in f32), with SSD's bound on
   the f32 units beside it.  The change-point kernel runs five ragged batches (a
   monitor tick's 6-64-point rings, the job's and ``fleet_gather``'s
   curves, one 8192 and one 65,536-point row, the last through global
   scratch) and must give the plain twin's cuts on every row; the
   window-vet kernel runs four (the fleet tick's 64/128/192-record windows
   on its warp path, rows of 600-1000 and of 2000-4000 records on its
   block path, rows of 2-5 records), prints each case's path, and must give
   the plain version's cut on every row;
2. ``job``      — the paper's post-hoc measure on a 1024-task x 65,536-record
   Hadoop job (``VetEngine("cuda").vet_batch`` and ``vet_job``);
3. ``analysis`` — the paper's analysis layer over the ``job`` phase's rows
   and result (drawn here when that phase did not run): ``tail_report`` of
   every task on the card (16 held to the CPU to 1e-5), ``bucketize``,
   ``pearson`` of vet against PR, ``ks_2samp`` of the two halves' vets
   (Fig. 6, 8, 9, 14); ``VetController`` over 1024 workers fed
   ``skewed_stragglers`` (window 200, 3% stragglers, 8 ticks), each tick's
   launches held to the derived counts (one window-vet launch per
   ``decide()`` once windows complete, one change-point launch for the
   warm-up and per monitored tick), its decisions to the plain fused fleet
   and to ``shards=2`` (§5.5); ``OnlineVet(window=512)`` over task 0 in
   1024-record chunks (one change-point launch per engine dispatch, none
   of the window-vet kernel; the plain engine's rows under the contract
   below; ``history=8`` the same snapshots); ``run_contended_job`` at W =
   1, 2, 4 and twice the host's cores, vetted on the card (Table 2; wall
   times printed, not held);
4. ``fleet_fused``  — a 4096-stream ``VetMux`` on the fused window-vet path;
5. ``fleet_gather`` — a 1024-stream ``VetMux`` on the bucketed gather path.
   Both fleets must launch the change-point kernel exactly once per tick on
   which a ring is due, plus once per gather dispatch, and run once more
   under a tracer for the host ms of each mux span;
6. ``serve``    — ``repro_torch.launch.serve.serve`` on full-width
   mamba2-130m (batch 4, 512-token prompts, 331 generated tokens): the SSD
   kernel in every layer's prefill, the decode loop and its live vet
   dashboard.  Prefill logits through the kernel are held against the plain
   SSD path on the same card and weights (|kernel - plain| <= 1e-3 of the
   largest logit), the greedy tokens of the first decode steps must be
   equal, and the reduced config's prefill on the card is held against the
   same weights on the CPU.  The prefill is timed once more over 20 calls
   (CUDA events) and traced once for device time by kernel;
7. ``serve_attn`` — the same entry point on full-width h2o-danube-3-4b
   (3.84 B parameters, f32, sliding window 4096; batch 2, 7,168-token
   prompts, 331 generated tokens): the flash-attention kernel in every
   layer's prefill, the in-place KV cache, decode and the dashboard.  The
   weights are drawn on the card from seed 0 (other numbers than the host
   draw that ``serve`` makes by default).  Prefill logits and the filled
   KV caches through the kernel are held against the plain attention path
   on the same weights (1e-3 of the largest value), each path filling its
   own cache; the greedy tokens of the first decode steps must be equal; the
   reduced config's prefill on the card is held against the CPU.  One
   prefill and a few decode steps are traced with ``torch.profiler`` for
   device time by kernel;
8. ``serve_moe`` — the same entry point on deepseek-moe-16b at its
   published widths and full depth (28 layers: a dense first layer of
   ``d_ff`` 10944, then 27 MoE layers of 64 routed experts of 1408 and 2
   shared, top 6; d_model 2048, 16 heads of 128, vocab 102400;
   16,166,012,928 f32 parameters drawn on the card; batch 2, 2048-token
   prompts, 331 generated tokens): one flash launch per layer's prefill,
   the decode loop at capacity 1 (every expert reads its weights each
   step) and the dashboard.  The kernel path's prefill, its routing
   recorded (``models.layers.recording``), is held against the plain path
   on the same weights, each with its own cache, under the routing
   contract: where every layer routes alike, logits and KV caches within
   ``LOGIT_TOL``; where a token's experts or an expert's tokens differ,
   the plain path forced to the kernel path's routing must put every such
   flip at a near-tie (1e-4 relative under its own values,
   ``routing_flips``) and the logits and caches are held against it.  A
   second kernel-path prefill must equal the first bit for bit (the
   combine sums in a fixed order); greedy tokens equal for 8 decode steps;
   the reduced config against the CPU.  Prints prefill ms, decode ms a
   step beside the weight-read bound, tokens/s, peak bytes, the share of
   routed slots the capacity dropped, and a traced prefill and 4 decode
   steps;
9. ``serve_hybrid`` — the same entry point on zamba2-7b at its published
   widths and full depth (81 Mamba2 layers, d_model 3584, 112 SSD heads
   of 64, state 64; two shared transformer blocks of 32 MHA heads of 112
   and ``d_ff`` 14336 applied before every 6th layer: 14 applications;
   6.84 B f32 parameters drawn on the card; batch 2, 2048-token prompts,
   331 generated tokens): 81 SSD and 14 flash launches a prefill.  A
   fresh kernel-path prefill against the plain path (logits within
   ``LOGIT_TOL``, the shared-attention caches within ``HYBRID_CACHE_TOL``;
   the Mamba states left at zero, as the reference leaves them), every
   Mamba and shared-attention block's kernel call against the plain block
   on the plain path's own input (``LAYER_TOL``), the residual stream's
   drift from the plain path layer by layer with both kernels, each
   kernel alone and the plain path at another f32 order (reported), a
   second kernel prefill bit for bit, 8 greedy decode steps; then the
   same prefill and decode
   with ``kv_cache_dtype="int8"`` on the same weights, kernel and plain
   paths: logits equal to the f32 cache's, each dequantised cache within
   one quantum of its f32 cache, the payloads' differences counted and
   each explained by the f32 caches' own; prefill and decode ms beside the
   weight-read bound, peak bytes, a traced prefill and decode;
10. ``serve_mla`` — deepseek-v2-lite-16b at its published widths and
   depth (27 layers of MLA: 16 heads, ``kv_lora_rank`` 512, Q and K of
   128 + 64, V of 128; a dense first layer of ``d_ff`` 10944, then 26 MoE
   layers of 64 routed experts of 1408 and 2 shared, top 6; 15.50 B f32
   parameters drawn on the card; batch 2, 2048-token prompts, 171 tokens:
   the vet without window snapshots, to keep the smoke's time):
   27 launches of the flash kernel's wide entry a prefill and no narrow
   one, the ``serve_moe`` routing contract, logits and the ``ckv``/
   ``krope`` caches within ``LOGIT_TOL``, a bitwise repeat, 8 greedy
   decode steps absorbed into the latent space, the same numbers as
   ``serve_moe``;
11. ``frontends`` — internvl2-26b at full width on 4 of its 48 layers
   (d_model 6144, 48/8 heads of 128, ``d_ff`` 16384, untied head, vocab
   92553; 2.70 B f32 parameters drawn on the card): ``prefill`` of
   batch 2 x (1024 patch embeddings + 1024 text tokens) and 8
   ``decode_step``s from position 2048, the kernel path against the plain
   path (logits, KV caches, greedy tokens); then hubert-xlarge at full
   width and depth (48 layers, d_model 1280, 16 heads of 80,
   bidirectional; 1.26 B f32 parameters drawn on the card) trained by
   ``launch.train`` 4 steps of batch 2 x 1024 frame embeddings, the
   bidirectional flash kernel twice per layer and step, with the gradient
   check (``embed``, which the audio model never reads, exactly zero);
12. ``transport`` — the ``fleet_fused`` fleet as
   ``TransportVetMux(2, engine=VetEngine("cuda", buckets=64))``: two
   spawned shard workers, each with its own CUDA context, launch the
   window-vet and change-point kernels (the driver's own counters must
   stay 0).  Every tick's schedule, counters, flags and newest rows, and
   every stream's retained rows, must equal an in-process
   ``ShardedVetMux(2)`` on the same card bit for bit; the rows are held to
   the plain sharded fleet under the contract below.  A traced pass must
   show, on each worker's ``worker.tick`` spans (the change of its
   wrappers' ``LAUNCHES`` over the tick), one fused ``cuda`` dispatch and
   one window-vet launch per worker per tick and one change-point launch
   per worker per monitored tick; a pass with shard 0's worker killed in
   the middle of tick 5 must give the same rows with one respawn.  Then
   ``serve`` (the ``serve`` phase's model and sizes, reusing that phase's
   plain run) with ``transport=True, tune=True, shards=2``, traced, must
   give the plain serve's tokens and window count, no respawn, windows
   equal bit for bit to the same decode units vetted in process on the
   card, the workers' window-vet and change-point launches equal to that
   replay's (one window-vet launch per fused dispatch), and a tuner report
   naming a ``tick_budget``.  Prints tick ms (transport, in-process,
   plain), round trips per shard, host ms by span and the workers' device
   bytes (``torch.cuda.mem_get_info`` from the driver);
13. ``train`` — ``repro_torch.launch.train.train`` on full mamba2-130m
   (128,958,336 f32 parameters; batch 8, seq_len 128, ``remat="full"``, 96
   steps, a checkpoint every 32 into a temporary directory): once
   uninterrupted, once cut at step 50 (``SimulatedFailure``) and resumed
   from step 32, the resumed losses within 1e-4 (relative) of the
   uninterrupted run's; the vet report over 19 unit records.  Every run's
   launches are held to the derived counts: the SSD kernel twice per layer
   and step (the forward and the backward's recompute; the backward's
   gradients are the plain version's), the change-point kernel as the
   report's curve asks.  One step's loss and gradients through the kernels
   against ``plain=True`` on the same weights and batch (loss 1e-5
   relative; every parameter's gradient present, not all zero, within
   ``LOGIT_TOL`` of its largest plain gradient); ten steady steps timed
   and one traced (device ms by kernel, the SSD kernel apart from the plain
   backward's range).  Then h2o-danube-3-4b at full width with 4 of its 24
   layers (the one cut; weights drawn on the card): batch 2, seq_len 2048,
   4 steps, the flash kernel twice per layer and step, the same gradient
   check; deepseek-moe-16b at full width on 2 of its 28 layers (the dense
   first layer and one MoE layer; 881,600,512 parameters drawn on the
   card) the same way, its aux loss finite and above 0 and the router, the
   stacked experts and the shared expert all reached by the gradient
   check; zamba2-7b at full width on 7 of its 81 layers (both shared
   blocks applied, before layers 0 and 6), SSD twice per layer and flash
   twice per application and step, each gradient leaf held to the plain
   path within max(1e-3, the plain path's card-to-CPU spread) on a 1 x
   1024 batch; deepseek-v2-lite-16b at full width on 2 of its 27 layers
   through the wide entry and its autograd route, as the MoE part; the
   reduced mamba2-130m, h2o-danube-3-4b, deepseek-moe-16b, internvl2-26b,
   hubert-xlarge, zamba2-7b and deepseek-v2-lite-16b trained 4 steps on the
   card and on the CPU from the same weights (losses within 1e-4); and
   ``sched.autotune.tune`` on full mamba2-130m (batch 8, seq_len 64,
   ``n_micro`` x ``q_chunk`` in (1, 2) x (32, 64), 12 steps a candidate):
   four candidates, each with its vet;
14. ``sharded`` — the sharding layer on a one-rank NCCL group (a
   ``FileStore`` in a temporary directory) and a (1, 1) ("data", "model")
   mesh of the card, destroyed before the phase returns: deepseek-moe-16b
   at full width on 2 of its 28 layers (as ``train`` cuts it), batch 2 x
   2048, through ``jit_prefill_step``, 8 ``jit_decode_step``s and 2
   ``jit_train_step``s, each against ``make_*_step`` without a mesh on the
   same weights: flash launches equal, the same routing, logits and
   caches within ``LOGIT_TOL``, losses within 1e-5 and every parameter and
   moment within ``LOGIT_TOL`` of its largest, each reported as a share of
   the tolerance and whether bit for bit; full mamba2-130m in the
   split-projection layout prefilled 4 x 512 on the mesh against the fused
   layout on the mapped weights (SSD launches equal, logits within
   ``LOGIT_TOL``); ``reshard_state`` mesh -> none -> mesh bit for bit.
   Printed, not held: ms with and without the mesh (DTensor's host cost;
   prefills timed in turns), each training run's peak bytes above what it
   began with, and the collectives recorded (on one rank, only the
   explicit all-reduces of the sequence-sharded decode);
15. ``dryrun`` — ``repro_torch.launch.dryrun`` checked against the card:
   the ``sharded`` phase's three steps (2-layer deepseek-moe-16b's train
   step and prefill, the split-projection mamba2-130m's prefill, f32) are
   traced on fake tensors on a fake (1, 1) CUDA mesh of one rank, and
   their predicted peak bytes and kernel calls must be within 10% of
   ``max_memory_allocated`` and equal to the launch counters of the same
   steps run for real on a one-rank NCCL mesh (each case's inputs drawn
   and placed before the peak is reset; the fake group is destroyed
   before the NCCL group is made).  Then ``run_cell`` sizes production
   cells on the card's host (``DRYRUN_CELLS``: mamba2-130m train_4k and
   qwen3-14b decode_32k on one pod, qwen3-14b decode_32k on two), each
   ``ok`` or ``skipped``; then ``examples/port_serve_decode.py`` and
   ``port_train_100m.py`` run once at small arguments, their launches
   the phase's.  The card's ``total_memory`` is printed once.

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
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
# TF32 on the tensor cores (dense); an f32-accurate product there takes
# three TF32 passes, the least an f32 attention can take there
TF32_OPS_PER_S = 495e12
TF32X3_OPS_PER_S = TF32_OPS_PER_S / 3
RTOL = 1e-5  # vet/ei/oc/pr where the cut agrees
GAP = 1e-4  # relative SSE gap allowed between two near-tie cuts
PHASES = ("kernels", "job", "analysis", "fleet_fused", "fleet_gather",
          "serve", "serve_attn", "serve_moe", "serve_hybrid", "serve_mla",
          "frontends", "transport", "train", "sharded", "dryrun")
SSD_RTOL = {"float32": 2e-4, "bfloat16": 5e-2}  # tests/test_kernels.py TestSSD
# tests/test_kernels.py TestFlashAttention
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# serve: kernel vs plain prefill logits and KV caches, of the largest value
LOGIT_TOL = 1e-3
# serve_hybrid: the fresh prefills' shared-attention caches, kernel path
# against plain, of the largest value.  zamba2-7b's 81 Mamba layers
# amplify the flash kernel's 3xTF32 products about linearly with depth:
# the caches reach 2.7e-3 with both kernels and with the flash kernel
# alone, 4.7e-3 on the plain path with only its attention products in
# 3xTF32 (``attention_products_3xtf32``), 4.3e-4 with the SSD kernel alone
# (NVIDIA H100 80GB HBM3, 700.00 W; ``drift_probe`` reports these every
# run).
# Every layer's kernel call is held to LAYER_TOL from the plain path's own
# input (``layerwise_check``), so the depth, not a call, sets this bound.
# The logits stay held to LOGIT_TOL; the same drift brings them to 85% of
# it (8.5e-4) on seed 0.
HYBRID_CACHE_TOL = 5e-3
LAYER_TOL = 1e-4
# flash-attention kernels (csrc/flash_attention.cu: the bf16 template at
# the panels and key tile that D sets, the f32 kernel of D up to 128 and
# the f32 template above it) -> a substring of their mangled names: those
# of D up to 128 (the C entries flash_attention_bf16 and _f32), then the
# wide entries' (D from 136 to 256)
FLASH_KERNELS = {"flash_wgmma_bf16_2_128": "flash_wgmma_bf16ILi2ELi128E",
                 "flash_wgmma_tf32": "flash_wgmma_tf32"}
FLASH_WIDE_KERNELS = {
    "flash_wgmma_wide_tf32_6_32": "flash_wgmma_wide_tf32ILi6ELi32E",
    "flash_wgmma_wide_tf32_8_16": "flash_wgmma_wide_tf32ILi8ELi16E",
    "flash_wgmma_bf16_3_128": "flash_wgmma_bf16ILi3ELi128E",
    "flash_wgmma_bf16_4_64": "flash_wgmma_bf16ILi4ELi64E"}
# SSD kernel instantiations (csrc/ssd.cu: the prologue and the scan) -> a
# substring of their mangled names
SSD_KERNELS = {"ssd_gram_f32": "ssd_gram_kernelIf",
               "ssd_gram_bf16": "ssd_gram_kernelI13__nv_bfloat16",
               "ssd_mma_f32": "ssd_mma_kernelIf",
               "ssd_mma_bf16": "ssd_mma_kernelI13__nv_bfloat16"}
# window-vet kernels (csrc/windowvet.cu: the warp path per values-per-lane
# instantiation, the block path) -> a substring of their mangled names
WINDOWVET_KERNELS = {**{f"windowvet_warp_e{e}": f"windowvet_warp_kernelILi{e}EE"
                        for e in (1, 2, 4, 8, 16)},
                     "windowvet_block": "windowvet_block_kernel"}
# kernel functions whose registers and spills the ``compiled`` line reports
# -> (their source in csrc/, a substring of their mangled names)
PTXAS_KERNELS = {**{k: ("flash_attention.cu", v)
                    for k, v in {**FLASH_KERNELS,
                                 **FLASH_WIDE_KERNELS}.items()},
                 **{k: ("ssd.cu", v) for k, v in SSD_KERNELS.items()},
                 "changepoint_kernel": ("changepoint.cu", "changepoint_kernel"),
                 **{k: ("windowvet.cu", v)
                    for k, v in WINDOWVET_KERNELS.items()}}
# the kernels held to no spill
NO_SPILL = (*FLASH_KERNELS, *FLASH_WIDE_KERNELS, *SSD_KERNELS,
            *WINDOWVET_KERNELS)


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


def bound_ms(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------ the compiled
def ptxas_start():
    """Compile the sources of ``PTXAS_KERNELS`` once more with ``-Xptxas
    -v``, in parallel with the library build, for their kernels' registers
    and spills."""
    from repro_torch.kernels import runtime
    runtime.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    checks = []
    for src in sorted({src for src, _ in PTXAS_KERNELS.values()}):
        obj = runtime.BUILD_DIR / f"ptxas-check-{os.getpid()}-{src}.o"
        checks.append((obj, subprocess.Popen(
            [runtime._nvcc(), *runtime.ARCH_FLAGS, *runtime.NVCC_FLAGS,
             "-Xptxas", "-v", "-c", str(runtime.CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    return checks


def ptxas_report(checks) -> dict:
    """Registers, stack and spills of each checked kernel from ptxas; fails
    on a spill in a flash, SSD or window-vet kernel.  Keeps ptxas's
    warnings, such as a wgmma it had to serialise (which costs time)."""
    out, notes, err = {}, [], ""
    for obj, proc in checks:
        _, err = proc.communicate()
        obj.unlink(missing_ok=True)
        require(proc.returncode == 0, f"ptxas check failed:\n{err[-3000:]}")
        name = None
        for line in err.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name = next((k for k, (_, pat) in PTXAS_KERNELS.items()
                             if pat in m.group(1)), None)
                continue
            if name is None:
                continue
            row = out.setdefault(name, {})
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                row.update(stack_bytes=int(m[1]), spill_stores=int(m[2]),
                           spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                row["registers"] = int(m[1])
        notes += [ln.strip()[:200] for ln in err.splitlines()
                  if "arning" in ln or "erializ" in ln]
    require(set(out) == set(PTXAS_KERNELS) and all(
        "registers" in r and "spill_stores" in r for r in out.values()),
        f"ptxas check: no report for every kernel in\n{err[-3000:]}")
    require(all(out[k]["spill_stores"] == 0 and out[k]["spill_loads"] == 0
                for k in NO_SPILL), f"flash, SSD or window-vet kernels spill: "
                                   f"{out}")
    out["notes"] = notes[:8]
    return out


def sass_counts(lib_path) -> dict:
    """Tensor-core instructions of each flash and SSD kernel in the built
    library (``cuobjdump -sass``): HGMMA is wgmma, HMMA is mma.sync.  Every
    flash kernel, the wide ones too, must hold HGMMA, both SSD kernels
    HMMA."""
    from repro_torch.kernels import runtime
    tool = (shutil.which("cuobjdump")
            or str(Path(runtime._nvcc()).parent / "cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = next((k for k, pat in {**FLASH_KERNELS,
                                          **FLASH_WIDE_KERNELS,
                                          **SSD_KERNELS}.items()
                         if pat in m.group(1)), None)
            if name:
                out[name] = {"HGMMA": 0, "HMMA": 0}
            continue
        if name:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\b", line):
                    out[name][op] += 1
    require(all(out.get(k, {}).get("HGMMA", 0) > 0
                for k in (*FLASH_KERNELS, *FLASH_WIDE_KERNELS)),
            f"a flash kernel has no HGMMA: {out}")
    require(all(out.get(k, {}).get("HMMA", 0) > 0 for k in SSD_KERNELS),
            f"an SSD kernel has no HMMA: {out}")
    return out


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
           "windowvet": [], "ssd": [], "flash_attention": []}
    dev = torch.device(device)
    lib = runtime.load_library()

    def stream_ptr():
        return torch.cuda.current_stream().cuda_stream

    # ---- changepoint: sorted log curves at the main path's shapes -------
    # lengths of the rows, packed end to end into one arena: the monitor's
    # rings on a fleet tick, the job's bucketed curves, fleet_gather's
    # bucketed windows, one long curve, one unbucketed 65,536-record
    # profile (its scans take the kernel's global-scratch route)
    cp_cases = {
        "ragged_6_64": np.random.default_rng(5).integers(6, 65, 4096),
        "job_1024x1000": np.full(1024, 1000),
        "gather_4096x64": np.full(4096, 64),
        "one_8192": np.array([8192]),
        "one_65536": np.array([65536]),
    }
    for name, lengths in cp_cases.items():
        groups = [np.log(np.sort(sim_rows(int((lengths == n).sum()), int(n),
                                          seed0=100 + int(n)), axis=1))
                  for n in np.unique(lengths)]
        (values, starts, lens), span = cp.pack_rows(groups, dev)
        rows, lmax = int(lens.numel()), span[1]
        t_k, sse_k = cp.changepoint_ragged(values, starts, lens,
                                           landscape=True, span=span)
        t_p, sse_p = cp.changepoint_ragged_plain(values, starts, lens,
                                                 landscape=True)
        torch.cuda.synchronize()
        sse_k, sse_p = sse_k.cpu().numpy(), sse_p.cpu().numpy()
        flips = int((t_k != t_p).sum())
        require(flips == 0, f"changepoint {name}: {flips} cuts differ from "
                            f"the plain twin")
        fin = np.isfinite(sse_p)
        require(np.array_equal(fin, np.isfinite(sse_k)),
                f"changepoint {name}: +inf mask differs")
        rel = np.abs(sse_k[fin] - sse_p[fin]) / np.maximum(
            np.abs(sse_p[fin]), 1e-30)
        # the same f32 operations in the same order: the landscape is exact
        require(np.array_equal(sse_k, sse_p),
                f"changepoint {name}: landscape off by {rel.max():.3g} "
                f"(relative)")
        floats = cp.scan_floats(lmax)
        scratch, blocks = None, 0
        if floats > cp.SHARED_FLOATS:
            blocks = min(rows, cp._SCRATCH_BLOCKS_PER_SM * torch.cuda
                         .get_device_properties(dev).multi_processor_count)
            scratch = torch.empty(blocks * floats, device=dev)
        sse_o = torch.empty_like(values)
        t_o = torch.empty(rows, dtype=torch.int32, device=dev)

        def raw(sse_ptr):
            return lib.changepoint_scan(
                values.data_ptr(), starts.data_ptr(), lens.data_ptr(), rows,
                0, lmax, 3, sse_ptr, t_o.data_ptr(),
                None if scratch is None else scratch.data_ptr(), blocks,
                floats, stream_ptr())

        ms = cuda_ms(lambda: raw(sse_o.data_ptr()), iters=200)
        t_only_ms = cuda_ms(lambda: raw(None), iters=200)
        call_ms = cuda_ms(lambda: cp.changepoint_ragged(
            values, starts, lens, landscape=True, span=span))
        plain_ms = cuda_ms(lambda: cp.changepoint_ragged_plain(
            values, starts, lens, landscape=True), iters=5)
        n_el = int(values.numel())
        # dense cases: the PyTorch ops that built the old kernel's operands
        # (centring and XLA-order prefix sums, now inside the kernel)
        prefix_ms = cuda_ms(lambda: cp.prefix_inputs(
            values.view(rows, lmax))) if n_el == rows * lmax else None
        # values and starts/lengths in, landscape and t out; ~45 f32
        # operations per element (the closed forms depend on k and n only)
        bms, by = bound_ms(4 * n_el + 8 * rows + 4 * n_el + 4 * rows,
                           45.0 * n_el)
        out["changepoint"].append({
            "case": name, "rows": rows, "lmax": lmax, "elements": n_el,
            "route": "shared" if scratch is None else "global_scratch",
            "cut_flips": flips,
            "max_abs_err": float(np.abs(sse_k[fin] - sse_p[fin]).max()),
            "max_rel_err": float(rel.max()), "ms": ms,
            "t_only_ms": t_only_ms, "call_ms": call_ms,
            "prefix_ms": prefix_ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by})
        del values, starts, lens, sse_o, t_o, scratch

    # ---- windowvet: the fleet tick (warp path), rows of 600-1000 and of
    # 2000-4000 records (block path), degenerate rows ----------------------
    rng = np.random.default_rng(7)
    cases = {
        "ragged_64_128_192": np.tile([64, 128, 192], 8192 // 3 + 1)[:8192],
        "long_600_1000": rng.integers(600, 1001, 2048),
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
        # the same f32 operations in the same order: the cuts are the plain
        # version's
        require(summary["cut_flips"] == 0,
                f"windowvet {name}: {summary['cut_flips']} cuts differ from "
                f"the plain version")
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
            "case": name, "path": wv.kernel_path(lmax), "rows": int(rows),
            "lmax": lmax, **summary,
            "lanes_bitwise": bool(np.array_equal(res_k, res_p)),
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by})

    out["ssd"] = ssd_cases(dev, lib, stream_ptr) + ssd_cases(
        dev, lib, stream_ptr, SSD_ZAMBA, (("float32", 64), ("bfloat16", 64)),
        "zamba")
    out["flash_attention"] = flash_cases(dev, lib, stream_ptr)
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


def ssd_flops(b, t, h, p, n, chunk) -> tuple:
    """f32 operations the chunked SSD needs, as (C B^T, the rest): C B^T
    once per (batch, chunk) (shared by the heads); the intra-chunk scores X
    over the lower triangle, C h^T and the state update per (batch, head,
    chunk)."""
    nc = t // chunk
    cb = 2.0 * chunk * chunk * n * b * nc
    per_head = chunk * (chunk + 1) * p + 4.0 * chunk * p * n
    return cb, per_head * b * h * nc


# zamba2-7b's scan at serve_hybrid's prompt: batch 2, 2048 positions, 112
# heads of 64, state 64, chunk 64
SSD_ZAMBA = (2, 2048, 112, 64, 64)


def ssd_cases(dev, lib, stream_ptr, shape=(4, 512, 24, 64, 128),
              variants=(("float32", 64), ("bfloat16", 64), ("float32", 32)),
              case: str = "serve") -> list:
    """SSD kernel against its plain version at the serve shape (B=4, T=512,
    H=24, P=64, N=128) or ``shape``: by default f32 and bf16 at chunk 64,
    and chunk 32 against chunk 64 in f32 (``variants``: (type, chunk));
    elementwise |a - b| <= rtol + rtol |b|.  The bound is
    on the tensor cores in TF32 (495 TFLOP/s): three passes a product in
    f32; in bf16 one for C B^T (both operands exact in TF32) and two for
    the rest.  ``f32_unit_bound_ms`` keeps the bound on the f32 units (67
    TFLOP/s), the basis before the kernel used the tensor cores.  ``ms``
    times the C entry: the prologue and the scan.  The wrapper's copy of
    the scan's shared memory must equal the library's
    (``ssd_scan_smem_bytes``)."""
    import torch
    from repro_torch.kernels.ssd import ops as sd
    from repro_torch.kernels.ssd.ref import ssd_scan_plain

    rows = []
    ref64 = None
    for name, chunk in variants:
        dtype = getattr(torch, name)
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
        cb, rest = ssd_flops(*shape, chunk)
        passes = (1, 2) if dtype == torch.bfloat16 else (3, 3)
        bms, by = bound_ms(nbytes, passes[0] * cb + passes[1] * rest,
                           TF32_OPS_PER_S)
        smem = sd.smem_bytes(p_, n_, chunk, dtype)
        require(lib.ssd_scan_smem_bytes(p_, n_, chunk, el) == smem,
                f"ssd: ops.smem_bytes {smem} is not the library's "
                f"{lib.ssd_scan_smem_bytes(p_, n_, chunk, el)}")
        rows.append({"case": case, "dtype": name, "chunk": chunk,
                     "against": against,
                     "shape": list(shape), "tol": tol,
                     "max_abs_err": float(err.max()),
                     "max_err_over_tol": worst, "ms": ms, "call_ms": call_ms,
                     "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                     "bound_basis": f"TF32 tensor cores, {passes[0]}/"
                                    f"{passes[1]} passes (C B^T / rest)",
                     "f32_unit_bound_ms": bound_ms(nbytes, cb + rest)[0],
                     "gflop": (cb + rest) / 1e9,
                     "smem_bytes": smem,
                     "blocks": h_ * -(-p_ // (16 * sd._UNITS)) * b_})
    return rows


# h2o-danube-3-4b's attention at the serve_attn phase's prompt: batch 2,
# 7,168 positions, 32 query heads over 8 KV heads of 120, window 4096.
FLASH_SERVE = (2, 7168, 32, 8, 120)
# deepseek-moe-16b's at serve_moe's prompt (16 heads of 128, MHA),
# internvl2-26b's at frontends' (48 query over 8 KV heads of 128), both
# causal over 2048 positions; hubert-xlarge's (16 heads of 80), 1024
# frames, bidirectional
FLASH_MOE = (2, 2048, 16, 16, 128)
FLASH_VLM = (2, 2048, 48, 8, 128)
FLASH_HUBERT = (2, 1024, 16, 16, 80)
# zamba2-7b's shared attention at serve_hybrid's prompt (32 MHA heads of
# 112, causal, 2048 positions), and deepseek-v2-lite-16b's MLA prefill at
# serve_mla's: 16 heads, Q and K of 128 + 64 = 192, V of 128 (the wide
# entry takes it at that width), causal, 2048 positions
FLASH_ZAMBA = (2, 2048, 32, 32, 112)
FLASH_MLA = (2, 2048, 16, 16, 192)
MLA_V_DIM = 128


def flash_cases(dev, lib, stream_ptr) -> list:
    """Flash attention against its plain version at the serve_attn shape
    (f32 and bf16, causal with window 4096), causal (f32 and bf16) and
    bidirectional at S = 2048, a ragged S = 200, the serve_moe, frontends
    and train phases' three shapes and serve_hybrid's (D = 112) in f32; then
    the wide entries (D above 128), V given at its own width: serve_mla's
    MLA shape with V of 128 (f32 and bf16), and D = 136 (GQA 16/4, window
    300) and D = 256 (bidirectional, MHA and GQA 8/2) with V as wide as D
    (two V panels) in both types.  Elementwise |a - b| <= tol + tol |b|.
    ``library_ms`` is one ``scaled_dot_product_attention`` call on the same
    inputs and mask (KV heads repeated to the query heads beforehand, as
    its fused backends take them).  The bound counts the live pairs'
    operations (2 (D + Dv) a pair) at the card's peak for the type: bf16 on
    the tensor cores (989 TFLOP/s), f32 as three TF32 passes there
    (``TF32X3_OPS_PER_S``).  ``f32_unit_bound_ms`` gives the f32 rows'
    bound on the f32 CUDA cores (67 TFLOP/s) beside it.  Bytes: Q, K and V
    read and O written once at their own widths."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention_plain, live_pairs
    from repro_torch.kernels.flash_attention import ops as fa

    f32, bf16 = torch.float32, torch.bfloat16
    cases = (("serve_f32", FLASH_SERVE, True, 4096, f32),
             ("serve_bf16", FLASH_SERVE, True, 4096, bf16),
             ("causal_2048", (2, 2048, 32, 8, 120), True, 0, f32),
             ("causal_2048_bf16", (2, 2048, 32, 8, 120), True, 0, bf16),
             ("bidirectional_2048", (2, 2048, 32, 8, 120), False, 0, f32),
             ("ragged_200", (2, 200, 32, 8, 120), True, 0, f32),
             # the serve_moe, frontends, train and serve_hybrid phases'
             # prefill shapes
             ("moe_causal_2048", FLASH_MOE, True, 0, f32),
             ("vlm_causal_2048", FLASH_VLM, True, 0, f32),
             ("hubert_bidirectional_1024", FLASH_HUBERT, False, 0, f32),
             ("zamba_causal_2048", FLASH_ZAMBA, True, 0, f32),
             # the wide entries: serve_mla's shape with V at 128, and
             # their edges D = 136 and 256
             ("mla_wide_causal_2048", FLASH_MLA, True, 0, f32, MLA_V_DIM),
             ("mla_wide_causal_2048_bf16", FLASH_MLA, True, 0, bf16,
              MLA_V_DIM),
             ("wide_d136_gqa_window_1024", (2, 1024, 16, 4, 136), True, 300,
              f32),
             ("wide_d136_gqa_window_1024_bf16", (2, 1024, 16, 4, 136), True,
              300, bf16),
             ("wide_d256_bidirectional_1024", (2, 1024, 8, 8, 256), False, 0,
              f32),
             ("wide_d256_gqa_bidirectional_1024_bf16", (2, 1024, 8, 2, 256),
              False, 0, bf16))
    rows = []
    for name, shape, causal, window, dtype, *dv in cases:
        b, s, h, kh, d = shape
        dv = dv[0] if dv else d
        tname = str(dtype).split(".")[-1]
        tol = FLASH_TOL[tname]
        gen = torch.Generator(device=dev).manual_seed(len(rows))
        q, k, v = (torch.randn(sh, generator=gen, device=dev).to(dtype)
                   for sh in ((b, s, h, d), (b, s, kh, d), (b, s, kh, dv)))
        scale = 1.0 / d ** 0.5
        wide = fa.WIDE_LAUNCHES
        o_k = fa.flash_attention(q, k, v, causal=causal, window=window,
                                 scale=scale)
        require(fa.WIDE_LAUNCHES - wide == int(d > 128),
                f"flash {name}: D = {d} ran the wrong entry")
        o_p = attention_plain(q, k, v, causal=causal, window=window,
                              scale=scale)
        torch.cuda.synchronize()
        require(o_k.shape == o_p.shape == (b, s, h, dv),
                f"flash {name}: output shape {tuple(o_k.shape)}")
        a, ref = o_k.float(), o_p.float()
        require(bool(torch.isfinite(a).all()), f"flash {name}: non-finite")
        err = (a - ref).abs()
        worst = float((err / (tol + tol * ref.abs())).max())
        require(worst <= 1.0, f"flash {name}: {worst:.3g} x the tolerance "
                              f"{tol}")
        o_o = torch.empty_like(o_k)
        entry = getattr(lib, (fa._WIDE_ENTRY if d > 128 else fa._ENTRY)[dtype])
        dims = [b, s, h, kh, d] + ([dv] if d > 128 else [])
        args = ([t.data_ptr() for t in (q, k, v, o_o)]
                + dims + [int(causal), window, scale, stream_ptr()])
        iters = 10 if s > 4096 else 50
        ms = cuda_ms(lambda: entry(*args), iters=iters)
        call_ms = cuda_ms(lambda: fa.flash_attention(
            q, k, v, causal=causal, window=window, scale=scale), iters=iters)
        plain_ms = cuda_ms(lambda: attention_plain(
            q, k, v, causal=causal, window=window, scale=scale),
            iters=3, warmup=1)
        pairs = live_pairs(s, causal=causal, window=window)
        ops = 2.0 * (d + dv) * pairs * b * h
        nbytes = q.element_size() * (b * s * h * (d + dv)
                                     + b * s * kh * (d + dv))
        if dtype == torch.float32:
            bms, by = bound_ms(nbytes, ops, TF32X3_OPS_PER_S)
            basis = "3xTF32 tensor cores, 495/3 TFLOP/s"
        else:
            bms, by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
            basis = "bf16 tensor cores, 989 TFLOP/s"
        unit_ms = (bound_ms(nbytes, ops, F32_OPS_PER_S)[0]
                   if dtype == torch.float32 else None)
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(h // kh, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(h // kh, dim=2).transpose(1, 2)
        mask = None
        if window:
            pos = torch.arange(s, device=dev)
            mask = pos[:, None] - pos[None, :] < window
            if causal:
                mask &= pos[:, None] >= pos[None, :]
        lib_ms, lib_err = None, None
        try:
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None, scale=scale), iters=iters)
        except RuntimeError as exc:  # a yardstick, never the port's path
            lib_err = str(exc).splitlines()[0][:200]
        del qt, kt, vt, mask, o_o
        rows.append({"case": name, "dtype": tname, "shape": list(shape),
                     "v_dim": dv, "entry": "wide" if d > 128 else "wgmma",
                     "causal": causal, "window": window, "tol": tol,
                     "max_abs_err": float(err.max()),
                     "max_err_over_tol": worst, "live_pairs_per_head": pairs,
                     "gflop": ops / 1e9, "ms": ms, "call_ms": call_ms,
                     "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                     "bound_basis": basis, "f32_unit_bound_ms": unit_ms,
                     "library_ms": lib_ms, "library_error": lib_err,
                     **({} if d > 128 else {
                         "smem_bytes": fa.smem_bytes(dtype),
                         "blocks": -(-s // fa.block_rows(dtype)) * h * b})})
        del q, k, v, o_k, o_p, a, ref, err
        torch.cuda.empty_cache()
    return rows


def _counters():
    from repro_torch.kernels.changepoint import ops as cp
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as sd
    from repro_torch.kernels.windowvet import ops as wv
    return {"changepoint": cp, "windowvet": wv, "ssd": sd,
            "flash_attention": fa}


def zero_counts():
    for mod in _counters().values():
        mod.LAUNCHES = 0
    _counters()["flash_attention"].WIDE_LAUNCHES = 0


def wide_count() -> int:
    """The flash wrapper's wide-entry launches (also in its ``LAUNCHES``)
    since ``zero_counts``."""
    return _counters()["flash_attention"].WIDE_LAUNCHES


def read_counts() -> dict:
    return {name: mod.LAUNCHES for name, mod in _counters().items()}


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
            "vs_numpy_16": vs_numpy, "result": (m, res)}


def run_fleet(engine, specs, chunks, ticks, trace: bool = False):
    """Feed + tick a mux; returns (mux, per-tick records, tick seconds).
    ``trace``: under a tracer, each record's ``span_ms`` sums the tick's
    spans by name (host wall ms; ``feed`` is the feeding before the tick;
    the streams add three spans each per tick, so tracing slows the tick)."""
    import torch
    from repro_torch.fleet import VetMux
    from repro_torch.obs import Tracer
    tracer = Tracer() if trace else None
    mux = VetMux(engine, tracer=tracer)
    for sid, (w, s) in enumerate(specs):
        mux.register(sid, window=w, stride=s, capacity=4 * w)
    per_tick, secs = [], []
    for k in range(ticks):
        t0 = time.perf_counter()
        for sid in range(len(specs)):
            mux.feed(sid, chunks[sid][k])
        feed_s = time.perf_counter() - t0
        tick = mux.tick()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        span_ms = {"feed": feed_s * 1e3}
        for rec in tracer.drain() if trace else ():
            span_ms[rec.name] = span_ms.get(rec.name, 0.0) + rec.dur * 1e3
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
            "n_rows": tick.rows, "flags": tick.flags, "span_ms": span_ms})
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
    # One monitor launch per tick on which a ring holds min_points windows
    # (every stream has stride window/2: 2k - 1 windows after tick k), plus
    # one per gather dispatch.
    monitored = sum(1 for k in range(1, ticks + 1)
                    if min(2 * k - 1, mux.monitor.ring)
                    >= mux.monitor.min_points)
    dispatches = sum(t["dispatches"] for t in got)
    if fused:
        require(all(t["dispatches"] == 1 for t in got),
                f"{name}: expected 1 dispatch per tick")
        require(launches["windowvet"] == ticks,
                f"{name}: windowvet launches {launches} != ticks {ticks}")
        want_cp = monitored
    else:
        require(launches["windowvet"] == 0,
                f"{name}: windowvet launched on the gather path")
        want_cp = monitored + dispatches
    require(launches["changepoint"] == want_cp,
            f"{name}: changepoint launches {launches['changepoint']} != "
            f"{want_cp} ({monitored} monitored ticks)")
    plain_eng = VetEngine("torch", buckets=buckets, fused=fused)
    _, ref, plain_secs = run_fleet(plain_eng, specs, chunks, ticks)
    summary = compare_fleets(name, got, ref, specs, records, buckets)
    # Where a tick's host time goes: the same fleet once more, traced, on a
    # fresh engine (no cached results), outside the launch count.
    _, traced, traced_secs = run_fleet(VetEngine("cuda", buckets=buckets),
                                       specs, chunks, ticks, trace=True)
    return {"phase": name, "card": card, "streams": len(specs),
            "ticks": ticks, "buckets": buckets,
            "rows_per_tick": [t["n_rows"] for t in got],
            "dispatches_per_tick": [t["dispatches"] for t in got],
            "monitored_ticks": monitored,
            "tick_ms": [s * 1e3 for s in secs],
            "plain_tick_ms": [s * 1e3 for s in plain_secs],
            "traced_tick_ms": [s * 1e3 for s in traced_secs],
            "span_ms": [{k: round(v, 3) for k, v in t["span_ms"].items()}
                        for t in traced],
            "launches": launches, "vs_torch": summary}


def phase_serve(card: str, cfg=None, device: str = "cuda", batch: int = 4,
                prompt_len: int = 512, gen_len: int = 331,
                decode_check: int = 8) -> dict:
    """Full-width mamba2-130m (or ``cfg``) through the port's serve entry
    point, then the kernel path's prefill held against the plain path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve, serve_inputs
    from repro_torch.models import init_cache, prefill

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
    serve_checks(res, cfg, batch, gen_len, "serve")

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
    require(np.array_equal(res.tokens[:, 0],
                           torch.argmax(logits_k, -1).cpu().numpy()),
            "serve: first token differs from a fresh prefill on the same "
            "weights")
    greedy = held_greedy(cfg, params, cache,
                         init_cache(cfg, batch, prompt_len + gen_len,
                                    device=dev),
                         logits_k, logits_p, prompt_len, decode_check,
                         "serve")
    # The prefill once more, steady: mean of 20 back-to-back calls (CUDA
    # events) and one call traced for device ms by kernel (SSD among them).
    batch_in = {"tokens": prompts}
    steady_ms = cuda_ms(lambda: prefill(cfg, params, cache, batch_in))
    traced = device_time(lambda: prefill(cfg, params, cache, batch_in))
    small = reduced_vs_cpu(dev)
    ms = res.mux
    return {"phase": "serve", "card": card, "arch": cfg.name,
            "params": cfg.param_count(), "batch": batch,
            "prompt_len": prompt_len, "gen_len": gen_len,
            "prefill_ms": res.prefill_s * 1e3,
            "prefill_steady_ms": steady_ms, "traced_prefill": traced,
            "launches": launches,
            "tokens_per_s": res.tokens_per_s, "vet": res.vet, "ei": res.ei,
            "pr": res.pr, "window_vets": [float(v) for v in res.windows.vet],
            "mux_ticks": ms.ticks, "mux_dispatches": ms.dispatches,
            "anomaly_flags": len(res.flags),
            "decode_units": int(res.unit_times.size),
            "peak_device_bytes": int(peak),
            "prefill_logits_max_abs_err": err, "logit_scale": scale,
            "greedy_equal_steps": greedy, "reduced_vs_cpu": small,
            "result": res}


def reduced_vs_cpu(dev, arch: str = "mamba2-130m") -> dict:
    """The reduced config's prefill through the kernel on the card against
    the same weights on the CPU (plain path): 1e-4 of the largest logit;
    an MoE model's routing under the routing contract (``held_routing``),
    the CPU the reference side."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_inputs
    from repro_torch.models import init_cache

    cfg = get_config(arch).reduced()
    params, prompts = serve_inputs(cfg, batch=2, prompt_len=64, seed=3,
                                   dtype=torch.float32, device=dev)
    got = routed_prefill(cfg, params, {"tokens": prompts},
                         init_cache(cfg, 2, 64, device=dev))
    routing, ref, _ = held_routing(
        cfg, params, {"tokens": prompts},
        lambda where: init_cache(cfg, 2, 64, device=where), got,
        torch.device("cpu"), f"reduced {arch} card vs cpu")
    ref, got = ref.double(), got[0].double().cpu()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    require(err <= 1e-4 * scale, f"reduced {arch} prefill card vs cpu off "
                                 f"by {err:.3g} (scale {scale:.3g})")
    out = {"max_abs_err": err, "scale": scale}
    if routing["moe_calls"]:
        out["routing"] = routing
    return out


def routed_prefill(cfg, params, batch_in, cache, plain: bool = False,
                   force=None):
    """``prefill`` with its MoE routing recorded (or forced to ``force``'s):
    (last-token logits, cache, ``RoutingLog``)."""
    from repro_torch.models import layers as L
    from repro_torch.models import prefill
    with L.recording(L.RoutingLog(force=force)) as log:
        logits, cache = prefill(cfg, params, cache, batch_in, plain=plain)
    return logits, cache, log


def held_routing(cfg, params, batch_in, new_cache, got, where,
                 context: str):
    """The routing contract between the kernel path's ``got`` = (logits,
    cache, log) and the plain path on ``where`` (the same weights), the
    reference side: run the plain path; where both route alike call by
    call, it is the reference; else the plain path once more, forced to
    the kernel path's routing, is, and every flip must be a near-tie under
    its own values (``routing_flips``' worst gap within ``GAP``).  The
    differences between the two free runs, cascades included, are counted
    (``free_runs``).  Returns (summary, reference logits, reference
    cache)."""
    from repro_torch.models import layers as L
    from repro_torch.tree import tree_map
    import torch
    p = tree_map(lambda t: t.to(where), params)
    b = {k: v.to(where) for k, v in batch_in.items()}
    chosen = got[2].to(where)

    def timed(force=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = routed_prefill(cfg, p, b, new_cache(where), plain=True,
                             force=force)
        torch.cuda.synchronize()
        return run, (time.perf_counter() - t0) * 1e3

    (logits, cache, log), out_ms = timed()
    out = {"moe_calls": len(chosen.calls),
           "routed_alike": L.same_routing(log, chosen), "plain_ms": out_ms}
    if not out["routed_alike"]:
        out["free_runs"] = L.routing_flips(log, chosen)
        del logits, cache
        (logits, cache, log), out["forced_plain_ms"] = timed(chosen)
    flips = L.routing_flips(log, chosen)
    require(flips["worst_gap"] <= GAP,
            f"{context}: a routing flip {flips} is no near-tie (gap above "
            f"{GAP} under the plain path's own values)")
    out.update(flips)
    return out, logits, cache


def device_time(fn, top: int = 8, ranges=(), match=()) -> dict:
    """``fn()`` under ``torch.profiler``: wall ms, the summed time of the
    device's own events (kernels and copies, not the operators that launch
    them) and the largest by name; with ``match``, the device ms and calls
    of the kernels whose names hold each substring; with ``ranges``, for
    each named ``record_function`` range the device ms of the kernels its
    operators launched (``busy_ms``) and the range's span on the device's
    timeline (``span_ms``, gaps included; the profiler draws a range there
    as an annotation, which is kept out of the device's own events).
    Reports the profiler's error instead of failing, but fails if the
    summed device time exceeds the wall time (a count that took in more
    than the device's own events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    except RuntimeError as exc:
        return {"error": str(exc).splitlines()[0][:200]}
    kernels = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type == DeviceType.CUDA and dev_us > 0 \
                and e.key not in ranges:
            kernels.append((dev_us / 1e3, e.key, e.count))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    require(busy <= wall * 1.01, f"device_time: {busy:.1f} ms of device "
                                 f"events in {wall:.1f} ms of wall time")
    out = {"wall_ms": wall, "device_ms": busy,
           "idle_share": 1.0 - busy / wall,
           "device_events": sum(k[2] for k in kernels),
           "top": [{"kernel": k[:80], "ms": t, "calls": c}
                   for t, k, c in kernels[:top]]}
    if match:
        out["matched"] = {m: {"ms": sum(t for t, k, _ in kernels if m in k),
                              "calls": sum(c for _, k, c in kernels if m in k)}
                          for m in match}
    if ranges:
        out["ranges"] = {}
        for r in ranges:
            cpu = [e for e in prof.events()
                   if e.name == r and e.device_type == DeviceType.CPU]
            span = [e for e in prof.events()
                    if e.name == r and e.device_type == DeviceType.CUDA]
            out["ranges"][r] = {
                "calls": len(cpu),
                "busy_ms": sum(e.device_time_total for e in cpu) / 1e3,
                "span_ms": sum(e.time_range.elapsed_us()
                               for e in span) / 1e3} if cpu else "not run"
    return out


def phase_serve_attn(card: str, cfg=None, device: str = "cuda",
                     batch: int = 2, prompt_len: int = 7168,
                     gen_len: int = 331, decode_check: int = 8) -> dict:
    """Full-width h2o-danube-3-4b (or ``cfg``) through the port's serve
    entry point, then the kernel path's prefill held against the plain
    attention path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve, serve_inputs
    from repro_torch.models import decode_step, init_cache, prefill

    cfg = cfg if cfg is not None else get_config("h2o-danube-3-4b")
    dev = torch.device(device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res = serve(cfg, batch=batch, prompt_len=prompt_len, gen_len=gen_len,
                device=dev, verbose=False, init_device=dev)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    require(launches["flash_attention"] == cfg.num_layers,
            f"serve_attn: expected {cfg.num_layers} flash-attention launches "
            f"(one per layer's prefill), got {launches}")
    serve_checks(res, cfg, batch, gen_len, "serve_attn")
    torch.cuda.empty_cache()  # the serving run's weights are gone

    # Kernel path against the plain path: same card, same weights, each
    # path filling its own cache (the caches are written in place).
    params, prompts = serve_inputs(cfg, batch=batch, prompt_len=prompt_len,
                                   seed=0, dtype=torch.float32, device=dev,
                                   init_device=dev)
    s_max = prompt_len + gen_len
    batch_in = {"tokens": prompts}
    ck = init_cache(cfg, batch, s_max, device=dev)
    t0 = time.perf_counter()
    logits_k, ck = prefill(cfg, params, ck, batch_in)
    torch.cuda.synchronize()
    kernel_prefill_ms = (time.perf_counter() - t0) * 1e3
    cp = init_cache(cfg, batch, s_max, device=dev)
    t0 = time.perf_counter()
    logits_p, cp = prefill(cfg, params, cp, batch_in, plain=True)
    torch.cuda.synchronize()
    plain_prefill_ms = (time.perf_counter() - t0) * 1e3
    live = torch.arange(logits_k.shape[-1], device=dev) < cfg.vocab_size
    lk, lp = logits_k[:, live].double(), logits_p[:, live].double()
    require(bool(torch.isfinite(lk).all()), "serve_attn: non-finite logits")
    err = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    require(err <= LOGIT_TOL * scale, f"serve_attn: prefill logits kernel vs "
                                      f"plain off by {err:.3g} (scale "
                                      f"{scale:.3g})")
    kv_err, kv_scale = cache_err(ck, cp)
    require(kv_err <= LOGIT_TOL * kv_scale,
            f"serve_attn: filled KV caches kernel vs plain off by "
            f"{kv_err:.3g} (scale {kv_scale:.3g})")
    require(np.array_equal(res.tokens[:, 0],
                           torch.argmax(logits_k, -1).cpu().numpy()),
            "serve_attn: first token differs from a fresh prefill on the "
            "same weights")
    greedy = held_greedy(cfg, params, ck, cp, logits_k, logits_p,
                         prompt_len, decode_check, "serve_attn")
    tk = torch.argmax(logits_k, -1)[:, None]
    del cp
    torch.cuda.empty_cache()
    pos = prompt_len + decode_check
    traced = {
        "prefill": device_time(lambda: prefill(cfg, params, ck, batch_in)),
        "decode_4_steps": device_time(lambda: [
            decode_step(cfg, params, ck, tk, pos + j) for j in range(4)]),
    }
    del params, ck
    torch.cuda.empty_cache()
    small = reduced_vs_cpu(dev, "h2o-danube-3-4b")
    ms = res.mux
    return {"phase": "serve_attn", "card": card, "arch": cfg.name,
            "params": cfg.param_count(), "batch": batch,
            "prompt_len": prompt_len, "gen_len": gen_len,
            "weights_drawn_on": "card",
            "init_s": res.init_s, "prefill_ms": res.prefill_s * 1e3,
            "kernel_prefill_ms": kernel_prefill_ms,
            "plain_prefill_ms": plain_prefill_ms, "launches": launches,
            "tokens_per_s": res.tokens_per_s, "vet": res.vet, "ei": res.ei,
            "pr": res.pr, "window_vets": [float(v) for v in res.windows.vet],
            "mux_ticks": ms.ticks, "mux_dispatches": ms.dispatches,
            "anomaly_flags": len(res.flags),
            "decode_units": int(res.unit_times.size),
            "decode_unit_ms_median": float(np.median(res.unit_times)) * 1e3,
            "peak_device_bytes": int(peak),
            "prefill_logits_max_abs_err": err, "logit_scale": scale,
            "kv_cache_max_abs_err": kv_err, "kv_cache_scale": kv_scale,
            "greedy_equal_steps": greedy, "traced": traced,
            "reduced_vs_cpu": small}


# ------------------------------------------------------------- serve_moe
def cache_err(a, b) -> tuple:
    """(largest |a - b| over every floating tensor of two cache trees: K
    and V, their int8 scales, MLA's ``ckv`` and ``krope``, a hybrid's
    shared-attention caches and Mamba states; the largest |b|)."""
    pairs = [(a[s][n].float(), b[s][n].float()) for s in b for n in b[s]
             if b[s][n].is_floating_point()]
    err = max(float((x - y).abs().max()) for x, y in pairs)
    scale = max(float(y.abs().max()) for _, y in pairs)
    return err, scale


def held_greedy(cfg, params, ck, cr, logits_k, logits_r, pos: int,
                steps: int, context: str) -> int:
    """Greedy tokens from two prefills' logits and caches, decoded
    ``steps`` steps from ``pos``: equal at every step (fails otherwise).
    Returns the steps held."""
    import torch
    from repro_torch.models import decode_step
    tk = torch.argmax(logits_k, -1)[:, None]
    tr = torch.argmax(logits_r, -1)[:, None]
    same = [bool(torch.equal(tk, tr))]
    for i in range(steps):
        lk_i, ck = decode_step(cfg, params, ck, tk, pos + i)
        lr_i, cr = decode_step(cfg, params, cr, tr, pos + i)
        tk = torch.argmax(lk_i, -1)[:, None]
        tr = torch.argmax(lr_i, -1)[:, None]
        same.append(bool(torch.equal(tk, tr)))
    require(all(same), f"{context}: greedy tokens differ between the kernel "
                       f"and plain paths at steps {same}")
    return len(same)


def phase_serve_moe(card: str, device: str = "cuda", batch: int = 2,
                    prompt_len: int = 2048, gen_len: int = 331,
                    decode_check: int = 8, unit: int = 5) -> dict:
    """Full deepseek-moe-16b through the port's serve entry point, then the
    kernel path's prefill held against the plain path under the routing
    contract (``held_routing``), a second kernel-path prefill bit for bit,
    greedy decode, and a traced prefill and decode."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve, serve_inputs
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.tree import leaves

    cfg = get_config("deepseek-moe-16b")
    dev = torch.device(device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res = serve(cfg, batch=batch, prompt_len=prompt_len, gen_len=gen_len,
                device=dev, verbose=False, init_device=dev,
                record_unit=unit)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    require(launches["flash_attention"] == cfg.num_layers,
            f"serve_moe: expected {cfg.num_layers} flash-attention launches "
            f"(one per layer's prefill), got {launches}")
    serve_checks(res, cfg, batch, gen_len, "serve_moe")
    torch.cuda.empty_cache()  # the serving run's weights are gone

    params, prompts = serve_inputs(cfg, batch=batch, prompt_len=prompt_len,
                                   seed=0, dtype=torch.float32, device=dev,
                                   init_device=dev)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    s_max = prompt_len + gen_len
    batch_in = {"tokens": prompts}

    def new_cache(where):
        return init_cache(cfg, batch, s_max, device=where)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = routed_prefill(cfg, params, batch_in, new_cache(dev))
    torch.cuda.synchronize()
    kernel_prefill_ms = (time.perf_counter() - t0) * 1e3
    logits_k, ck, log_k = got
    # the same prefill again: the combine sums in a fixed order, so the
    # logits, the caches and the routing repeat bit for bit
    again = routed_prefill(cfg, params, batch_in, new_cache(dev))
    require(bool(torch.equal(again[0], logits_k))
            and cache_err(again[1], ck)[0] == 0.0
            and all(torch.equal(a.probs, b.probs)
                    and torch.equal(a.slot, b.slot)
                    for a, b in zip(again[2].calls, log_k.calls)),
            "serve_moe: a second kernel-path prefill differs from the first")
    del again
    routing, logits_r, cr = held_routing(cfg, params, batch_in, new_cache,
                                         got, dev, "serve_moe")
    live = torch.arange(logits_k.shape[-1], device=dev) < cfg.vocab_size
    lk, lr = logits_k[:, live].double(), logits_r[:, live].double()
    require(bool(torch.isfinite(lk).all()), "serve_moe: non-finite logits")
    err = float((lk - lr).abs().max())
    scale = float(lr.abs().max())
    require(err <= LOGIT_TOL * scale, f"serve_moe: prefill logits kernel vs "
                                      f"plain off by {err:.3g} (scale "
                                      f"{scale:.3g}; routing {routing})")
    kv_err, kv_scale = cache_err(ck, cr)
    require(kv_err <= LOGIT_TOL * kv_scale,
            f"serve_moe: filled KV caches kernel vs plain off by "
            f"{kv_err:.3g} (scale {kv_scale:.3g}; routing {routing})")
    require(np.array_equal(res.tokens[:, 0],
                           torch.argmax(logits_k, -1).cpu().numpy()),
            "serve_moe: first token differs from a fresh prefill on the "
            "same weights")
    routed = sum(c.top_idx.numel() for c in log_k.calls)
    dropped = sum(int(c.dropped) for c in log_k.calls)
    del log_k, got
    greedy = held_greedy(cfg, params, ck, cr, logits_k, logits_r,
                         prompt_len, decode_check, "serve_moe")
    del cr
    torch.cuda.empty_cache()
    tk = torch.argmax(logits_k, -1)[:, None]
    pos = prompt_len + decode_check
    traced = {
        "prefill": device_time(lambda: prefill(cfg, params, ck, batch_in),
                               top=10, match=("flash_", "gemm", "Sort",
                                              "gather")),
        "decode_4_steps": device_time(lambda: [
            decode_step(cfg, params, ck, tk, pos + j) for j in range(4)],
            top=10, match=("gemm", "gemv")),
    }
    del params, ck
    torch.cuda.empty_cache()
    small = reduced_vs_cpu(dev, "deepseek-moe-16b")
    decode_ms = float(np.median(res.unit_times)) / unit * 1e3
    ms = res.mux
    return {"phase": "serve_moe", "card": card, "arch": cfg.name,
            "params": cfg.param_count(), "weight_bytes": weight_bytes,
            "batch": batch, "prompt_len": prompt_len, "gen_len": gen_len,
            "weights_drawn_on": "card", "init_s": res.init_s,
            "prefill_ms": res.prefill_s * 1e3,
            "kernel_prefill_ms": kernel_prefill_ms,
            "plain_prefill_ms": routing["plain_ms"],
            "decode_ms_per_step_median": decode_ms,
            "decode_weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S
            * 1e3, "launches": launches, "tokens_per_s": res.tokens_per_s,
            "vet": res.vet, "ei": res.ei, "pr": res.pr,
            "window_vets": [float(v) for v in res.windows.vet],
            "mux_ticks": ms.ticks, "mux_dispatches": ms.dispatches,
            "anomaly_flags": len(res.flags),
            "decode_units": int(res.unit_times.size),
            "peak_device_bytes": int(peak),
            "prefill_routed_slots": routed, "prefill_dropped_slots": dropped,
            "prefill_dropped_share": dropped / routed,
            "routing": routing, "prefill_bitwise_repeat": True,
            "prefill_logits_max_abs_err": err, "logit_scale": scale,
            "kv_cache_max_abs_err": kv_err, "kv_cache_scale": kv_scale,
            "greedy_equal_steps": greedy, "traced": traced,
            "reduced_vs_cpu": small}


# ------------------------------------------------ serve_hybrid, serve_mla
def serve_checks(res, cfg, batch: int, gen_len: int, context: str,
                 windows: bool = True) -> None:
    """What every serve phase holds of ``serve``'s result: the tokens'
    shape and range, a finite vet of at least 1, and (``windows``) two
    window snapshots of the live dashboard."""
    require(res.tokens.shape == (batch, gen_len), f"{context}: token shape")
    require(np.all((res.tokens >= 0) & (res.tokens < cfg.vocab_size)),
            f"{context}: token outside the vocabulary")
    require(res.vet is not None and np.isfinite(res.vet) and res.vet >= 1.0
            - 1e-6, f"{context}: vet {res.vet}")
    if windows:
        require(res.windows is not None and res.windows.workers >= 2,
                f"{context}: fewer than two window snapshots")
        require(np.all(np.isfinite(res.windows.vet)),
                f"{context}: window vets")


def held_logits(lk, lr, cfg, context: str) -> tuple:
    """(largest |lk - lr| over the live vocabulary, the largest |lr|),
    within ``LOGIT_TOL`` of the scale."""
    import torch
    live = torch.arange(lk.shape[-1], device=lk.device) < cfg.vocab_size
    a, b = lk[:, live].double(), lr[:, live].double()
    require(bool(torch.isfinite(a).all()), f"{context}: non-finite logits")
    err, scale = float((a - b).abs().max()), float(b.abs().max())
    require(err <= LOGIT_TOL * scale, f"{context}: prefill logits off by "
                                      f"{err:.3g} (scale {scale:.3g})")
    return err, scale


def timed_prefill(cfg, params, cache, batch_in, plain: bool = False):
    """(logits, cache, ms, launches) of one synchronised prefill."""
    import torch
    from repro_torch.models import prefill
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, params, cache, batch_in, plain=plain)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return logits, cache, ms, {**read_counts(), "flash_wide": wide_count()}


def _tf32(x):
    """f32 -> TF32 (10-bit mantissa), nearest with ties away from zero, as
    the flash kernel's f32 entry rounds an operand."""
    import torch
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _einsum_3xtf32(eq, a, b):
    """``einsum`` in f32 from three TF32 products, as the flash kernel's f32
    entry forms Q Kᵀ and P V: a = ab + as, b = bb + bs (each part rounded
    to TF32), as bb + ab bs + ab bb; each product exact in f32."""
    import torch
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32(a - ab), _tf32(b - bb)
    return ((torch.einsum(eq, as_, bb) + torch.einsum(eq, ab, bs))
            + torch.einsum(eq, ab, bb))


@contextlib.contextmanager
def attention_products_3xtf32():
    """Within it, ``attention_plain`` forms its two products in 3xTF32, as
    the flash kernel's f32 entry does, and changes nothing else (not the
    kernel's tiles, its base-2 online softmax or its order of sums): the
    plain version's module sees a ``torch`` whose ``einsum`` is
    ``_einsum_3xtf32``.  ``drift_probe`` and ``layerwise_check`` use it to
    ask whether that arithmetic explains the kernel path's drift."""
    import torch
    from repro_torch.kernels.flash_attention import ref

    class Torch3xTF32:
        einsum = staticmethod(_einsum_3xtf32)

        def __getattr__(self, name):
            return getattr(torch, name)

    ref.torch = Torch3xTF32()
    try:
        yield
    finally:
        ref.torch = torch


def layerwise_check(cfg, params, batch_in, s_max: int) -> dict:
    """A plain-path prefill in which every Mamba block and every
    shared-attention block also runs through the kernels (SSD; flash) on
    the plain path's own input to that block: each kernel output within
    ``LAYER_TOL`` of the plain output's largest value.  This holds every
    kernel call of the model at its full-size activations, apart from the
    amplification of earlier layers' differences that a free prefill
    sees.  Beside it, reported and not held: the plain Mamba block at
    another f32 order (SSD chunk 32) and the plain attention block with
    its products in 3xTF32 (``attention_products_3xtf32``) on the same
    input, the size of one call's rounding in those arithmetics."""
    import dataclasses
    import torch
    from repro_torch.models import blocks as B
    from repro_torch.models import init_cache, prefill
    mamba, attn = B.mamba_block_apply, B.block_prefill
    c32 = dataclasses.replace(cfg, ssm_chunk=32)
    worst = {"mamba": 0.0, "attention": 0.0, "mamba_plain_chunk32": 0.0,
             "attention_plain_3xtf32": 0.0}
    calls = {"mamba": 0, "attention": 0}

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    def mamba_twin(lp, x, c, ctx=None, *, plain=False):  # off a mesh
        want = mamba(lp, x, c, plain=True)
        worst["mamba"] = max(worst["mamba"], rel(mamba(lp, x, c), want))
        worst["mamba_plain_chunk32"] = max(
            worst["mamba_plain_chunk32"], rel(mamba(lp, x, c32, plain=True),
                                              want))
        calls["mamba"] += 1
        return want

    def attn_twin(lp, x, c, cache, ctx=None, *, q_chunk=1024,
                  plain=False):  # off a mesh
        got, _ = B.block_apply(lp, x, c, q_chunk=q_chunk)
        with attention_products_3xtf32():
            got3, _ = B.block_apply(lp, x, c, q_chunk=q_chunk, plain=True)
        want, cache = attn(lp, x, c, cache, q_chunk=q_chunk, plain=True)
        worst["attention"] = max(worst["attention"], rel(got, want))
        worst["attention_plain_3xtf32"] = max(
            worst["attention_plain_3xtf32"], rel(got3, want))
        calls["attention"] += 1
        return want, cache

    B.mamba_block_apply, B.block_prefill = mamba_twin, attn_twin
    try:
        with torch.no_grad():
            prefill(cfg, params, init_cache(cfg, batch_in["tokens"].shape[0],
                                            s_max, device=batch_in[
                                                "tokens"].device),
                    batch_in, plain=True)
    finally:
        B.mamba_block_apply, B.block_prefill = mamba, attn
    require(worst["mamba"] <= LAYER_TOL and worst["attention"] <= LAYER_TOL,
            f"layerwise: a kernel call differs from the plain path on its "
            f"input by {worst} of the output's largest value (calls {calls})")
    return {"calls": calls, "worst_rel": worst, "tol": LAYER_TOL}


def drift_probe(cfg, params, batch_in, s_max: int, every: int = 8) -> dict:
    """Which kernel drives a free prefill's drift from the plain path:
    prefills of the hybrid with both kernels, the SSD kernel alone
    (attention plain), the flash kernel alone (SSD plain), the plain path
    at another f32 order (SSD chunk 32), and the plain path with its
    attention products in 3xTF32 (``attention_products_3xtf32``), each
    against the plain path.
    For each: the residual stream's largest difference after every
    ``every``-th Mamba layer and after the last, the logits' and the shared
    K/V caches', each relative to the plain run's largest value.  Reported,
    not held: ``layerwise_check`` holds every call, the phase the caches.
    The plain run's residual streams stay on the card (4.75 GB at
    ``serve_hybrid``'s shape)."""
    import dataclasses
    import torch
    from repro_torch.models import blocks as B
    from repro_torch.models import init_cache, prefill
    mamba, attn = B.mamba_block_apply, B.block_prefill
    plain_at, now = [], []  # the plain run's residuals; this run's gaps
    mode = {}

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    def mamba_hook(lp, x, c, ctx=None, *, plain=False):  # off a mesh
        y = mamba(lp, x, c, plain=mode["ssd_plain"])
        if mode["name"] == "plain":
            plain_at.append(y)
        else:
            now.append(rel(y, plain_at[len(now)]))
        return y

    def attn_hook(lp, x, c, cache, ctx=None, *, q_chunk=1024,
                  plain=False):  # off a mesh
        return attn(lp, x, c, cache, q_chunk=q_chunk,
                    plain=mode["flash_plain"])

    b, dev = batch_in["tokens"].shape[0], batch_in["tokens"].device
    chunk32 = dataclasses.replace(cfg, ssm_chunk=32)
    runs = (("plain", cfg, True, True), ("kernel", cfg, False, False),
            ("ssd_kernel", cfg, False, True),
            ("flash_kernel", cfg, True, False),
            ("plain_chunk32", chunk32, True, True),
            ("plain_attention_3xtf32", cfg, True, True))
    out, base = {}, None
    B.mamba_block_apply, B.block_prefill = mamba_hook, attn_hook
    try:
        for name, c, ssd_plain, flash_plain in runs:
            mode.update(name=name, ssd_plain=ssd_plain,
                        flash_plain=flash_plain)
            now.clear()
            with torch.no_grad(), (
                    attention_products_3xtf32() if name.endswith("3xtf32")
                    else contextlib.nullcontext()):
                logits, cache = prefill(c, params, init_cache(
                    c, b, s_max, device=dev), batch_in)
            shared = cache["shared_attn"]
            if base is None:
                base = (logits, shared)
                continue
            scale = max(float(base[1][n].abs().max()) for n in ("k", "v"))
            live = torch.arange(logits.shape[-1], device=dev) < cfg.vocab_size
            out[name] = {
                "logits_rel": rel(logits[:, live], base[0][:, live]),
                "cache_rel": max(float((shared[n] - base[1][n]).abs().max())
                                 for n in ("k", "v")) / scale,
                f"layer_rel_every_{every}": now[::every] + (
                    now[-1:] if (len(now) - 1) % every else [])}
            del logits, cache, shared
    finally:
        B.mamba_block_apply, B.block_prefill = mamba, attn
    del plain_at, base
    torch.cuda.empty_cache()
    return out


def int8_part(cfg, params, batch_in, s_max: int, ck, cp, logits_k,
              pos: int, steps: int) -> dict:
    """The same prefill with ``kv_cache_dtype="int8"`` on the same weights,
    kernel and plain paths, each into its own int8 cache, held to the f32
    caches ``ck`` (kernel) and ``cp`` (plain) over the prompt's ``pos``
    positions: the logits equal the f32 kernel path's bit for bit (a
    prefill attends unquantised); each path's dequantised cache within one
    quantum (its scale) of its own f32 cache; the kernel and plain paths'
    payloads compared entry by entry (the count of entries that differ and
    the largest difference reported), each difference explained by the f32
    caches' own: |deq_k - deq_p| <= |ck - cp| + (s_k + s_p) / 2, and
    |s_k - s_p| <= max over the row of |ck - cp| / 127.  Then ``steps``
    greedy decode steps of both int8 paths with equal tokens."""
    import dataclasses
    import torch
    from repro_torch.models import blocks as B
    from repro_torch.models import init_cache
    c8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    dev, b = logits_k.device, logits_k.shape[0]
    lk8, c8k, ms, _ = timed_prefill(c8, params, init_cache(
        c8, b, s_max, device=dev), batch_in)
    lp8, c8p, plain_ms, _ = timed_prefill(c8, params, init_cache(
        c8, b, s_max, device=dev), batch_in, plain=True)
    require(bool(torch.equal(lk8, logits_k)),
            "int8: the prefill's logits differ from the f32 cache's")
    quanta, flips, entries, most = 0.0, 0, 0, 0
    slack = 0.0  # the largest excess over the bound (must stay <= 0)
    for seg in c8k:
        if "k_scale" not in c8k[seg]:
            continue
        for name in ("k", "v"):
            qk, sk = c8k[seg][name][:, :, :pos], c8k[seg][f"{name}_scale"]
            qp, sp = c8p[seg][name][:, :, :pos], c8p[seg][f"{name}_scale"]
            sk, sp = sk[:, :, :pos].float(), sp[:, :, :pos].float()
            fk = ck[seg][name][:, :, :pos].float()
            fp = cp[seg][name][:, :, :pos].float()
            dk = B._kv_dequant(qk, sk, torch.float32)
            dp = B._kv_dequant(qp, sp, torch.float32)
            quanta = max(quanta,
                         float(((dk - fk).abs() / sk[..., None]).max()),
                         float(((dp - fp).abs() / sp[..., None]).max()))
            diff = (qk.int() - qp.int()).abs()
            flips += int((diff > 0).sum())
            most = max(most, int(diff.max()))
            entries += qk.numel()
            gap = (fk - fp).abs()
            bound = gap + (sk + sp)[..., None] / 2
            slack = max(slack, float(((dk - dp).abs() - bound * (1 + 1e-5)
                                      - 1e-6).max()))
            row = gap.amax(dim=-1) / 127
            slack = max(slack, float(((sk - sp).abs() - row * (1 + 1e-5)
                                      - 1e-6).max()))
            del dk, dp, fk, fp, gap, bound
    require(quanta <= 1.0, f"int8: a dequantised cache lies {quanta:.3g} "
                           f"quanta from its f32 cache")
    require(slack <= 0.0, f"int8: the kernel and plain int8 caches differ "
                          f"by {slack:.3g} more than their f32 caches explain")
    greedy = held_greedy(c8, params, c8k, c8p, lk8, lp8, pos, steps, "int8")
    return {"kernel_prefill_ms": ms, "plain_prefill_ms": plain_ms,
            "logits_equal_f32_cache": True,
            "max_dequant_err_quanta": quanta, "payload_flips": flips,
            "payload_entries": entries, "max_payload_diff": most,
            "greedy_equal_steps": greedy,
            "cache_bytes": sum(t.numel() * t.element_size()
                               for c in c8k.values() for t in c.values())}


def phase_serve_hybrid(card: str, device: str = "cuda", batch: int = 2,
                       prompt_len: int = 2048, gen_len: int = 331,
                       decode_check: int = 8, unit: int = 5) -> dict:
    """Full zamba2-7b through the port's serve entry point (81 Mamba2
    layers and 14 shared-attention applications: 81 SSD and 14 flash
    launches a prefill), then the kernel path's prefill against the plain
    path (logits, shared-attention caches), a second kernel prefill bit
    for bit, greedy decode, the int8 KV cache, and a traced prefill and
    decode."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve, serve_inputs
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.tree import leaves

    cfg = get_config("zamba2-7b")
    apps = -(-cfg.num_layers // cfg.hybrid_attn_every)
    want = {"ssd": cfg.num_layers, "flash_attention": apps, "flash_wide": 0}
    dev = torch.device(device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res = serve(cfg, batch=batch, prompt_len=prompt_len, gen_len=gen_len,
                device=dev, verbose=False, init_device=dev, record_unit=unit)
    torch.cuda.synchronize()
    launches = {**read_counts(), "flash_wide": wide_count()}
    peak = torch.cuda.max_memory_allocated()
    require(all(launches[k] == v for k, v in want.items()),
            f"serve_hybrid: expected {want} launches (one SSD per layer, one "
            f"flash per shared-attention application), got {launches}")
    serve_checks(res, cfg, batch, gen_len, "serve_hybrid")
    torch.cuda.empty_cache()  # the serving run's weights are gone

    params, prompts = serve_inputs(cfg, batch=batch, prompt_len=prompt_len,
                                   seed=0, dtype=torch.float32, device=dev,
                                   init_device=dev)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    s_max = prompt_len + gen_len
    batch_in = {"tokens": prompts}

    def new_cache():
        return init_cache(cfg, batch, s_max, device=dev)

    logits_k, ck, kernel_ms, per = timed_prefill(cfg, params, new_cache(),
                                                 batch_in)
    require(all(per[k] == v for k, v in want.items()),
            f"serve_hybrid: a prefill launched {per}, expected {want}")
    again, ca, _, _ = timed_prefill(cfg, params, new_cache(), batch_in)
    require(bool(torch.equal(again, logits_k)) and cache_err(ca, ck)[0] == 0,
            "serve_hybrid: a second kernel-path prefill differs from the "
            "first")
    del again, ca
    logits_p, cp, plain_ms, _ = timed_prefill(cfg, params, new_cache(),
                                              batch_in, plain=True)
    err, scale = held_logits(logits_k, logits_p, cfg, "serve_hybrid")
    kv_err, kv_scale = cache_err(ck, cp)
    require(kv_err <= HYBRID_CACHE_TOL * kv_scale,
            f"serve_hybrid: shared-attention caches kernel vs plain off by "
            f"{kv_err:.3g} (scale {kv_scale:.3g})")
    apps_err = [float((ck["shared_attn"][n][a] - cp["shared_attn"][n][a])
                      .abs().max() / kv_scale) for a in range(apps)
                for n in ("k",)]
    require(not any(bool(t.any()) for t in ck["seg0"].values()),
            "serve_hybrid: the prefill wrote the Mamba states")
    require(np.array_equal(res.tokens[:, 0],
                           torch.argmax(logits_k, -1).cpu().numpy()),
            "serve_hybrid: first token differs from a fresh prefill on the "
            "same weights")
    greedy = held_greedy(cfg, params, ck, cp, logits_k, logits_p,
                         prompt_len, decode_check, "serve_hybrid")
    # the decode above changed the caches' Mamba states and positions past
    # the prompt; the int8 part compares the prompt's positions only
    int8 = int8_part(cfg, params, batch_in, s_max, ck, cp, logits_k,
                     prompt_len, decode_check)
    del cp
    torch.cuda.empty_cache()
    layers = layerwise_check(cfg, params, batch_in, prompt_len)
    torch.cuda.empty_cache()
    drift = drift_probe(cfg, params, batch_in, prompt_len)
    tk = torch.argmax(logits_k, -1)[:, None]
    pos = prompt_len + decode_check
    traced = {
        "prefill": device_time(lambda: prefill(cfg, params, ck, batch_in),
                               top=10, match=("flash_", "ssd_", "gemm")),
        "decode_4_steps": device_time(lambda: [
            decode_step(cfg, params, ck, tk, pos + j) for j in range(4)],
            top=10, match=("gemm", "gemv")),
    }
    del params, ck
    torch.cuda.empty_cache()
    small = reduced_vs_cpu(dev, "zamba2-7b")
    ms = res.mux
    return {"phase": "serve_hybrid", "card": card, "arch": cfg.name,
            "params": cfg.param_count(), "weight_bytes": weight_bytes,
            "layers": cfg.num_layers, "shared_attn_applications": apps,
            "batch": batch, "prompt_len": prompt_len, "gen_len": gen_len,
            "weights_drawn_on": "card", "init_s": res.init_s,
            "prefill_ms": res.prefill_s * 1e3,
            "kernel_prefill_ms": kernel_ms, "plain_prefill_ms": plain_ms,
            "decode_ms_per_step_median": float(np.median(res.unit_times))
            / unit * 1e3,
            "decode_weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S
            * 1e3, "launches": launches, "launches_per_prefill": per,
            "wide_launches": launches["flash_wide"],
            "tokens_per_s": res.tokens_per_s,
            "vet": res.vet, "ei": res.ei, "pr": res.pr,
            "window_vets": [float(v) for v in res.windows.vet],
            "mux_ticks": ms.ticks, "mux_dispatches": ms.dispatches,
            "anomaly_flags": len(res.flags),
            "decode_units": int(res.unit_times.size),
            "peak_device_bytes": int(peak), "prefill_bitwise_repeat": True,
            "prefill_logits_max_abs_err": err, "logit_scale": scale,
            "kv_cache_max_abs_err": kv_err, "kv_cache_scale": kv_scale,
            "kv_cache_tol": HYBRID_CACHE_TOL,
            "kv_cache_rel_err_by_application": apps_err,
            "layerwise": layers, "drift": drift,
            "greedy_equal_steps": greedy, "int8": int8, "traced": traced,
            "reduced_vs_cpu": small}


def phase_serve_mla(card: str, device: str = "cuda", batch: int = 2,
                    prompt_len: int = 2048, gen_len: int = 171,
                    decode_check: int = 8, unit: int = 5) -> dict:
    """Full deepseek-v2-lite-16b through the port's serve entry point (27
    layers of MLA: 27 launches of the flash kernel's wide entry a prefill,
    none of the narrow ones), then the kernel path's prefill against the
    plain path under the routing contract (``held_routing``; logits and the
    ``ckv``/``krope`` caches), a second kernel prefill bit for bit, greedy
    decode (absorbed into the latent space), and a traced prefill and
    decode.  Reports the logits' and caches' errors as shares of
    ``LOGIT_TOL`` and the wide entry's share of the traced prefill's device
    time.  It serves 171 tokens (34 unit records: the vet, no window
    snapshot) to keep the smoke near half its time limit; serve_hybrid
    carries the dashboard's two windows."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve, serve_inputs
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.tree import leaves

    cfg = get_config("deepseek-v2-lite-16b")
    want = {"ssd": 0, "flash_attention": cfg.num_layers,
            "flash_wide": cfg.num_layers}
    dev = torch.device(device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res = serve(cfg, batch=batch, prompt_len=prompt_len, gen_len=gen_len,
                device=dev, verbose=False, init_device=dev, record_unit=unit)
    torch.cuda.synchronize()
    launches = {**read_counts(), "flash_wide": wide_count()}
    peak = torch.cuda.max_memory_allocated()
    require(all(launches[k] == v for k, v in want.items()),
            f"serve_mla: expected {want} launches (one wide flash launch per "
            f"layer's prefill), got {launches}")
    serve_checks(res, cfg, batch, gen_len, "serve_mla",
                 windows=gen_len >= 331)
    torch.cuda.empty_cache()

    params, prompts = serve_inputs(cfg, batch=batch, prompt_len=prompt_len,
                                   seed=0, dtype=torch.float32, device=dev,
                                   init_device=dev)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    s_max = prompt_len + gen_len
    batch_in = {"tokens": prompts}

    def new_cache(where):
        return init_cache(cfg, batch, s_max, device=where)

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    got = routed_prefill(cfg, params, batch_in, new_cache(dev))
    torch.cuda.synchronize()
    kernel_prefill_ms = (time.perf_counter() - t0) * 1e3
    per = {**read_counts(), "flash_wide": wide_count()}
    require(all(per[k] == v for k, v in want.items()),
            f"serve_mla: a prefill launched {per}, expected {want}")
    logits_k, ck, log_k = got
    again = routed_prefill(cfg, params, batch_in, new_cache(dev))
    require(bool(torch.equal(again[0], logits_k))
            and cache_err(again[1], ck)[0] == 0.0
            and all(torch.equal(a.probs, b.probs)
                    and torch.equal(a.slot, b.slot)
                    for a, b in zip(again[2].calls, log_k.calls)),
            "serve_mla: a second kernel-path prefill differs from the first")
    del again
    routing, logits_r, cr = held_routing(cfg, params, batch_in, new_cache,
                                         got, dev, "serve_mla")
    err, scale = held_logits(logits_k, logits_r, cfg,
                             f"serve_mla (routing {routing})")
    kv_err, kv_scale = cache_err(ck, cr)
    require(kv_err <= LOGIT_TOL * kv_scale,
            f"serve_mla: ckv/krope caches kernel vs plain off by "
            f"{kv_err:.3g} (scale {kv_scale:.3g}; routing {routing})")
    require(np.array_equal(res.tokens[:, 0],
                           torch.argmax(logits_k, -1).cpu().numpy()),
            "serve_mla: first token differs from a fresh prefill on the "
            "same weights")
    routed = sum(c.top_idx.numel() for c in log_k.calls)
    dropped = sum(int(c.dropped) for c in log_k.calls)
    del log_k, got
    greedy = held_greedy(cfg, params, ck, cr, logits_k, logits_r,
                         prompt_len, decode_check, "serve_mla")
    del cr
    torch.cuda.empty_cache()
    tk = torch.argmax(logits_k, -1)[:, None]
    pos = prompt_len + decode_check
    traced = {
        "prefill": device_time(lambda: prefill(cfg, params, ck, batch_in),
                               top=10, match=("flash_wgmma", "gemm",
                                              "Sort", "gather")),
        "decode_4_steps": device_time(lambda: [
            decode_step(cfg, params, ck, tk, pos + j) for j in range(4)],
            top=10, match=("gemm", "gemv")),
    }
    pre = traced["prefill"]
    # the wide entry's share of the traced prefill's device time (every
    # flash launch of MLA's prefill is a wide one)
    wide_share = (pre["matched"]["flash_wgmma"]["ms"] / pre["device_ms"]
                  if "matched" in pre else None)
    del params, ck
    torch.cuda.empty_cache()
    small = reduced_vs_cpu(dev, "deepseek-v2-lite-16b")
    ms = res.mux
    return {"phase": "serve_mla", "card": card, "arch": cfg.name,
            "params": cfg.param_count(), "weight_bytes": weight_bytes,
            "batch": batch, "prompt_len": prompt_len, "gen_len": gen_len,
            "weights_drawn_on": "card", "init_s": res.init_s,
            "prefill_ms": res.prefill_s * 1e3,
            "kernel_prefill_ms": kernel_prefill_ms,
            "plain_prefill_ms": routing["plain_ms"],
            "decode_ms_per_step_median": float(np.median(res.unit_times))
            / unit * 1e3,
            "decode_weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S
            * 1e3, "launches": launches, "launches_per_prefill": per,
            "wide_launches": launches["flash_wide"],
            "tokens_per_s": res.tokens_per_s,
            "vet": res.vet, "ei": res.ei, "pr": res.pr,
            "window_vets": ([float(v) for v in res.windows.vet]
                            if res.windows is not None else []),
            "mux_ticks": ms.ticks, "mux_dispatches": ms.dispatches,
            "anomaly_flags": len(res.flags),
            "decode_units": int(res.unit_times.size),
            "peak_device_bytes": int(peak),
            "prefill_routed_slots": routed, "prefill_dropped_slots": dropped,
            "prefill_dropped_share": dropped / routed,
            "routing": routing, "prefill_bitwise_repeat": True,
            "prefill_logits_max_abs_err": err, "logit_scale": scale,
            "kv_cache_max_abs_err": kv_err, "kv_cache_scale": kv_scale,
            "logits_share_of_tol": err / (LOGIT_TOL * scale),
            "kv_cache_share_of_tol": kv_err / (LOGIT_TOL * kv_scale),
            "wide_share_of_traced_prefill": wide_share,
            "greedy_equal_steps": greedy, "traced": traced,
            "reduced_vs_cpu": small}


# ------------------------------------------------------------- frontends
def vlm_part(dev, layers: int = 4, batch: int = 2, patches: int = 1024,
             text: int = 1024, decode_check: int = 8) -> dict:
    """internvl2-26b at full width on ``layers`` of its 48 layers (weights
    drawn on the card): prefill from patch embeddings and text tokens, the
    kernel path against the plain path (logits, KV caches), then greedy
    decode from position ``patches + text``."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_params, prefill
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config("internvl2-26b"), num_layers=layers)
    require(cfg.frontend_seq == patches, "frontends: internvl2-26b's "
                                         "frontend_seq")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen)
    batch_in = {"embeddings": torch.randn((batch, patches, cfg.d_model),
                                          generator=gen, device=dev),
                "tokens": torch.randint(0, cfg.vocab_size, (batch, text),
                                        generator=gen, device=dev)}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    s_max = patches + text + decode_check
    ck = init_cache(cfg, batch, s_max, device=dev)
    zero_counts()
    t0 = time.perf_counter()
    logits_k, ck = prefill(cfg, params, ck, batch_in)
    torch.cuda.synchronize()
    kernel_prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    require(launches["flash_attention"] == layers,
            f"frontends: expected {layers} flash launches in internvl2-26b's "
            f"prefill, got {launches}")
    cp = init_cache(cfg, batch, s_max, device=dev)
    t0 = time.perf_counter()
    logits_p, cp = prefill(cfg, params, cp, batch_in, plain=True)
    torch.cuda.synchronize()
    plain_prefill_ms = (time.perf_counter() - t0) * 1e3
    live = torch.arange(logits_k.shape[-1], device=dev) < cfg.vocab_size
    lk, lp = logits_k[:, live].double(), logits_p[:, live].double()
    require(bool(torch.isfinite(lk).all()), "frontends: non-finite logits")
    err = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    require(err <= LOGIT_TOL * scale, f"frontends: internvl2-26b prefill "
                                      f"logits kernel vs plain off by "
                                      f"{err:.3g} (scale {scale:.3g})")
    kv_err, kv_scale = cache_err(ck, cp)
    require(kv_err <= LOGIT_TOL * kv_scale,
            f"frontends: internvl2-26b KV caches kernel vs plain off by "
            f"{kv_err:.3g} (scale {kv_scale:.3g})")
    greedy = held_greedy(cfg, params, ck, cp, logits_k, logits_p,
                         patches + text, decode_check, "frontends")
    peak = torch.cuda.max_memory_allocated()
    out = {"arch": cfg.name, "layers": layers,
           "cut": f"num_layers 48 -> {layers}", "params": cfg.param_count(),
           "tree_params": sum(t.numel() for t in leaves(params)),
           "batch": batch, "patches": patches, "text_tokens": text,
           "decode_from": patches + text, "weights_drawn_on": "card",
           "init_s": init_s, "kernel_prefill_ms": kernel_prefill_ms,
           "plain_prefill_ms": plain_prefill_ms, "launches": launches,
           "prefill_logits_max_abs_err": err, "logit_scale": scale,
           "kv_cache_max_abs_err": kv_err, "kv_cache_scale": kv_scale,
           "greedy_equal_steps": greedy, "peak_device_bytes": int(peak)}
    del params, ck, cp, batch_in
    torch.cuda.empty_cache()
    return out


def hubert_part(dev, steps: int = 4, batch: int = 2,
                seq_len: int = 1024) -> dict:
    """hubert-xlarge at full width and depth trained through the
    bidirectional flash kernel (weights drawn on the card), with the
    gradient check (``embed`` unread)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import init_params
    from repro_torch.tree import leaves

    cfg = get_config("hubert-xlarge")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, counts = counted(lambda: train(
        cfg, steps=steps, batch=batch, seq_len=seq_len, params=params,
        verbose=False, device=dev))
    peak = torch.cuda.max_memory_allocated()
    expect = {"ssd": 0, "flash_attention": 2 * cfg.num_layers * steps,
              "changepoint": report_launches(steps // 5), "windowvet": 0}
    require(counts == expect, f"frontends: hubert launches {counts}, "
                              f"derived {expect}")
    losses = np.asarray(res.losses)
    require(np.all(np.isfinite(losses)), f"frontends: hubert losses "
                                         f"{losses}")
    grads = gradient_check(cfg, params, train_batch(cfg, batch, seq_len, dev),
                           unread=("embed",))
    out = {"arch": cfg.name, "params": cfg.param_count(),
           "tree_params": sum(t.numel() for t in leaves(params)),
           "steps": steps, "batch": batch, "seq_len": seq_len,
           "remat": "full", "weights_drawn_on": "card",
           "losses": res.losses,
           "ms_per_step": res.phase_totals["step"] / steps * 1e3,
           "peak_device_bytes": int(peak),
           "flash_launches_per_step": counts["flash_attention"] / steps,
           "launches": counts, "gradients": grads}
    del params
    torch.cuda.empty_cache()
    return out


def phase_frontends(card: str, device: str = "cuda") -> dict:
    """The VLM and audio frontends on the card: internvl2-26b's prefill
    and decode from patch embeddings, hubert-xlarge's training."""
    import torch
    dev = torch.device(device)
    t0 = time.perf_counter()
    out = {"phase": "frontends", "card": card}
    for name, part in (("internvl2", lambda: vlm_part(dev)),
                       ("hubert", lambda: hubert_part(dev))):
        t1 = time.perf_counter()
        out[name] = part()
        out[name]["seconds"] = time.perf_counter() - t1
    out["launches"] = {k: out["internvl2"]["launches"][k]
                       + out["hubert"]["launches"][k]
                       for k in out["hubert"]["launches"]}
    out["seconds"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------------- transport
FIELDS = ("vet", "ei", "oc", "pr", "t", "n")


def fleet_records(sids, window_of, ticks, seed0: int = 1000):
    """The ``fleet_fused`` records and per-tick chunks (window records a
    tick per stream, ``simulate_records`` seeded 1000 + stream)."""
    from repro_torch.profiling import simulate_records
    records = [simulate_records(ticks * window_of(sid), seed=seed0 + sid).times
               for sid in sids]
    chunks = [[r[k * window_of(sid):(k + 1) * window_of(sid)]
               for k in range(ticks)] for sid, r in zip(sids, records)]
    return records, chunks


def drive_sharded(fleet, specs, chunks, ticks, tracer=None):
    """Register, feed and tick a sharded or transport fleet; per tick its
    schedule, counters, flags and every stream's newest-window row (host
    scalars), the tick's wall s (feed + tick + synchronize), the card's
    free bytes after it, and, under ``tracer``, the tick's spans."""
    import torch
    t0 = time.perf_counter()
    for sid, (w, s) in enumerate(specs):
        fleet.register(sid, window=w, stride=s, capacity=4 * w)
    setup_s = time.perf_counter() - t0
    per_tick, secs, free, spans = [], [], [], []
    for k in range(ticks):
        t0 = time.perf_counter()
        for sid in range(len(specs)):
            fleet.feed(sid, chunks[sid][k])
        tick = fleet.tick()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        free.append(torch.cuda.mem_get_info()[0])
        if tracer is not None:
            spans.append(tracer.drain())
        newest = {sid: tuple(f(np.asarray(getattr(r, name))[-1])
                             for name, f in zip(FIELDS, (float,) * 4
                                                + (int,) * 2))
                  for sid, r in tick.results.items()
                  if r is not None and r.workers > 0}
        per_tick.append({"serviced": dict(tick.serviced),
                         "deferred": dict(tick.deferred),
                         "counts": (tick.dispatches, tick.rows,
                                    tick.padded_rows),
                         "flags": tuple(tick.flags), "newest": newest})
    return {"ticks": per_tick, "secs": secs, "free": free, "spans": spans,
            "setup_s": setup_s}


def collected(fleet, n: int) -> list:
    """Every stream's retained rows (``collect`` across the pipe for the
    transport fleet, the shard's stream in process otherwise)."""
    get = getattr(fleet, "collect", None) or \
        (lambda sid: fleet.stream(sid).collect())
    return [get(sid) for sid in range(n)]


def same_run(name, a, b, rows_a, rows_b) -> None:
    """Bit for bit: every tick's schedule, counters, flags and newest rows,
    and every stream's retained rows."""
    for k, (x, y) in enumerate(zip(a["ticks"], b["ticks"])):
        for key in ("serviced", "deferred", "counts", "flags", "newest"):
            require(x[key] == y[key], f"{name} tick {k}: {key} differ")
    for sid, (x, y) in enumerate(zip(rows_a, rows_b)):
        require(all(np.array_equal(getattr(x, f), getattr(y, f))
                    for f in FIELDS), f"{name}: stream {sid}'s rows differ")


def as_fleet_ticks(run, rows) -> list:
    """A sharded run's ticks in ``compare_fleets``' form: each tick's
    serviced windows (in stream order) cut out of the retained rows."""
    done = [0] * len(rows)
    out = []
    for t in run["ticks"]:
        got = {f: [] for f in FIELDS[:5]}
        index = []
        for sid in sorted(t["serviced"]):
            c, lo = t["serviced"][sid], done[sid]
            for f in got:
                got[f].append(np.asarray(getattr(rows[sid], f))[lo:lo + c])
            index.extend((sid, lo + j) for j in range(c))
            done[sid] += c
        out.append({"rows": {f: np.concatenate(v) for f, v in got.items()},
                    "index": index, "dispatches": t["counts"][0],
                    "n_rows": t["counts"][1], "flags": t["flags"]})
    return out


def worker_spans(spans_per_tick, shards: int) -> dict:
    """From a traced transport run: per tick (one group of spans) and worker
    lane, the fused ``cuda`` dispatches and the window-vet and change-point
    launches that the worker's own wrappers counted (its ``worker.tick``
    spans), plus host ms by span name summed over the run (driver spans by
    name, worker spans as ``worker:<name>``, round trips by op)."""
    def per_lane():
        return [[0] * shards for _ in spans_per_tick]

    fused, windowvet, changepoint = per_lane(), per_lane(), per_lane()
    host_ms = {}
    for k, recs in enumerate(spans_per_tick):
        for r in recs:
            attrs = dict(r.attrs)
            key = r.name if r.pid == 0 else "worker:" + r.name
            if r.name.startswith("transport."):
                key += ":" + attrs.get("op", "")
            host_ms[key] = host_ms.get(key, 0.0) + r.dur * 1e3
            if r.pid == 0:
                continue
            if r.name == "engine.dispatch":
                require((attrs.get("backend"), attrs.get("kind"))
                        == ("cuda", "fused"),
                        f"transport: a worker dispatched {attrs}")
                fused[k][r.pid - 1] += 1
            elif r.name == "worker.tick":
                windowvet[k][r.pid - 1] += attrs["windowvet_launches"]
                changepoint[k][r.pid - 1] += attrs["changepoint_launches"]
    return {"fused": fused, "windowvet": windowvet,
            "changepoint": changepoint,
            "host_ms": {k: round(v, 3) for k, v in sorted(host_ms.items())}}


def replay_serve_windows(res, shards: int):
    """The transport serve's decode units fed once more, one unit a tick as
    ``serve`` feeds them, to an in-process sharded fleet on the card built
    as ``serve`` builds its own (a fresh engine, so no cached row skips a
    launch): its retained windows and the kernels it launched."""
    import torch
    from repro_torch.engine import VetEngine
    from repro_torch.fleet import ShardedVetMux
    from repro_torch.launch.serve import _SNAPSHOT_HISTORY, _SNAPSHOT_WINDOW
    mux = ShardedVetMux(shards, engine=VetEngine("cuda", buckets=64))
    mux.register("decode", window=_SNAPSHOT_WINDOW, stride=_SNAPSHOT_WINDOW,
                 capacity=4 * _SNAPSHOT_WINDOW, history=_SNAPSHOT_HISTORY)
    zero_counts()
    for u in res.unit_times:
        mux.feed("decode", np.asarray([u]))
        mux.tick()
    torch.cuda.synchronize()
    return mux.stream("decode").collect(), read_counts()


def phase_transport(card: str, base=None, ticks: int = 8,
                    shards: int = 2, streams: int = 4096, cfg=None,
                    device: str = "cuda", batch: int = 4,
                    prompt_len: int = 512, gen_len: int = 331) -> dict:
    """The ``fleet_fused`` fleet in two spawned shard workers on the card
    (``TransportVetMux``), held bit for bit to the in-process sharded fleet
    and under the near-tie contract to the plain fleet; traced once (the
    workers' spans), once more with shard 0's worker killed mid-tick; then
    ``serve`` with ``transport=True, tune=True`` against ``base``, the
    ``serve`` phase's plain run of the same model and sizes (run here when
    that phase did not run)."""
    import torch
    from repro_torch.engine import VetEngine
    from repro_torch.fleet import (AnomalyMonitor, ShardedVetMux,
                                   TransportVetMux)
    from repro_torch.obs import Tracer

    specs = [(int(w), int(w) // 2)
             for w in np.tile([64, 128, 192], -(-streams // 3))[:streams]]
    n = len(specs)
    records, chunks = fleet_records(range(n), lambda sid: specs[sid][0],
                                    ticks)

    def transport(**kw):
        return TransportVetMux(shards, engine=VetEngine("cuda", buckets=64),
                               driver="process", **kw)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    zero_counts()
    t0 = time.perf_counter()
    with transport() as fleet:
        fleet.shard_stats  # one round trip each: both workers are up
        spawn_s = time.perf_counter() - t0
        run_t = drive_sharded(fleet, specs, chunks, ticks)
        rows_t = collected(fleet, n)
        accounts = fleet.accounts
        stats_t = fleet.stats
    driver_launches = read_counts()
    require(driver_launches["windowvet"] == driver_launches["changepoint"]
            == 0, f"transport: the driver launched kernels itself "
                  f"{driver_launches}; they belong in the workers")
    require(stats_t.respawns == stats_t.retries == 0,
            f"transport: a healthy run retried {stats_t}")
    worker_bytes = free0 - min(run_t["free"])

    # The same fleet in process on the same card: bit for bit.
    sharded = ShardedVetMux(shards, engine=VetEngine("cuda", buckets=64))
    run_s = drive_sharded(sharded, specs, chunks, ticks)
    same_run("transport vs in-process sharded", run_t, run_s, rows_t,
             collected(sharded, n))
    # The plain fleet, sharded alike, under the near-tie contract.
    plain = ShardedVetMux(shards, engine=VetEngine("torch", buckets=64,
                                                   fused=True))
    run_p = drive_sharded(plain, specs, chunks, ticks)
    summary = compare_fleets("transport", as_fleet_ticks(run_t, rows_t),
                             as_fleet_ticks(run_p, collected(plain, n)),
                             specs, records, 64)

    # Traced: every worker's spans adopted on its lane.
    tracer = Tracer()
    with transport(tracer=tracer) as fleet:
        run_tr = drive_sharded(fleet, specs, chunks, ticks, tracer=tracer)
    seen = worker_spans(run_tr["spans"], shards)
    require(all(f == [1] * shards for f in seen["fused"]),
            f"transport: fused cuda dispatches per tick and worker "
            f"{seen['fused']}, expected one each")
    require(seen["windowvet"] == seen["fused"],
            f"transport: window-vet launches per tick and worker "
            f"{seen['windowvet']}, expected one per fused dispatch")
    mon = AnomalyMonitor()
    monitored = [int(min(2 * k - 1, mon.ring) >= mon.min_points)
                 for k in range(1, ticks + 1)]
    require(seen["changepoint"] == [[m] * shards for m in monitored],
            f"transport: change-point launches per tick and worker "
            f"{seen['changepoint']}, expected one each on the monitored "
            f"ticks {monitored}")
    same_run("traced transport", run_tr, run_t, [], [])

    # Shard 0's worker killed in the middle of tick 5: checkpoint + journal
    # resume, the same rows, one respawn.
    with transport() as fleet:
        fleet.inject_fault(0, at_tick=5, mode="mid")
        run_f = drive_sharded(fleet, specs, chunks, ticks)
        rows_f = collected(fleet, n)
        acc_f = fleet.accounts
    same_run("transport with a mid-tick kill", run_f, run_t, rows_f, rows_t)
    require([a.respawns for a in acc_f] == [1] + [0] * (shards - 1),
            f"transport: respawns {[a.respawns for a in acc_f]}")
    fleet_part = {
        "streams": n, "shards": shards, "ticks": ticks,
        "spawn_s": spawn_s, "register_s": run_t["setup_s"],
        "tick_ms": [s * 1e3 for s in run_t["secs"]],
        "sharded_tick_ms": [s * 1e3 for s in run_s["secs"]],
        "plain_tick_ms": [s * 1e3 for s in run_p["secs"]],
        "traced_tick_ms": [s * 1e3 for s in run_tr["secs"]],
        "fault_tick_ms": [s * 1e3 for s in run_f["secs"]],
        "roundtrips": [{"calls": a.calls, "elapsed_s": a.elapsed_s,
                        "ms_per_call": a.elapsed_s / a.calls * 1e3,
                        "checkpoints": a.checkpoints} for a in accounts],
        "fault_accounts": [a._asdict() for a in acc_f],
        "host_ms": seen["host_ms"],
        "worker_device_bytes": int(worker_bytes),
        "fused_per_tick": seen["fused"],
        "windowvet_launches": seen["windowvet"],
        "changepoint_launches": seen["changepoint"],
        "vs_torch": summary}
    emit({"phase": "transport.fleet", "card": card, **fleet_part})

    # Serving through the transport, with the tuner.
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    cfg = cfg if cfg is not None else get_config("mamba2-130m")
    kw = dict(batch=batch, prompt_len=prompt_len, gen_len=gen_len,
              device=device, verbose=False)
    reused = base is not None
    if base is None:
        base = serve(cfg, **kw)
    torch.cuda.synchronize()
    zero_counts()
    tracer = Tracer()
    res = serve(cfg, shards=shards, transport=True, tune=True, tracer=tracer,
                **kw)
    torch.cuda.synchronize()
    serve_launches = read_counts()
    require(serve_launches["ssd"] == cfg.num_layers,
            f"transport serve: SSD launches {serve_launches}")
    # In the driver: the prefill's SSD launches and the whole profile's
    # post-run vet (one change-point launch, as in the serve phase); the
    # dashboard's window vets run in the workers.
    require(serve_launches["windowvet"] == 0
            and serve_launches["changepoint"] == 1,
            f"transport serve: the driver launched {serve_launches}")
    require(np.array_equal(res.tokens, base.tokens),
            "transport serve: tokens differ from plain serve")
    require(res.windows is not None
            and res.windows.workers == base.windows.workers,
            "transport serve: window count differs")
    require(res.mux.respawns == 0, f"transport serve: {res.mux}")
    # The workers' windows, bit for bit, against the same decode units
    # vetted in process on the same card; their launches against the
    # replay's (one window-vet launch per fused dispatch).
    ref_windows, ref_launches = replay_serve_windows(res, shards)
    require(all(np.array_equal(getattr(res.windows, f),
                               getattr(ref_windows, f)) for f in FIELDS),
            "transport serve: the workers' windows differ from the same "
            "units vetted in process")
    lanes = worker_spans([tracer.records], shards)
    dispatched = sum(lanes["fused"][0])
    require(lanes["windowvet"] == lanes["fused"]
            and dispatched == res.mux.dispatches
            == ref_launches["windowvet"] > 0,
            f"transport serve: worker fused dispatches {lanes['fused']}, "
            f"window-vet launches {lanes['windowvet']}, mux dispatches "
            f"{res.mux.dispatches}, in-process replay {ref_launches}")
    require(sum(lanes["changepoint"][0]) == ref_launches["changepoint"],
            f"transport serve: worker change-point launches "
            f"{lanes['changepoint']}, in-process replay {ref_launches}")
    best = res.tuner["best"]
    require(best.get("tick_budget") in (8, 16, 32, 64),
            f"transport serve: tuner report {res.tuner}")

    def decode_tps(r):  # decode steps alone: units of 5 steps each
        return batch * 5 * r.unit_times.size / float(r.unit_times.sum())

    served = {"arch": cfg.name, "batch": batch, "prompt_len": prompt_len,
              "gen_len": gen_len, "tokens_per_s": res.tokens_per_s,
              "plain_tokens_per_s": base.tokens_per_s,
              "decode_tokens_per_s": decode_tps(res),
              "plain_decode_tokens_per_s": decode_tps(base),
              "plain_from": "serve phase" if reused else "this phase",
              "windows": int(res.windows.workers),
              "mux_ticks": res.mux.ticks, "respawns": res.mux.respawns,
              "worker_windowvet_launches": lanes["windowvet"][0],
              "worker_changepoint_launches": lanes["changepoint"][0],
              "tuner": {k: res.tuner[k] for k in
                        ("best", "best_y", "current", "rounds", "rollbacks",
                         "converged", "samples")}}
    launches = {"windowvet": sum(map(sum, seen["windowvet"]))
                + sum(lanes["windowvet"][0]),
                "changepoint": sum(map(sum, seen["changepoint"]))
                + sum(lanes["changepoint"][0]),
                "ssd": serve_launches["ssd"], "flash_attention": 0}
    return {"phase": "transport", "card": card, "fleet": fleet_part,
            "serve": served, "driver_launches": driver_launches,
            "launches": launches}


# ---------------------------------------------------------------- analysis
def tail_part(m: np.ndarray, res, cpu_rows: int = 16,
              device: str = "cuda") -> dict:
    """Fig. 6, 8, 9 and 14 on the job: ``tail_report`` of every task on the
    card (the first ``cpu_rows`` held to the same code on the CPU),
    ``bucketize`` of task 0, ``pearson`` of per-task vet against PR and
    ``ks_2samp`` of the two halves' vets."""
    import torch
    from repro_torch.core import bucketize, ks_2samp, pearson, tail_report

    # The reference's x64-off jnp.asarray: f64 rounded once to f32.
    rows = torch.from_numpy(m.astype(np.float32)).to(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reports = [tail_report(rows[i], device=device) for i in range(len(m))]
    torch.cuda.synchronize()
    tail_s = time.perf_counter() - t0
    traced = device_time(lambda: tail_report(rows[0], device=device))
    alphas = np.array([r.alpha for r in reports])
    require(np.all(np.isfinite(alphas)) and np.all(alphas > 0),
            "analysis: non-finite or non-positive Hill alpha")
    bitwise, worst = 0, 0.0
    for i in range(cpu_rows):
        got, want = reports[i], tail_report(m[i], device="cpu")
        require(got.heavy == want.heavy, f"analysis: task {i} heavy differs")
        pairs = [(got.alpha, want.alpha), (got.emplot_slope,
                                           want.emplot_slope),
                 *zip(got.alpha_stable_band, want.alpha_stable_band)]
        for a, b in pairs:
            rel = abs(a - b) / max(abs(b), 1e-30)
            require(rel <= RTOL, f"analysis: task {i} tail_report off by "
                                 f"{rel:.3g} (rel) from the CPU")
            worst = max(worst, rel)
        bitwise += int(got.alpha == want.alpha)
    b = bucketize(rows[0], 1000, device=device)
    total = float(m[0].sum())
    require(tuple(b.shape) == (1000,) and abs(float(b.double().sum()) - total)
            <= 1e-5 * total, "analysis: bucketize loses the task's total")
    r_card = pearson(res.vet, res.pr, device=device)
    r_cpu = pearson(res.vet, res.pr, device="cpu")
    require(abs(r_card - r_cpu) <= RTOL * max(abs(r_cpu), 1e-6),
            f"analysis: pearson {r_card} on the card, {r_cpu} on the CPU")
    half = len(res.vet) // 2
    ks = ks_2samp(res.vet[:half], res.vet[half:])
    require(0.0 <= ks.statistic <= 1.0 and 0.0 <= ks.pvalue <= 1.0,
            f"analysis: ks_2samp out of range: {ks}")
    return {"tasks": len(m), "records_per_task": int(m.shape[1]),
            "tail_report_s": tail_s, "tail_report_traced": traced,
            "alpha_median": float(np.median(alphas)),
            "alpha_range": [float(alphas.min()), float(alphas.max())],
            "heavy_tasks": int(sum(r.heavy for r in reports)),
            "cpu_rows": cpu_rows, "cpu_alphas_bitwise": bitwise,
            "cpu_max_rel_err": worst,
            "bucket_sum_rel_err": abs(float(b.double().sum()) - total) / total,
            "pearson_vet_pr": r_card, "ks_d": ks.statistic,
            "ks_p": ks.pvalue}


def expected_controller_launches(tick: int, window: int, monitor) -> dict:
    """Kernel launches of the ``tick``-th feed + ``decide()`` (1-indexed)
    when every worker gets ``window // 2`` records a tick (stride
    ``window // 2``): one fused window-vet launch once new windows complete;
    one change-point launch for the warm-up ``vet_many`` (one buffer length)
    while no window is complete but 32 records are; one for the monitor
    when the rings gained a window and hold ``min_points`` of them."""
    stride = window // 2

    def windows(k):
        recs = k * stride
        return 0 if recs < window else (recs - window) // stride + 1

    new = windows(tick) - windows(tick - 1)
    warm = int(windows(tick) == 0 and tick * stride >= 32)
    due = int(new > 0 and min(windows(tick), monitor.ring)
              >= monitor.min_points)
    return {"windowvet": int(new > 0), "changepoint": warm + due}


def drive_controller(ctl, scenario, count: bool = False):
    """Feed each tick's chunks to their workers, then ``decide()``; returns
    the decisions, ms per ``decide()``, the newest row of every worker after
    each tick (``None`` while warming up) and, with ``count``, each tick's
    kernel launches (feed and decide) and its KS confirmations (calls, ms)."""
    import torch
    from repro_torch.sched import straggler
    workers = len(scenario.specs)
    decisions, ms, newest, launches = [], [], [], []
    ks_2samp = straggler.ks_2samp
    ks = [0, 0.0]  # this tick's ks_2samp calls and seconds

    def timed_ks(a, b):
        t0 = time.perf_counter()
        out = ks_2samp(a, b)
        ks[0] += 1
        ks[1] += time.perf_counter() - t0
        return out

    for event in scenario.events:
        if count:
            zero_counts()
            ks[:] = [0, 0.0]
        for sid, chunk in event.chunks.items():
            ctl.feed(int(sid[1:]), chunk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        straggler.ks_2samp = timed_ks if count else ks_2samp
        try:
            decisions.append(ctl.decide())
        finally:
            straggler.ks_2samp = ks_2samp
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if count:
            launches.append({**read_counts(), "ks_calls": ks[0],
                             "ks_ms": ks[1] * 1e3})
        rows = [ctl.mux.stream(i).collect() for i in range(workers)]
        newest.append(None if rows[0] is None else {
            f: np.array([np.asarray(getattr(r, f))[-1] for r in rows])
            for f in ("vet", "ei", "oc", "pr", "t")})
    return decisions, ms, newest, launches


def controller_part(workers: int = 1024, window: int = 200, ticks: int = 8,
                    frac: float = 0.03) -> dict:
    """§5.5 at cluster scale: ``VetController`` over 1024 map slots (64
    nodes x 16) on its default ``cuda`` engine, fed
    ``skewed_stragglers``; held to the plain fused fleet and to
    ``shards=2``."""
    from repro_torch.engine import VetEngine
    from repro_torch.fleet.scenarios import skewed_stragglers
    from repro_torch.sched import VetController

    sc = skewed_stragglers(n_workers=workers, window=window, n_ticks=ticks,
                           straggler_frac=frac, seed=0)
    ctl = VetController(workers, window_records=window)
    require(ctl.engine.backend == "cuda" and ctl.engine.fused,
            "analysis: the controller's default engine is not fused cuda")
    got, ms, rows, launches = drive_controller(ctl, sc, count=True)
    for k, have in enumerate(launches, 1):
        want = expected_controller_launches(k, window, ctl.mux.monitor)
        require({n: have[n] for n in want} == want
                and have["ssd"] == have["flash_attention"] == 0,
                f"analysis: controller tick {k} launched {have}, want {want}")
    plain = VetController(workers, window_records=window,
                          engine=VetEngine("torch", buckets=64, fused=True))
    ref, plain_ms, ref_rows, _ = drive_controller(plain, sc)
    stride = window // 2
    records = {}

    def records_of(i):
        if i not in records:
            records[i] = np.concatenate([e.chunks[f"w{i:04d}"]
                                         for e in sc.events])
        return records[i]

    summaries = []
    for k, (a, b) in enumerate(zip(got, ref), 1):
        require((a.target_workers, a.stragglers, a.reason)
                == (b.target_workers, b.stragglers, b.reason),
                f"analysis: decision {k} differs from the plain fleet: "
                f"{a.reason!r} {a.stragglers} vs {b.reason!r} {b.stragglers}")
        if rows[k - 1] is None:  # warm-up: vet_many over the buffers
            va = np.array([a.worker_vets[i] for i in range(workers)])
            vb = np.array([b.worker_vets[i] for i in range(workers)])
            rel = float(np.max(np.abs(va - vb) / np.abs(vb)))
            require(rel <= RTOL, f"analysis: warm-up vets off by {rel:.3g}")
            continue
        lo = (k * stride - window) // stride * stride  # the newest window

        def times_of(i, lo=lo):
            return records_of(i)[lo:lo + window]

        summaries.append(hold(rows[k - 1], ref_rows[k - 1], times_of, 64,
                              f"analysis controller tick {k}"))
    sharded = VetController(workers, window_records=window, shards=2)
    two, _, _, _ = drive_controller(sharded, sc)
    bitwise = []
    for k, (a, b) in enumerate(zip(got, two), 1):
        require((a.target_workers, a.stragglers, a.reason)
                == (b.target_workers, b.stragglers, b.reason),
                f"analysis: shards=2 decision {k} differs from shards=1")
        bitwise.append(a.worker_vets == b.worker_vets)
    injected = set(range(max(1, int(workers * frac))))
    flagged = set().union(*(d.stragglers for d in got))
    hit = len(flagged & injected)
    return {"workers": workers, "window_records": window, "ticks": ticks,
            "injected_stragglers": len(injected),
            "flagged_stragglers": len(flagged),
            "recall": hit / len(injected),
            "precision": hit / len(flagged) if flagged else None,
            "decide_ms": ms, "plain_decide_ms": plain_ms,
            "vet_job": [d.vet_job for d in got],
            "reasons": [d.reason for d in got],
            "launches_per_tick": launches,
            "vs_torch": {"cut_flips": sum(s["cut_flips"] for s in summaries),
                         "max_abs_err_vet": max(s["max_abs_err_vet"]
                                                for s in summaries)},
            "shards2_vets_bitwise_per_tick": bitwise,
            "launches": {n: sum(t[n] for t in launches)
                         for n in read_counts()}}


def online_part(x: np.ndarray, window: int = 512, chunk: int = 1024) -> dict:
    """``OnlineVet`` on its default ``cuda`` engine over one 65,536-record
    task fed in chunks: the bucketed gather path, one change-point launch
    per engine dispatch; held to the plain engine and to ``history=8``."""
    import torch
    from repro_torch.core import OnlineVet
    from repro_torch.engine import VetEngine

    def feed(ov):
        snaps = []
        for lo in range(0, x.size, chunk):
            snaps.extend(ov.feed(x[lo:lo + chunk]))
        torch.cuda.synchronize()
        return snaps

    ov = OnlineVet(window=window)
    require(ov.engine.backend == "cuda", "analysis: OnlineVet's default "
                                         "engine is not cuda")
    d0 = ov.engine.dispatches
    zero_counts()
    t0 = time.perf_counter()
    snaps = feed(ov)
    feed_s = time.perf_counter() - t0
    launches = read_counts()
    dispatches = ov.engine.dispatches - d0
    stride = window // 2
    want = (x.size - window) // stride + 1
    require(len(snaps) == want, f"analysis: {len(snaps)} snapshots, "
                                f"want {want}")
    require(launches["changepoint"] == dispatches > 0
            and launches["windowvet"] == 0,
            f"analysis: OnlineVet launched {launches} over {dispatches} "
            f"dispatches")
    plain = OnlineVet(window=window, engine=VetEngine("torch", buckets=64))
    ref = feed(plain)
    require(len(ref) == len(snaps), "analysis: the plain engine emits "
                                    f"{len(ref)} snapshots")
    vs_torch = hold(as_rows(ov.stream.collect()),
                    as_rows(plain.stream.collect()),
                    lambda i: x[i * stride:i * stride + window], 64,
                    "analysis online vs torch")
    capped = OnlineVet(window=window, history=8,
                       engine=VetEngine("cuda", buckets=64))
    require(feed(capped) == snaps, "analysis: history=8 changes the "
                                   "snapshots")
    return {"records": int(x.size), "window": window, "chunk": chunk,
            "snapshots": len(snaps), "dispatches": dispatches,
            "feed_s": feed_s, "smoothed_vet": snaps[-1].smoothed_vet,
            "vs_torch": vs_torch, "launches": launches}


def contention_part(records: int = 300, unit: int = 5) -> dict:
    """Paper Table 2 on this host: W concurrent record-processing tasks,
    each vetted on the card.  Wall-clock numbers: printed, never held."""
    from repro_torch.engine import VetEngine
    from repro_torch.profiling import run_contended_job

    eng = VetEngine("cuda", buckets=64)
    out, launches = [], {}
    for w in (1, 2, 4, 2 * (os.cpu_count() or 1)):
        tasks = run_contended_job(w, records, unit=unit)
        require(len(tasks) == w and all(t.shape == (records // unit,)
                                        for t in tasks),
                f"analysis: contention W={w} returned the wrong shapes")
        zero_counts()
        jr = eng.vet_many(tasks)
        for k, v in read_counts().items():
            launches[k] = launches.get(k, 0) + v
        require(np.all(jr.vet >= 1.0 - 1e-6), f"analysis: W={w} vet below 1")
        out.append({"workers": w, "pr_mean_s": float(jr.pr.mean()),
                    "ei_mean_s": float(jr.ei.mean()),
                    "vet_job": jr.vet_job})
    require(launches["changepoint"] == len(out),
            f"analysis: contention launched {launches}")
    return {"records_per_task": records, "unit": unit, "table": out,
            "launches": launches}


def phase_analysis(card: str, job=None, tasks: int = 1024,
                   records: int = 65536) -> dict:
    """The paper's analysis layer on the card: tail and stats over the
    job (``job``: the ``job`` phase's rows and ``cuda`` result, drawn and
    vetted here when that phase did not run), the straggler controller,
    online vet and the contention harness."""
    from repro_torch.engine import VetEngine

    t0 = time.perf_counter()
    if job is None:
        m = sim_rows(tasks, records)
        job = (m, VetEngine("cuda").vet_batch(m))
    m, res = job
    out = {"phase": "analysis", "card": card}
    for name, part in (("tail", lambda: tail_part(m, res)),
                       ("controller", controller_part),
                       ("online", lambda: online_part(m[0])),
                       ("contention", contention_part)):
        t1 = time.perf_counter()
        out[name] = part()
        out[name]["seconds"] = time.perf_counter() - t1
    out["launches"] = {k: sum(out[p]["launches"][k] for p in
                              ("controller", "online", "contention"))
                       for k in out["online"]["launches"]}
    out["seconds"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------------------- train
RESUME_RTOL = 1e-4  # tests/test_substrates.py TestEndToEnd (the reference's)
TRAIN_LOSS_RTOL = 1e-5  # one step's loss, kernel path against plain=True
REDUCED_RTOL = 1e-4  # reduced configs' losses, card against the CPU


def vet_one_launches(n: int, buckets, omega: int = 3) -> int:
    """Change-point launches of one ``cuda`` engine ``vet_one`` over ``n``
    records: the curve holds ``buckets`` points from ``4 * buckets``
    records on, else ``n``, and the kernel runs when it holds ``2 * omega``
    (``core.vet._cut_and_slope``)."""
    points = buckets if buckets is not None and n >= 4 * buckets else n
    return int(points >= 2 * omega)


def report_launches(units: int) -> int:
    """Change-point launches of ``train``'s end-of-run report over ``units``
    unit records: none under 16 (no report), else one ``vet_one`` at
    ``min(64, units // 4)`` buckets; its controller's ``decide()`` vets
    nothing under 32 records ("insufficient data")."""
    require(units < 32, "report_launches: derive the controller's launches")
    return vet_one_launches(units, min(64, units // 4)) if units >= 16 else 0


def counted(fn):
    """``fn()`` with the launch counters zeroed just before it and read
    just after (synchronised): (its result, the counts)."""
    import torch
    torch.cuda.synchronize()
    zero_counts()
    res = fn()
    torch.cuda.synchronize()
    return res, read_counts()


def train_batch(cfg, batch: int, seq_len: int, dev):
    """The trainer's first batch (seed 0, step 0) on ``dev``, frontend
    embeddings included, as ``launch.train`` builds its pipeline."""
    import torch
    from repro_torch.data import SyntheticTokenPipeline
    pipe = SyntheticTokenPipeline(cfg.vocab_size, batch, seq_len,
                                  d_model=cfg.d_model, frontend=cfg.frontend,
                                  frontend_seq=max(cfg.frontend_seq, 0))
    return {k: torch.from_numpy(v).to(dev)
            for k, v in pipe.batch_at(0).items()}


def gradient_check(cfg, params, batch, q_chunk: int = 1024,
                   spread_on_cpu: bool = False, unread=()) -> dict:
    """One step's loss and gradients through the kernels and through
    ``plain=True`` on the same weights and batch: the losses to 1e-5
    relative, every leaf's kernel-path gradient present and not all zero,
    and within ``LOGIT_TOL`` of that leaf's largest plain gradient.  The
    leaves named in ``unread`` are the exception: the loss never reads
    them (an audio model's ``embed``), and their gradient must be zero on
    both paths, as ``jax.grad`` gives it.  Reports the kernel path's MoE
    aux loss (0 without MoE layers).

    ``spread_on_cpu`` also takes the plain path's gradients on the CPU: two
    f32 orders of the same plain path, whose difference is the f32 noise
    the model's depth amplifies (full mamba2-130m on an H100: up to 3.1e-3
    of a leaf's largest, twice the kernel path's).  A leaf's tolerance is
    then the larger
    of ``LOGIT_TOL`` and that spread: the kernel path must lie as close to
    the plain path on the card as the plain path's own two orders lie to
    each other."""
    import torch
    from repro_torch.models import loss_fn
    from repro_torch.tree import leaves_with_paths, tree_map
    dev = next(iter(batch.values())).device
    runs = [("kernel", dev, False), ("plain", dev, True)]
    if spread_on_cpu:
        runs.append(("plain_cpu", torch.device("cpu"), True))
    got = {}
    for name, where, plain in runs:
        live = tree_map(lambda t: t.detach().to(where).requires_grad_(),
                        params)
        named = leaves_with_paths(live)
        b = {k: v.to(where) for k, v in batch.items()}
        loss, parts = loss_fn(cfg, live, b, q_chunk=q_chunk, plain=plain)
        grads = torch.autograd.grad(loss, [t for _, t in named],
                                    allow_unused=True)
        got[name] = (loss.item(), {n: None if g is None else g.to(dev)
                                   for (n, _), g in zip(named, grads)},
                     float(parts["aux"].detach()))
        del live, named, loss, grads
    (lk, gk, aux), (lp, gp, _) = got["kernel"], got["plain"]
    require(np.isfinite(lk) and abs(lk - lp) <= TRAIN_LOSS_RTOL * abs(lp),
            f"train: loss through the kernels {lk} against plain {lp}")
    for name in unread:
        for run in got.values():
            g = run[1].pop(name)
            require(g is None or not bool(g.any()),
                    f"train: {name}, which the loss never reads, has a "
                    f"gradient")
    worst, spread = (0.0, ""), (0.0, "")
    for name, g in gp.items():
        k = gk.get(name)
        require(k is not None and bool(k.abs().max() > 0),
                f"train: no gradient reaches {name}")
        scale = float(g.abs().max())
        rel = float((k - g).abs().max()) / scale
        tol = LOGIT_TOL
        if spread_on_cpu:
            own = float((got["plain_cpu"][1][name] - g).abs().max()) / scale
            spread = max(spread, (own, name))
            tol = max(tol, own)
        require(rel <= tol, f"train: gradient of {name} off by {rel:.3g} "
                            f"of its largest (tolerance {tol:.3g})")
        worst = max(worst, (rel, name))
    out = {"leaves": len(gp), "unread_leaves": list(unread),
           "loss_kernel": lk, "loss_plain": lp, "aux_kernel": aux,
           "loss_rel_err": abs(lk - lp) / abs(lp),
           "worst_grad_rel_err": worst[0], "worst_leaf": worst[1]}
    if spread_on_cpu:
        out["plain_card_vs_cpu_worst"] = spread[0]
        out["plain_card_vs_cpu_leaf"] = spread[1]
        out["loss_plain_cpu"] = got["plain_cpu"][0]
    return out


def steady_steps(cfg, params, batch, steps: int, warmup: int = 2,
                 q_chunk: int = 1024, trace: bool = False) -> dict:
    """ms per train step over ``steps`` steps after ``warmup`` (host clock
    over a synchronised run), and optionally one more step traced."""
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import init_opt_state
    step = make_train_step(cfg, q_chunk=q_chunk)
    opt = init_opt_state(params)
    for _ in range(warmup):
        params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt, m = step(params, opt, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    tokens = batch["tokens"].numel()
    out = {"ms_per_step": ms, "tokens_per_s": tokens / ms * 1e3,
           "steps": steps}
    if trace:
        out["traced_step"] = device_time(
            lambda: step(params, opt, batch), top=10,
            ranges=("ssd_scan.plain_backward",
                    "flash_attention.plain_backward"),
            match=("ssd_", "flash_"))
    return out


def train_mamba_part(dev, steps: int = 96, batch: int = 8,
                     seq_len: int = 128, ckpt_every: int = 32,
                     fail_at: int = 50, unit: int = 5) -> dict:
    """Full mamba2-130m trained ``steps`` steps with checkpoints, then cut
    at ``fail_at`` and resumed; its gradients against the plain path; its
    steady step time and one traced step."""
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import SimulatedFailure, train
    from repro_torch.models import init_params
    from repro_torch.tree import tree_map

    cfg = get_config("mamba2-130m")
    layers = cfg.num_layers
    kw = dict(steps=steps, batch=batch, seq_len=seq_len,
              ckpt_every=ckpt_every, record_unit=unit, verbose=False,
              device=dev)
    with tempfile.TemporaryDirectory() as d:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        full, c_full = counted(lambda: train(cfg, ckpt_dir=f"{d}/full", **kw))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()

        def cut():
            try:
                train(cfg, ckpt_dir=f"{d}/cut", fail_at_step=fail_at, **kw)
            except SimulatedFailure:
                return True
            return False

        failed, c_fail = counted(cut)
        res, c_res = counted(lambda: train(cfg, ckpt_dir=f"{d}/cut", **kw))
    require(failed, "train: the injected failure did not fire")
    resumed_from = fail_at // ckpt_every * ckpt_every
    require(res.resumed_from == resumed_from and res.final_step == steps - 1,
            f"train: resumed from {res.resumed_from}, ended at "
            f"{res.final_step}")
    want = np.asarray(full.losses[resumed_from + 1:])
    got = np.asarray(res.losses)
    require(got.shape == want.shape and np.all(np.isfinite(got)),
            "train: resumed losses")
    resume_err = float(np.max(np.abs(got - want) / np.abs(want)))
    require(resume_err <= RESUME_RTOL, f"train: resumed losses off the "
                                       f"uninterrupted run's by {resume_err}")
    # The synthetic tokens are uniform, so the loss falls from above
    # ln(vocab) towards it: the last steps' mean below the first steps'.
    losses = np.asarray(full.losses)
    require(np.all(np.isfinite(losses))
            and losses[-8:].mean() < losses[:8].mean(),
            f"train: losses {losses[:8].mean()} -> {losses[-8:].mean()}")
    units = steps // unit
    require(full.vet is not None and np.isfinite(full.vet)
            and full.vet >= 1.0 - 1e-6, f"train: vet {full.vet}")
    require(full.controller_decision.reason == "insufficient data",
            f"train: controller {full.controller_decision.reason}")
    resumed_units = (steps - resumed_from - 1) // unit
    expect = {
        "full": {"ssd": 2 * layers * steps, "flash_attention": 0,
                 "changepoint": report_launches(units), "windowvet": 0},
        "cut": {"ssd": 2 * layers * (fail_at + 1), "flash_attention": 0,
                "changepoint": 0, "windowvet": 0},
        "resumed": {"ssd": 2 * layers * (steps - resumed_from - 1),
                    "flash_attention": 0,
                    "changepoint": report_launches(resumed_units),
                    "windowvet": 0},
    }
    seen = {"full": c_full, "cut": c_fail, "resumed": c_res}
    require(seen == expect, f"train: launches {seen}, derived {expect}")

    params = tree_map(lambda t: t.to(dev),
                      init_params(cfg, torch.Generator().manual_seed(0)))
    b = train_batch(cfg, batch, seq_len, dev)
    grads = gradient_check(cfg, params, b, spread_on_cpu=True)
    steady = steady_steps(cfg, params, b, steps=10, trace=True)
    del params
    launches = {k: c_full[k] + c_fail[k] + c_res[k] for k in c_full}
    return {"arch": cfg.name, "params": cfg.param_count(), "steps": steps,
            "batch": batch, "seq_len": seq_len, "remat": "full",
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "wall_s": wall, "ms_per_step": full.phase_totals["step"] / steps
            * 1e3, "tokens_per_s": batch * seq_len * steps
            / full.phase_totals["step"], "phase_totals_s": full.phase_totals,
            "peak_device_bytes": int(peak), "vet": full.vet, "ei": full.ei,
            "pr": full.pr, "unit_records": units,
            "controller": full.controller_decision.reason,
            "resumed_from": res.resumed_from,
            "resume_max_rel_err": resume_err,
            "ssd_launches_per_step": c_full["ssd"] / steps,
            "launches_by_run": seen, "launches": launches,
            "gradients": grads, "steady": steady}


def train_danube_part(dev, layers: int = 4, steps: int = 4, batch: int = 2,
                      seq_len: int = 2048, q_chunk: int = 1024) -> dict:
    """h2o-danube-3-4b at full width, ``layers`` of its 24 layers, trained
    through the flash kernel with weights drawn on the card; its gradients
    against the plain path; its steady step time."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config("h2o-danube-3-4b"),
                              num_layers=layers)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, counts = counted(lambda: train(
        cfg, steps=steps, batch=batch, seq_len=seq_len, q_chunk=q_chunk,
        params=params, verbose=False, device=dev))
    peak = torch.cuda.max_memory_allocated()
    expect = {"ssd": 0, "flash_attention": 2 * layers * steps,
              "changepoint": report_launches(steps // 5), "windowvet": 0}
    require(counts == expect, f"train: danube launches {counts}, derived "
                              f"{expect}")
    losses = np.asarray(res.losses)
    require(np.all(np.isfinite(losses)), f"train: danube losses {losses}")
    b = train_batch(cfg, batch, seq_len, dev)
    grads = gradient_check(cfg, params, b, q_chunk=q_chunk)
    torch.cuda.empty_cache()
    steady = steady_steps(cfg, params, b, steps=2, warmup=1, q_chunk=q_chunk)
    del params
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": layers, "cut": "num_layers 24 -> "
            f"{layers}", "params": cfg.param_count(), "steps": steps,
            "batch": batch, "seq_len": seq_len, "q_chunk": q_chunk,
            "weights_drawn_on": "card", "losses": res.losses,
            "ms_per_step": res.phase_totals["step"] / steps * 1e3,
            "peak_device_bytes": int(peak),
            "flash_launches_per_step": counts["flash_attention"] / steps,
            "launches": counts, "gradients": grads, "steady": steady}


def train_moe_part(dev, layers: int = 2, steps: int = 4, batch: int = 2,
                   seq_len: int = 2048, q_chunk: int = 1024) -> dict:
    """deepseek-moe-16b at full width on ``layers`` of its 28 layers (the
    dense first layer, then MoE layers), trained through the flash kernel
    with weights drawn on the card; its aux loss; its gradients against
    the plain path, every leaf reached (the router, the stacked experts,
    the shared expert)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                              num_layers=layers)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, counts = counted(lambda: train(
        cfg, steps=steps, batch=batch, seq_len=seq_len, q_chunk=q_chunk,
        params=params, verbose=False, device=dev))
    peak = torch.cuda.max_memory_allocated()
    expect = {"ssd": 0, "flash_attention": 2 * layers * steps,
              "changepoint": report_launches(steps // 5), "windowvet": 0}
    require(counts == expect, f"train: moe launches {counts}, derived "
                              f"{expect}")
    losses = np.asarray(res.losses)
    require(np.all(np.isfinite(losses)), f"train: moe losses {losses}")
    grads = gradient_check(cfg, params, train_batch(cfg, batch, seq_len, dev),
                           q_chunk=q_chunk)
    require(np.isfinite(grads["aux_kernel"]) and grads["aux_kernel"] > 0,
            f"train: moe aux loss {grads['aux_kernel']}")
    del params
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": layers, "cut": "num_layers 28 -> "
            f"{layers}", "params": cfg.param_count(), "steps": steps,
            "batch": batch, "seq_len": seq_len, "q_chunk": q_chunk,
            "weights_drawn_on": "card", "losses": res.losses,
            "ms_per_step": res.phase_totals["step"] / steps * 1e3,
            "peak_device_bytes": int(peak),
            "flash_launches_per_step": counts["flash_attention"] / steps,
            "launches": counts, "gradients": grads}


def train_hybrid_part(dev, layers: int = 7, steps: int = 4, batch: int = 2,
                      seq_len: int = 2048, q_chunk: int = 1024) -> dict:
    """zamba2-7b at full width on ``layers`` of its 81 layers: the shared
    blocks apply before layers 0 and 6, so both take gradients (summed over
    their applications).  Trained through the SSD kernel (twice per layer
    and step) and the flash kernel (twice per application and step) with
    weights drawn on the card; every gradient leaf of the kernel path held
    to the plain path within max(1e-3, the plain path's own card-to-CPU
    spread) on a batch of 1 x 1024 (the CPU's share of the check)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config("zamba2-7b"), num_layers=layers)
    apps = -(-layers // cfg.hybrid_attn_every)
    require(apps == cfg.n_shared_attn_blocks == 2,
            f"train: {layers} hybrid layers apply {apps} shared blocks")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, counts = counted(lambda: train(
        cfg, steps=steps, batch=batch, seq_len=seq_len, q_chunk=q_chunk,
        params=params, verbose=False, device=dev))
    peak = torch.cuda.max_memory_allocated()
    expect = {"ssd": 2 * layers * steps, "flash_attention": 2 * apps * steps,
              "changepoint": report_launches(steps // 5), "windowvet": 0}
    require(counts == expect, f"train: hybrid launches {counts}, derived "
                              f"{expect}")
    losses = np.asarray(res.losses)
    require(np.all(np.isfinite(losses)), f"train: hybrid losses {losses}")
    grads = gradient_check(cfg, params, train_batch(cfg, 1, 1024, dev),
                           q_chunk=q_chunk, spread_on_cpu=True)
    del params
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": layers, "cut": "num_layers 81 -> "
            f"{layers}", "shared_attn_applications": apps,
            "params": cfg.param_count(), "steps": steps, "batch": batch,
            "seq_len": seq_len, "q_chunk": q_chunk,
            "weights_drawn_on": "card", "losses": res.losses,
            "ms_per_step": res.phase_totals["step"] / steps * 1e3,
            "peak_device_bytes": int(peak), "launches": counts,
            "gradient_batch": [1, 1024], "gradients": grads}


def train_mla_part(dev, layers: int = 2, steps: int = 4, batch: int = 2,
                   seq_len: int = 2048, q_chunk: int = 1024) -> dict:
    """deepseek-v2-lite-16b at full width on ``layers`` of its 27 layers
    (the dense first layer and one MoE layer), trained through the flash
    kernel's wide entry (MLA's Q and K of 192, V of 128) and its autograd
    route, weights drawn on the card; its aux loss; its gradients
    against the plain path, every leaf reached."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              num_layers=layers)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, counts = counted(lambda: train(
        cfg, steps=steps, batch=batch, seq_len=seq_len, q_chunk=q_chunk,
        params=params, verbose=False, device=dev))
    wide = wide_count()
    peak = torch.cuda.max_memory_allocated()
    expect = {"ssd": 0, "flash_attention": 2 * layers * steps,
              "changepoint": report_launches(steps // 5), "windowvet": 0}
    require(counts == expect and wide == 2 * layers * steps,
            f"train: mla launches {counts} ({wide} wide), derived {expect}, "
            f"all wide")
    losses = np.asarray(res.losses)
    require(np.all(np.isfinite(losses)), f"train: mla losses {losses}")
    grads = gradient_check(cfg, params, train_batch(cfg, batch, seq_len, dev),
                           q_chunk=q_chunk)
    require(np.isfinite(grads["aux_kernel"]) and grads["aux_kernel"] > 0,
            f"train: mla aux loss {grads['aux_kernel']}")
    del params
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": layers, "cut": "num_layers 27 -> "
            f"{layers}", "params": cfg.param_count(), "steps": steps,
            "batch": batch, "seq_len": seq_len, "q_chunk": q_chunk,
            "weights_drawn_on": "card", "losses": res.losses,
            "ms_per_step": res.phase_totals["step"] / steps * 1e3,
            "peak_device_bytes": int(peak), "launches": counts,
            "wide_launches": wide, "gradients": grads}


def train_reduced_part(dev, steps: int = 4) -> dict:
    """The reduced configs trained on the card and on the CPU from the same
    seeded weights and batches: losses within ``REDUCED_RTOL``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    out = {}
    for arch in ("mamba2-130m", "h2o-danube-3-4b", "deepseek-moe-16b",
                 "internvl2-26b", "hubert-xlarge", "zamba2-7b",
                 "deepseek-v2-lite-16b"):
        cfg = get_config(arch).reduced()
        kw = dict(steps=steps, batch=2, seq_len=64, verbose=False)
        cpu = np.asarray(train(cfg, device="cpu", **kw).losses)
        card = np.asarray(train(cfg, device=dev, **kw).losses)
        err = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
        require(err <= REDUCED_RTOL, f"train: reduced {arch} losses card vs "
                                     f"cpu off by {err}")
        out[arch] = {"max_rel_err": err, "losses": card.tolist()}
    return out


def train_tune_part(dev, steps: int = 12) -> dict:
    """``sched.autotune.tune`` on full mamba2-130m: four candidates, each
    with its vet, sorted by step time; launches held to the derived."""
    from repro_torch.configs import get_config
    from repro_torch.sched import tune
    cfg = get_config("mamba2-130m")
    n_micro, q_chunk = (1, 2), (32, 64)
    cands, counts = counted(lambda: tune(
        cfg, batch=8, seq_len=64, steps_per_candidate=steps,
        n_micro_options=n_micro, q_chunk_options=q_chunk, verbose=False,
        device=dev))
    require(len(cands) == len(n_micro) * len(q_chunk), "tune: candidates")
    mean = [c.mean_step_s for c in cands]
    require(mean == sorted(mean), "tune: not sorted by step time")
    require(all(np.isfinite(c.vet) and c.vet >= 1.0 - 1e-6 for c in cands),
            "tune: a candidate without a vet")
    times = steps - 2  # the warm-up steps dropped
    expect = {"ssd": sum(2 * cfg.num_layers * steps * c.knobs["n_micro"]
                         for c in cands),
              "flash_attention": 0, "windowvet": 0,
              "changepoint": len(cands) * vet_one_launches(
                  times, min(64, max(8, times // 4)))}
    require(counts == expect, f"tune: launches {counts}, derived {expect}")
    return {"batch": 8, "seq_len": 64, "steps_per_candidate": steps,
            "candidates": [{**c.knobs, "ms_per_step": c.mean_step_s * 1e3,
                            "vet": c.vet, "ei": c.ei} for c in cands],
            "launches": counts}


def phase_train(card: str, device: str = "cuda") -> dict:
    """Training on the card: full mamba2-130m (train, cut and resume,
    gradients, steady steps, a traced step), the 4-layer full-width
    h2o-danube-3-4b and the 2-layer full-width deepseek-moe-16b through the
    flash kernel, the 7-layer full-width zamba2-7b through both kernels,
    the 2-layer full-width deepseek-v2-lite-16b through the flash kernel's
    wide entry, the reduced configs against the CPU, and the autotuner."""
    import torch
    dev = torch.device(device)
    t0 = time.perf_counter()
    out = {"phase": "train", "card": card}
    for name, part in (("mamba", lambda: train_mamba_part(dev)),
                       ("danube", lambda: train_danube_part(dev)),
                       ("moe", lambda: train_moe_part(dev)),
                       ("hybrid", lambda: train_hybrid_part(dev)),
                       ("mla", lambda: train_mla_part(dev)),
                       ("reduced_vs_cpu", lambda: train_reduced_part(dev)),
                       ("tune", lambda: train_tune_part(dev))):
        t1 = time.perf_counter()
        out[name] = part()
        out[name]["seconds"] = time.perf_counter() - t1
    out["launches"] = {k: sum(out[p]["launches"][k]
                              for p in ("mamba", "danube", "moe", "hybrid",
                                        "mla", "tune"))
                       for k in out["mamba"]["launches"]}
    out["wide_launches"] = out["mla"]["wide_launches"]
    out["seconds"] = time.perf_counter() - t0
    return out



# ------------------------------------------------------------------ sharded
def tree_err(a, b) -> tuple:
    """(largest |a - b| of any leaf relative to that leaf's largest |b|,
    whether every leaf is equal bit for bit) over two trees of tensors."""
    import torch
    from repro_torch.distributed import whole
    from repro_torch.tree import leaves
    worst, same = 0.0, True
    for x, y in zip(leaves(a), leaves(b)):
        x, y = whole(x), whole(y)
        same &= bool(torch.equal(x, y))
        if y.is_floating_point():
            scale = max(float(y.abs().max()), 1e-30)
            worst = max(worst, float((x.float() - y.float()).abs().max())
                        / scale)
    return worst, same


def sharded_moe_part(mesh, dev, layers: int = 2, batch: int = 2,
                     seq_len: int = 2048, decode: int = 8,
                     train_steps: int = 2, q_chunk: int = 1024) -> dict:
    """deepseek-moe-16b at full width on ``layers`` of its 28 layers (as
    the ``train`` phase cuts it): ``jit_prefill_step``, ``decode``
    ``jit_decode_step``s and ``train_steps`` ``jit_train_step``s on the
    mesh against ``make_*_step`` without one on the same weights."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import (collective_bytes,
                                         record_collectives, reshard_state,
                                         whole)
    from repro_torch.launch import steps as S
    from repro_torch.models import init_cache, init_params
    from repro_torch.models import layers as L
    from repro_torch.optim.adamw import init_opt_state

    cfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                              num_layers=layers)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (batch, seq_len),
                            generator=torch.Generator(device=dev)
                            .manual_seed(1), device=dev)
    b_in = {"tokens": prompts}
    s_max = seq_len + decode
    out = {"arch": cfg.name, "layers": layers,
           "cut": f"num_layers 28 -> {layers}", "batch": batch,
           "seq_len": seq_len}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    # prefill, its routing recorded, without and with the mesh
    plain_prefill = S.make_prefill_step(cfg, q_chunk=q_chunk)
    cache0 = init_cache(cfg, batch, s_max, device=dev)
    mesh_prefill = S.jit_prefill_step(cfg, mesh, params, cache0, b_in,
                                      q_chunk=q_chunk)
    runs = {}
    for name, fn, cache in (
            ("plain", plain_prefill, init_cache(cfg, batch, s_max,
                                                 device=dev)),
            ("mesh", mesh_prefill, cache0)):
        with L.recording(L.RoutingLog()) as log:
            ((logits, c), counts), ms = timed(lambda: counted(
                lambda: fn(params, cache, b_in)))
        runs[name] = (whole(logits), c, log, ms, counts)
    (l1, c1, log1, ms1, n1), (l2, c2, log2, ms2, n2) = (runs["plain"],
                                                        runs["mesh"])
    require(n1["flash_attention"] == layers and n2 == n1,
            f"sharded: prefill launches {n2} on the mesh, {n1} without")
    require(L.same_routing(log1, log2), "sharded: the mesh prefill routes "
                                        "otherwise")
    scale = float(l1.abs().max())
    lerr = float((l2 - l1).abs().max()) / scale
    cerr, csame = tree_err(c2, c1)
    require(lerr <= LOGIT_TOL and cerr <= LOGIT_TOL,
            f"sharded: prefill logits {lerr:.3g}, caches {cerr:.3g} of the "
            f"largest")
    # warm: each timed in turns (mesh, plain, plain, mesh, ...), medians;
    # then the mesh's once more under the collective recorder
    warm = {"plain": [], "mesh": []}
    for name in ("mesh", "plain", "plain", "mesh") * 2:
        fn = mesh_prefill if name == "mesh" else plain_prefill
        warm[name].append(timed(lambda: fn(
            params, init_cache(cfg, batch, s_max, device=dev), b_in))[1])
    with record_collectives(mesh) as coll:
        mesh_prefill(params, init_cache(cfg, batch, s_max, device=dev), b_in)
    out["prefill"] = {
        "logits_share_of_tol": lerr / LOGIT_TOL,
        "cache_share_of_tol": cerr / LOGIT_TOL,
        "bit_for_bit": bool(torch.equal(l1, l2)) and csame,
        "same_routing": True, "launches": n2,
        "ms_first": {"plain": ms1, "mesh": ms2},
        "ms": {k: float(np.median(v)) for k, v in warm.items()},
        "collectives": collective_bytes(coll)["counts"]}

    # greedy decode from the two prefills; the mesh step takes the
    # parameters placed once, as a caller keeps them
    plain_dec = S.make_decode_step(cfg)
    mesh_dec = S.jit_decode_step(cfg, mesh, params, cache0, batch)
    placed = reshard_state(cfg, mesh, params)
    t1 = t2 = torch.argmax(l1, -1)[:, None]
    worst, same, ms = 0.0, True, {"plain": 0.0, "mesh": 0.0}
    for i in range(decode):
        (d1, c1), a = timed(lambda: plain_dec(params, c1, t1, seq_len + i))
        (d2, c2), b = timed(lambda: mesh_dec(placed, c2, t2, seq_len + i))
        d2 = whole(d2)
        if i:  # the first step pays the mesh's first-call costs
            ms["plain"] += a / (decode - 1)
            ms["mesh"] += b / (decode - 1)
        worst = max(worst, float((d2 - d1).abs().max())
                    / float(d1.abs().max()))
        same &= bool(torch.equal(d1, d2))
        t1, t2 = torch.argmax(d1, -1)[:, None], torch.argmax(d2, -1)[:, None]
        require(torch.equal(t1, t2), f"sharded: greedy token {i} differs")
    cerr, csame = tree_err(c2, c1)
    require(worst <= LOGIT_TOL and cerr <= LOGIT_TOL,
            f"sharded: decode logits {worst:.3g}, caches {cerr:.3g}")
    with record_collectives(mesh) as dcoll:  # the last position once more
        mesh_dec(placed, c2, t2, s_max - 1)
    # the last step again in turns, medians: unsharded, on the mesh, and on
    # the mesh with plain parameters placed again on every call
    calls = {"plain": lambda: plain_dec(params, c1, t1, s_max - 1),
             "mesh": lambda: mesh_dec(placed, c2, t2, s_max - 1),
             "mesh_placing_params": lambda: mesh_dec(params, c2, t2,
                                                     s_max - 1)}
    turns = {k: [] for k in calls}
    for name in (list(calls) + list(calls)[::-1]) * 2:
        turns[name].append(timed(calls[name])[1])
    out["decode"] = {"steps": decode, "logits_share_of_tol": worst / LOGIT_TOL,
                     "cache_share_of_tol": cerr / LOGIT_TOL,
                     "bit_for_bit": same and csame, "ms_per_step": ms,
                     "ms_last_step": {k: float(np.median(v))
                                      for k, v in turns.items()},
                     "collectives": collective_bytes(dcoll)["counts"]}
    del c1, c2, cache0, placed

    # training steps, without and with the mesh
    batch_t = train_batch(cfg, batch, seq_len, dev)
    opt = init_opt_state(params)
    plain_train = S.make_train_step(cfg, q_chunk=q_chunk)
    mesh_train = S.jit_train_step(cfg, mesh, params, opt, batch_t,
                                  q_chunk=q_chunk)
    res = {}
    for name, fn in (("plain", plain_train), ("mesh", mesh_train)):
        p, o = params, opt
        losses, times = [], []
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        for i in range(train_steps):
            (p, o, m), t = timed(lambda: fn(p, o, batch_t))
            losses.append(float(m["loss"]))
            times.append(t)
        torch.cuda.synchronize()
        # the peak above what was held when the run began (the other
        # run's state included)
        res[name] = (p, o, losses, times, read_counts(),
                     torch.cuda.max_memory_allocated() - base)
    (p1, o1, ls1, tm1, n1, pk1), (p2, o2, ls2, tm2, n2, pk2) = (
        res["plain"], res["mesh"])
    require(n1["flash_attention"] == 2 * layers * train_steps and n2 == n1,
            f"sharded: train launches {n2} on the mesh, {n1} without")
    lrel = max(abs(a - b) / abs(b) for a, b in zip(ls2, ls1))
    perr, psame = tree_err((p2, o2), (p1, o1))
    require(lrel <= TRAIN_LOSS_RTOL and perr <= LOGIT_TOL,
            f"sharded: train losses {lrel:.3g} apart, parameters and moments "
            f"{perr:.3g} of their largest")
    out["train"] = {"steps": train_steps, "losses": ls2,
                    "loss_rel_err": lrel, "state_share_of_tol": perr / LOGIT_TOL,
                    "bit_for_bit": psame and ls1 == ls2, "launches": n2,
                    "ms_per_step": {"plain": tm1, "mesh": tm2},
                    "peak_bytes_above_start": {"plain": int(pk1),
                                               "mesh": int(pk2)}}

    # reshard_state: mesh -> no mesh -> mesh, bit for bit
    on = reshard_state(cfg, mesh, p2, o2)
    off = reshard_state(cfg, None, *on)
    back = reshard_state(cfg, mesh, *off)
    require(tree_err(off, on)[1] and tree_err(back, on)[1]
            and not hasattr(off[0]["embed"], "placements")
            and hasattr(back[0]["embed"], "placements"),
            "sharded: reshard_state is not bit for bit")
    out["reshard_bit_for_bit"] = True
    del on, off, back, p1, o1
    with record_collectives(mesh) as tcoll:  # one more step, recorded
        mesh_train(p2, o2, batch_t)
    out["train"]["collectives"] = collective_bytes(tcoll)["counts"]
    # the main path's launches: the mesh's prefill and train steps (the
    # plain runs are the comparison)
    out["launches"] = {k: out["prefill"]["launches"][k] + n2[k] for k in n2}
    return out


def sharded_split_part(mesh, dev, batch: int = 4,
                       prompt_len: int = 512) -> dict:
    """Full mamba2-130m in the split-projection layout, prefilled 4 x 512
    (the ``serve`` phase's prompts) on the mesh, against the fused layout
    on the mapped weights without a mesh: logits within ``LOGIT_TOL``, the
    same SSD launches (one per layer)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import whole
    from repro_torch.launch import steps as S
    from repro_torch.models import init_cache, init_params, split_to_fused

    split = dataclasses.replace(get_config("mamba2-130m"),
                                ssm_split_proj=True)
    fused_cfg = dataclasses.replace(split, ssm_split_proj=False)
    params = init_params(split, torch.Generator(device=dev).manual_seed(0))
    fused = split_to_fused(split, params)
    prompts = torch.randint(0, split.vocab_size, (batch, prompt_len),
                            generator=torch.Generator(device=dev)
                            .manual_seed(1), device=dev)
    b_in = {"tokens": prompts}
    cache = init_cache(split, batch, prompt_len + 1, device=dev)
    (l1, _), n1 = counted(lambda: S.make_prefill_step(fused_cfg)(
        fused, init_cache(fused_cfg, batch, prompt_len + 1, device=dev),
        b_in))
    step = S.jit_prefill_step(split, mesh, params, cache, b_in)
    (l2, _), n2 = counted(lambda: step(params, cache, b_in))
    l2 = whole(l2)
    require(n1["ssd"] == split.num_layers and n2 == n1,
            f"sharded: split prefill SSD launches {n2}, fused {n1}")
    err = float((l2 - l1).abs().max()) / float(l1.abs().max())
    require(bool(torch.isfinite(l2).all()) and err <= LOGIT_TOL,
            f"sharded: split-projection prefill off the fused by {err:.3g}")
    return {"arch": split.name, "layout": "ssm_split_proj", "batch": batch,
            "prompt_len": prompt_len, "logits_share_of_tol": err / LOGIT_TOL,
            "bit_for_bit": bool(torch.equal(l1, l2)), "launches": n2}


def phase_sharded(card: str, device: str = "cuda") -> dict:
    """The sharding layer on a one-rank ("data", "model") mesh of the card:
    the MoE model's prefill, decode and train steps and the
    split-projection Mamba's prefill through the flash and SSD kernels on
    the mesh, each against the same steps without one, and
    ``reshard_state``; the group is destroyed before the phase returns."""
    import tempfile
    import torch
    from repro_torch.launch.mesh import one_rank_mesh
    dev = torch.device(device)
    t0 = time.perf_counter()
    out = {"phase": "sharded", "card": card, "torch": torch.__version__,
           "mesh": {"shape": [1, 1], "axes": ["data", "model"],
                    "backend": "nccl"}}
    with tempfile.TemporaryDirectory(prefix="repro-mesh-") as tmp, \
            one_rank_mesh(tmp, dev) as mesh:
        for name, part in (("moe", lambda: sharded_moe_part(mesh, dev)),
                           ("split", lambda: sharded_split_part(mesh, dev))):
            t1 = time.perf_counter()
            out[name] = part()
            out[name]["seconds"] = time.perf_counter() - t1
            torch.cuda.empty_cache()
    out["launches"] = {k: out["moe"]["launches"][k]
                       + out["split"]["launches"][k]
                       for k in out["moe"]["launches"]}
    out["seconds"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------------------- dryrun
DRYRUN_TOL = 0.10  # predicted peak bytes against max_memory_allocated
# production cells the dryrun phase sizes on the card's host
DRYRUN_CELLS = (("mamba2-130m", "train_4k", "single"),
                ("qwen3-14b", "decode_32k", "single"),
                ("qwen3-14b", "decode_32k", "multi"))


def _meta_tree(tree):
    import torch
    from repro_torch.tree import tree_map
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def calibration_cases(dev, layers: int = 2, batch: int = 2,
                      seq_len: int = 2048, decode: int = 8,
                      q_chunk: int = 1024) -> list:
    """The ``sharded`` phase's three mesh steps: 2-layer full-width
    deepseek-moe-16b's train step and prefill (batch 2 x 2048, f32), full
    mamba2-130m's split-projection prefill (4 x 512).  Each (name, kind,
    cfg, a function drawing its real arguments on the card, step
    keywords)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_params
    from repro_torch.optim.adamw import init_opt_state

    moe = dataclasses.replace(get_config("deepseek-moe-16b"),
                              num_layers=layers)
    split = dataclasses.replace(get_config("mamba2-130m"),
                                ssm_split_proj=True)

    def draw(cfg):
        return init_params(cfg, torch.Generator(device=dev).manual_seed(0))

    def prompts(cfg, b, s):
        return {"tokens": torch.randint(
            0, cfg.vocab_size, (b, s), device=dev,
            generator=torch.Generator(device=dev).manual_seed(1))}

    def moe_train():
        params = draw(moe)
        return (params, init_opt_state(params),
                train_batch(moe, batch, seq_len, dev))

    return [
        ("moe_train", "train", moe, moe_train, {"q_chunk": q_chunk}),
        ("moe_prefill", "prefill", moe, lambda: (
            draw(moe), init_cache(moe, batch, seq_len + decode, device=dev),
            prompts(moe, batch, seq_len)), {"q_chunk": q_chunk}),
        ("split_prefill", "prefill", split, lambda: (
            draw(split), init_cache(split, 4, 513, device=dev),
            prompts(split, 4, 512)), {}),
    ]


def dryrun_calibration(dev) -> list:
    """Each calibration case's predicted peak bytes and kernel calls (the
    dry-run's trace on a fake (1, 1) CUDA mesh of one rank) beside the
    real step's ``max_memory_allocated`` and launches on a one-rank NCCL
    mesh, its inputs drawn and placed before the peak is reset, nothing
    else of the case resident.  The fake group is destroyed before the
    NCCL group is made."""
    import gc
    import tempfile
    import torch
    from repro_torch.distributed.sharding import place
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, one_rank_mesh

    cases = calibration_cases(dev)
    metas = []
    for _, _, _, build, _ in cases:
        args = build()
        metas.append(_meta_tree(args))
        del args
    torch.cuda.empty_cache()
    rows = []
    with dryrun.fake_group(1):
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        for (name, kind, cfg, _, kw), meta in zip(cases, metas):
            t0 = time.perf_counter()
            pred = dryrun.trace_step(kind, cfg, mesh, meta, **kw)
            rows.append({"case": name, "arch": cfg.name,
                         "predicted_peak_bytes": pred["peak_bytes"],
                         "predicted_input_bytes": pred["input_bytes"],
                         "predicted_kernel_calls": pred["kernel_calls"],
                         "trace_s": time.perf_counter() - t0})
    with tempfile.TemporaryDirectory(prefix="repro-mesh-") as tmp, \
            one_rank_mesh(tmp, dev) as mesh:
        for row, (name, kind, cfg, build, kw), meta in zip(rows, cases,
                                                           metas):
            step, specs = dryrun.mesh_step(kind, cfg, mesh, meta, **kw)
            args = build()
            placed = [place(a, sp, mesh) for a, sp in zip(args, specs)]
            del args
            gc.collect()  # the earlier cases' graphs hold no memory now
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out, counts = counted(lambda: step(*placed))
            peak = torch.cuda.max_memory_allocated()
            wide = wide_count()
            del out, placed
            gc.collect()
            torch.cuda.empty_cache()
            calls = row["predicted_kernel_calls"]
            launches = {"flash_attention": counts["flash_attention"],
                        "flash_attention_wide": wide, "ssd": counts["ssd"]}
            predicted = {
                "flash_attention": calls.get("flash_attention", 0)
                + calls.get("flash_attention_wide", 0),
                "flash_attention_wide": calls.get("flash_attention_wide", 0),
                "ssd": calls.get("ssd", 0)}
            row.update({
                "max_memory_allocated": int(peak),
                "allocated_before": int(base),
                "ratio": row["predicted_peak_bytes"] / peak,
                "launches": launches, "predicted_launches": predicted})
            print(f"dryrun: {json.dumps(row)}", flush=True)
    for row in rows:
        require(abs(row["ratio"] - 1.0) <= DRYRUN_TOL,
                f"dryrun: {row['case']} predicted "
                f"{row['predicted_peak_bytes']} bytes, measured "
                f"{row['max_memory_allocated']} (ratio {row['ratio']:.4f})")
        require(row["predicted_launches"] == row["launches"],
                f"dryrun: {row['case']} predicted kernel calls "
                f"{row['predicted_launches']}, launched {row['launches']}")
    return rows


def phase_dryrun(card: str, device: str = "cuda") -> dict:
    """The dry-run checked against the card: the calibration steps'
    predicted peaks and kernel calls against the card's, then
    ``launch.dryrun.run_cell`` on production cells (a host-side trace on
    a fake group of 256 or 512 ranks), then the port's serve and train
    examples at small arguments."""
    import torch
    from repro_torch.launch import dryrun
    dev = torch.device(device)
    t0 = time.perf_counter()
    total = torch.cuda.get_device_properties(dev).total_memory
    out = {"phase": "dryrun", "card": card, "torch": torch.__version__,
           "total_memory": int(total), "budget": dryrun.HBM_LIMIT}
    print(f"dryrun: total_memory {total} bytes on {card}", flush=True)
    out["calibration"] = dryrun_calibration(dev)
    out["calibration_s"] = time.perf_counter() - t0
    cells = []
    for arch, shape, mesh in DRYRUN_CELLS:
        t1 = time.perf_counter()
        try:
            res = dryrun.run_cell(arch, shape, mesh)
        except Exception as exc:  # reported with the others, then failed
            res = {"arch": arch, "shape": shape, "mesh": mesh,
                   "status": "error", "error": f"{type(exc).__name__}: "
                   f"{str(exc)[-400:]}"}
        cells.append({k: res.get(k) for k in (
            "arch", "shape", "mesh", "status", "n_micro", "moment_dtype",
            "peak_bytes", "fits_hbm", "dominant", "roofline_bound_s",
            "t_compute_s", "t_memory_s", "t_collective_s", "kernel_calls",
            "mandatory_bytes_per_chip", "error")}
            | {"seconds": time.perf_counter() - t1})
        print(f"dryrun: {json.dumps(cells[-1])}", flush=True)
    for c in cells:
        require(c["status"] in ("ok", "skipped"),
                f"dryrun: {c['arch']} {c['shape']} {c['mesh']}: {c}")
    out["cells"] = cells
    out["cells_s"] = sum(c["seconds"] for c in cells)
    out["examples"] = examples_part()
    out["launches"] = out["examples"].pop("launches")
    out["seconds"] = time.perf_counter() - t0
    return out


def examples_part() -> dict:
    """``examples/port_serve_decode.py`` and ``port_train_100m.py`` once on
    the card at small arguments, each held to its own checks."""
    import importlib.util
    import tempfile
    res = {"launches": {}}
    for name, argv in (
            ("port_serve_decode", ["--gen-len", "64"]),
            ("port_train_100m", ["--steps", "30", "--batch", "2",
                                 "--seq-len", "128"])):
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="repro-ex-") as tmp:
            extra = ["--ckpt-dir", tmp] if name == "port_train_100m" else []
            got, counts = counted(lambda: mod.main(argv + extra))
        res[name] = {"seconds": time.perf_counter() - t0, **got,
                     "launches": counts}
        for k, v in counts.items():
            res["launches"][k] = res["launches"].get(k, 0) + v
        require(counts["ssd"] > 0, f"dryrun: {name} launched no SSD kernel")
    return res


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
    check = ptxas_start()
    try:
        lib = runtime.build_library()
        runtime.load_library()
    except BaseException:
        for _, proc in check:
            proc.kill()
            proc.wait()
        raise
    emit({"phase": "build", "card": card, "library": lib.name,
          "seconds": time.perf_counter() - t0})
    emit({"phase": "compiled", "ptxas": ptxas_report(check),
          "sass": sass_counts(lib)})

    results = {}
    if "kernels" in phases:
        results["kernels"] = phase_kernels(card)
        emit(results["kernels"])
    job = None  # the job phase's rows and cuda result, for analysis
    if "job" in phases:
        results["job"] = phase_job(card)
        job = results["job"].pop("result")
        emit(results["job"])
    if "analysis" in phases:
        results["analysis"] = phase_analysis(card, job)
        emit(results["analysis"])
    del job
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
    served = None  # the serve phase's ServeResult, for the transport phase
    if "serve" in phases:
        results["serve"] = phase_serve(card)
        served = results["serve"].pop("result")
        emit(results["serve"])
    if "serve_attn" in phases:
        results["serve_attn"] = phase_serve_attn(card)
        emit(results["serve_attn"])
    if "serve_moe" in phases:
        results["serve_moe"] = phase_serve_moe(card)
        emit(results["serve_moe"])
    if "serve_hybrid" in phases:
        results["serve_hybrid"] = phase_serve_hybrid(card)
        emit(results["serve_hybrid"])
    if "serve_mla" in phases:
        results["serve_mla"] = phase_serve_mla(card)
        emit(results["serve_mla"])
    if "frontends" in phases:
        results["frontends"] = phase_frontends(card)
        emit(results["frontends"])
    if "transport" in phases:
        results["transport"] = phase_transport(card, served)
        emit(results["transport"])
    if "train" in phases:
        results["train"] = phase_train(card)
        emit(results["train"])
    if "sharded" in phases:
        results["sharded"] = phase_sharded(card)
        emit(results["sharded"])
    if "dryrun" in phases:
        results["dryrun"] = phase_dryrun(card)
        emit(results["dryrun"])

    launches = {"changepoint": 0, "windowvet": 0, "ssd": 0,
                "flash_attention": 0}
    for p in ("job", "analysis", "fleet_fused", "fleet_gather", "serve",
              "serve_attn", "serve_moe", "serve_hybrid", "serve_mla",
              "frontends", "transport", "train", "sharded", "dryrun"):
        for k in launches:
            launches[k] += results.get(p, {}).get("launches", {}).get(k, 0)
    # the flash wrapper counts both entries; the table splits them
    wide = sum(results.get(p, {}).get("wide_launches", 0)
               for p in ("serve_hybrid", "serve_mla", "train"))
    table = []
    if "kernels" in results:
        cpk = results["kernels"]["changepoint"][1]  # (1024, 1000): the job
        wvk = results["kernels"]["windowvet"][0]  # the ragged fleet tick
        sdk = results["kernels"]["ssd"][0]  # f32, the serve prefill shape
        fak = results["kernels"]["flash_attention"][0]  # f32, serve_attn
        fwk = next(c for c in results["kernels"]["flash_attention"]
                   if c["case"] == "mla_wide_causal_2048")  # f32, serve_mla
        table = [
            {"name": "changepoint", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/changepoint.cu",
             "replaces": "src/repro/kernels/changepoint/kernel.py:78",
             "bound_basis": "values and starts/lengths in, landscape and t "
                            "out; 45 f32 operations per element",
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
             "bound_basis": sdk["bound_basis"],
             "f32_unit_bound_ms": sdk["f32_unit_bound_ms"],
             "library_ms": None},
            {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/kernel.py:94",
             "launches": launches["flash_attention"] - wide,
             "max_abs_err": max(c["max_abs_err"] for c in
                                results["kernels"]["flash_attention"]
                                if c["dtype"] == "float32"
                                and c["entry"] == "wgmma"),
             "ms": fak["ms"], "plain_ms": fak["plain_ms"],
             "bound_ms": fak["bound_ms"], "bound_by": fak["bound_by"],
             "bound_basis": fak["bound_basis"],
             "f32_unit_bound_ms": fak["f32_unit_bound_ms"],
             "library_ms": fak["library_ms"]},
            {"name": "flash_attention_wide", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/kernel.py:94",
             "launches": wide,
             "max_abs_err": max(c["max_abs_err"] for c in
                                results["kernels"]["flash_attention"]
                                if c["dtype"] == "float32"
                                and c["entry"] == "wide"),
             "ms": fwk["ms"], "plain_ms": fwk["plain_ms"],
             "bound_ms": fwk["bound_ms"], "bound_by": fwk["bound_by"],
             "bound_basis": fwk["bound_basis"],
             "f32_unit_bound_ms": fwk["f32_unit_bound_ms"],
             "library_ms": fwk["library_ms"]},
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
