#!/usr/bin/env python3
"""Flash-attention timings on one card that ``chip_smoke.py`` does not
take: this checkout's kernel against another checkout's in turns, and the
bf16 kernel at MLA's prefill shape with parts of its loop cut out.

    python3 tools/flash_probe.py --other DIR [--json FILE]

``DIR`` is the root of another checkout of the repo (for example the
parent commit unpacked with ``git archive``).  The script compiles
``csrc/flash_attention.cu`` of both checkouts, and cut copies of this
checkout's, each into a shared library of its own under ``build/probe/``
(one ``nvcc`` each, all started together), then:

* ``turns``: every head-dimension-up-to-128 shape of the smoke's
  ``flash_cases`` through both checkouts' ``flash_attention_f32`` /
  ``_bf16`` entries (the C signature both share), timed in the order
  other, this, this, other on the same inputs (CUDA events), each output
  held to the plain version at the smoke's ``FLASH_TOL``;
* ``cuts``: the bf16 wide entry at MLA's prefill shape (B = 2, S = 2048,
  16 heads, Q and K of 192, V of 128, causal), whole and cut: without the
  online softmax (scores go to P V as they are, no rescaling), without
  the P V products, with Q K^T cut to one of its twelve k-steps, with
  both products cut, without the K and V copies after the first two
  tiles, and with those cuts together; beside them
  ``scaled_dot_product_attention`` on the same inputs and the bound at
  989 TFLOP/s.  A cut copy computes no attention; it is only timed.

Prints the card's name and power limit and one JSON line per part, and
with ``--json`` writes them all to FILE.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402

SRC = Path("src/repro_torch/kernels/csrc")
# the cut copies: (name, [(text of the bf16 template, its replacement)]);
# each text must occur exactly once in the source
SOFTMAX = ("""    float alpha[2];
    softmax_step(x, m, l, alpha);
#pragma unroll
    for (int i2 = 0; i2 < 64; ++i2) acc[i2] *= alpha[(i2 >> 1) & 1];
""", "    l[0] = l[1] = 1.0f;\n")
PV = ("      wgmma_rs(acc, pa[kk], desc_at(vd, kk * 16 * 128));\n",
      "      ;\n")
QK = ("""    for (int kk = 0; kk < 4 * NP; ++kk)
      wgmma_ss(sc,""", """    for (int kk = 0; kk < 1; ++kk)
      wgmma_ss(sc,""")
# the producer fills the two stages once and then only signals them, so
# the consumers run on stale K and V without waiting for a copy
LOADS = ("""        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, L::kKBytes + L::kVBytes);
""", """        const uint32_t full = full0 + 8 * s;
        if (i >= 2) {
          mbar_arrive(full);
          continue;
        }
        mbar_expect_tx(full, L::kKBytes + L::kVBytes);
""")
CUTS = (("no_softmax", [SOFTMAX]), ("no_pv", [PV]), ("qk_one_step", [QK]),
        ("qk_one_step_no_pv", [QK, PV]), ("no_loads", [LOADS]),
        ("no_loads_no_softmax", [LOADS, SOFTMAX]),
        ("no_loads_qk_one_step_no_pv", [LOADS, QK, PV]))
NARROW = (("serve_f32", smoke.FLASH_SERVE, True, 4096, "float32"),
          ("serve_bf16", smoke.FLASH_SERVE, True, 4096, "bfloat16"),
          ("causal_2048", (2, 2048, 32, 8, 120), True, 0, "float32"),
          ("causal_2048_bf16", (2, 2048, 32, 8, 120), True, 0, "bfloat16"),
          ("bidirectional_2048", (2, 2048, 32, 8, 120), False, 0, "float32"),
          ("ragged_200", (2, 200, 32, 8, 120), True, 0, "float32"),
          ("moe_causal_2048", smoke.FLASH_MOE, True, 0, "float32"),
          ("vlm_causal_2048", smoke.FLASH_VLM, True, 0, "float32"),
          ("hubert_bidirectional_1024", smoke.FLASH_HUBERT, False, 0,
           "float32"),
          ("zamba_causal_2048", smoke.FLASH_ZAMBA, True, 0, "float32"))


def build(jobs: dict) -> dict:
    """{name: source text} -> {name: ctypes handle}, all compiled at once."""
    from repro_torch.kernels import runtime
    out_dir = ROOT / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in jobs.items():
        src = out_dir / f"flash_{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [runtime._nvcc(), *runtime.ARCH_FLAGS, *runtime.NVCC_FLAGS,
             "-I", str(runtime.CSRC), "-shared", str(src), "-o",
             str(out_dir / f"libflash_{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        smoke.require(proc.returncode == 0, f"{name}: nvcc failed\n{err}")
        lib = ctypes.CDLL(str(out_dir / f"libflash_{name}.so"))
        for entry in ("flash_attention_f32", "flash_attention_bf16",
                      "flash_attention_wide_bf16"):
            fn = getattr(lib, entry)
            fn.argtypes = runtime._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def cut(text: str, patches) -> str:
    for old, new in patches:
        smoke.require(text.count(old) == 1, f"cut text not found once: {old}")
        text = text.replace(old, new)
    return text


def inputs(shape, dv, dtype, seed):
    import torch
    b, s, h, kh, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(sh, generator=gen, device="cuda").to(dtype)
                 for sh in ((b, s, h, d), (b, s, kh, d), (b, s, kh, dv)))


def turns(libs, stream) -> list:
    """Both checkouts' narrow entries in the order other, this, this,
    other."""
    import torch
    from repro_torch.kernels.flash_attention import attention_plain
    rows = []
    for i, (name, shape, causal, window, tname) in enumerate(NARROW):
        dtype = getattr(torch, tname)
        b, s, h, kh, d = shape
        q, k, v = inputs(shape, d, dtype, i)
        scale = 1.0 / d ** 0.5
        want = attention_plain(q, k, v, causal=causal, window=window,
                               scale=scale).float()
        tol = smoke.FLASH_TOL[tname]
        entry = "flash_attention_f32" if tname == "float32" else \
            "flash_attention_bf16"
        iters = 10 if s > 4096 else 50
        row = {"case": name, "dtype": tname, "shape": list(shape)}
        calls = {}
        for side in ("other", "this"):
            o = torch.empty_like(q)
            args = [t.data_ptr() for t in (q, k, v, o)] + [
                b, s, h, kh, d, int(causal), window, scale, stream]
            fn = getattr(libs[side], entry)
            smoke.require(fn(*args) == 0, f"{side} {name}: launch failed")
            torch.cuda.synchronize()
            worst = float(((o.float() - want).abs()
                           / (tol + tol * want.abs())).max())
            smoke.require(worst <= 1.0, f"{side} {name}: {worst:.3g} x the "
                                        f"tolerance {tol}")
            row[f"{side}_err_over_tol"] = worst
            calls[side] = (lambda fn=fn, args=args: fn(*args))
        ms = {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            ms[side].append(smoke.cuda_ms(calls[side], iters=iters))
        row.update(other_ms=ms["other"], this_ms=ms["this"],
                   this_over_other=sum(ms["this"]) / sum(ms["other"]))
        rows.append(row)
        del q, k, v, want
        torch.cuda.empty_cache()
    return rows


def cuts(libs, stream) -> dict:
    """The bf16 wide entry at MLA's shape, whole and cut, beside SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     live_pairs)
    shape, dv = smoke.FLASH_MLA, smoke.MLA_V_DIM
    b, s, h, kh, d = shape
    q, k, v = inputs(shape, dv, torch.bfloat16, 0)
    scale = 1.0 / d ** 0.5
    o = q.new_empty((b, s, h, dv))
    args = [t.data_ptr() for t in (q, k, v, o)] + [
        b, s, h, kh, d, dv, 1, 0, scale, stream]
    whole = libs["this"].flash_attention_wide_bf16
    smoke.require(whole(*args) == 0, "wide bf16: launch failed")
    torch.cuda.synchronize()
    want = attention_plain(q, k, v, causal=True, scale=scale).float()
    err = float(((o.float() - want).abs() / (2e-2 + 2e-2 * want.abs())).max())
    smoke.require(err <= 1.0, f"wide bf16: {err:.3g} x the tolerance")
    ops = 2.0 * (d + dv) * live_pairs(s, causal=True) * b * h
    out = {"shape": list(shape), "v_dim": dv, "dtype": "bfloat16",
           "err_over_tol": err, "gflop": ops / 1e9,
           "bound_ms": ops / smoke.BF16_OPS_PER_S * 1e3, "ms": {}}
    for name in ("this", *(c for c, _ in CUTS), "this"):
        fn = libs[name].flash_attention_wide_bf16
        out["ms"].setdefault(name, []).append(
            smoke.cuda_ms(lambda fn=fn: fn(*args), iters=50))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out["sdpa_ms"] = smoke.cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale), iters=50)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the checkout to compare with")
    ap.add_argument("--json", type=Path, help="write the results here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 1
    this = (ROOT / SRC / "flash_attention.cu").read_text()
    jobs = {"this": this,
            "other": (args.other / SRC / "flash_attention.cu").read_text(),
            **{name: cut(this, patches) for name, patches in CUTS}}
    libs = build(jobs)
    stream = torch.cuda.current_stream().cuda_stream
    card = smoke.card_line()
    print(card, flush=True)
    res = {"card": card, "turns": turns(libs, stream),
           "cuts": cuts(libs, stream)}
    for part in ("turns", "cuts"):
        smoke.emit({part: res[part]})
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
