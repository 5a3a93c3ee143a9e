"""Serving example of the PyTorch/CUDA port: batched greedy decode with
per-token-step vet profiling (the paper's measure applied to an inference
job), through ``repro_torch.launch.serve``.

The prompt length defaults to 64, the full mamba2-130m's SSD chunk (a
prompt must be a multiple of it; ``--reduced`` takes multiples of 8).
Runs on the card by default; ``--device cpu`` or ``REPRO_TORCH_DEVICE=cpu``
runs it on the CPU.

Run:  PYTHONPATH=src python examples/port_serve_decode.py --gen-len 64
"""

import argparse

from repro_torch.configs import get_config
from repro_torch.launch.serve import serve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=96)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale model instead of the published config")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"[example] serving {cfg.name} ({cfg.param_count()/1e6:.0f}M params)")
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen_len=args.gen_len, device=args.device)
    if res.vet is not None:
        print(f"[example] decode vet {res.vet:.2f}: the estimated ideal "
              f"per-token cost is {res.ei / max(res.tokens.shape[1] // 5, 1) * 1e3:.2f}ms")
    return {"arch": cfg.name, "tokens": list(res.tokens.shape),
            "vet": res.vet}


if __name__ == "__main__":
    main()
