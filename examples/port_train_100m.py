"""End-to-end driver of the PyTorch/CUDA port: train the ~130M-parameter
mamba2-130m config with the full production substrate (deterministic data
pipeline, AdamW, async atomic checkpointing, crash-resume, and the vet
dashboard on live step records) through ``repro_torch.launch.train``.

Runs on the card by default; ``--device cpu`` or ``REPRO_TORCH_DEVICE=cpu``
runs it on the CPU (``--steps 30`` for a quick pass; the loop, checkpoint
cadence and vet instrumentation are the same).  The checkpoints go under
the temporary directory unless ``--ckpt-dir`` says otherwise.

Run:  PYTHONPATH=src python examples/port_train_100m.py --steps 30
"""

import argparse
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.launch.train import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt_100m"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale model instead of the published config")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config("mamba2-130m")  # 0.13B params, published config
    if args.reduced:
        cfg = cfg.reduced()
    print(f"[example] {cfg.name}: {cfg.param_count()/1e6:.0f}M params, "
          f"{cfg.num_layers}L x d{cfg.d_model}, SSD state {cfg.ssm_state}")
    res = train(
        cfg, steps=args.steps, batch=args.batch, seq_len=args.seq_len,
        lr=args.lr, ckpt_dir=args.ckpt_dir, ckpt_every=max(args.steps // 5, 10),
        record_unit=5, log_every=max(args.steps // 20, 1), device=args.device,
    )
    print(f"[example] loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f} over "
          f"{len(res.losses)} steps")
    if res.vet is not None:
        print(f"[example] vet {res.vet:.2f}  (EI {res.ei:.2f}s of PR {res.pr:.2f}s)"
              f" -> {res.vet - 1:.0%} reducible overhead in this run")
    print(f"[example] phases: {res.phase_totals}")
    print(f"[example] checkpoints in {args.ckpt_dir} — rerun to resume.")
    return {"arch": cfg.name, "steps": len(res.losses),
            "loss_first": res.losses[0], "loss_last": res.losses[-1],
            "vet": res.vet}


if __name__ == "__main__":
    main()
