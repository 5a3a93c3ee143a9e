"""One rank of the port's mesh checks: four CPU processes on a (2, 2)
``("data", "model")`` gloo mesh.

Run by ``tests/test_torch_mesh.py`` as four subprocesses:

    python tests/torch_mesh_worker.py INIT_FILE RANK WORLD REF.npz OUT.json

Every rank runs every check (they issue the same collectives); rank 0
writes the results to OUT.json, one entry per check: the largest error
against its oracle (``err``), or a pass/fail (``ok``), with what it was
compared to.  The reference's numbers come in REF.npz, computed by the
parent from the same seeded weights and numpy inputs while the ranks run
(the checks that need them come last); the unsharded oracle is the port
itself, run on the full tensors on every rank.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import whole

B, S = 4, 32  # batch over data=2, sequence 32 (q_chunk 32)
LAYERS = 2  # the reduced configs cut to two layers (the MoE: dense, MoE)


def moe_cfg(cf=8.0):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                               capacity_factor=cf, num_layers=LAYERS)


def gqa1_cfg():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("qwen3-14b").reduced(),
                               num_kv_heads=1, num_layers=LAYERS)


def mla_cfg():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("deepseek-v2-lite-16b").reduced(),
                               capacity_factor=8.0, num_layers=LAYERS)


def split_cfg():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("mamba2-130m").reduced(),
                               ssm_split_proj=True, num_layers=LAYERS)


def weights(cfg, seed=0):
    from repro_torch.models import init_params

    return init_params(cfg, torch.Generator().manual_seed(seed))


def tokens(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)


def moe_input(cfg, seed=4):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _worst(a_tree, b_tree):
    from repro_torch.tree import leaves_with_paths

    worst, where = 0.0, ""
    for (k, a), (_, b) in zip(leaves_with_paths(a_tree),
                              leaves_with_paths(b_tree)):
        e = float((whole(a).float() - whole(b).float()).abs().max())
        if e >= worst:
            worst, where = e, k
    return worst, where


def _bitwise(a_tree, b_tree):
    from repro_torch.tree import leaves

    return all(torch.equal(whole(a), whole(b))
               for a, b in zip(leaves(a_tree), leaves(b_tree)))


class _Timed(dict):
    """Results that note the seconds since the previous one was set."""

    def __init__(self):
        super().__init__()
        self._t = time.perf_counter()

    def __setitem__(self, key, value):
        now = time.perf_counter()
        super().__setitem__(key, {**value, "seconds": now - self._t})
        self._t = now


class Refs:
    """The parent's reference numbers, read from REF.npz once it appears
    (the parent writes it, by an atomic rename, while the ranks run)."""

    def __init__(self, path, timeout_s: float = 600.0):
        self.path, self.timeout_s, self._d = path, timeout_s, None

    def __getitem__(self, key):
        if self._d is None:
            deadline = time.monotonic() + self.timeout_s
            while not os.path.exists(self.path):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"no {self.path}")
                time.sleep(0.1)
            self._d = dict(np.load(self.path))
        return self._d[key]


def run(mesh, ref, ckpt_root):
    from repro_torch.distributed import (MeshAxes, batch_specs,
                                         param_specs, place,
                                         record_collectives, reshard_state)
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import forward, init_cache, layers as L
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.tree import leaves

    ax = MeshAxes(mesh)
    ctx = steps.make_ctx(mesh)
    out = _Timed()

    def placed(cfg, params, batch):
        return (place(params, param_specs(params, ax, cfg), mesh),
                place(batch, batch_specs(cfg, ax, batch), mesh))

    cfg = moe_cfg()
    params = weights(cfg)
    batch = {"tokens": torch.from_numpy(tokens(cfg))}

    # -- one train step against the unsharded port step
    g = np.random.default_rng(2)
    tb = {"tokens": batch["tokens"],
          "labels": torch.from_numpy(
              g.integers(0, cfg.vocab_size, (B, S)).astype(np.int64))}
    opt = init_opt_state(params)
    p1, o1, m1 = steps.make_train_step(cfg, None, q_chunk=S, remat="none")(
        params, opt, tb)
    p2, o2, m2 = steps.jit_train_step(cfg, mesh, params, opt, tb, q_chunk=S,
                                      remat="none")(params, opt, tb)
    worst, where = _worst((p1, o1), (p2, o2))
    # a leaf already so placed is handed back as it is, not redistributed
    again = place(p2, param_specs(p2, ax, cfg), mesh)
    out["train_step"] = {"loss_err": abs(float(m1["loss"]) - float(m2["loss"])),
                         "err": worst, "where": where,
                         "placed": all(hasattr(t, "placements") for t in
                                       [p2["seg1"]["moe"]["wg"], o2.mu["embed"]]),
                         "kept": all(a is b for a, b in zip(leaves(again),
                                                            leaves(p2)))}

    # -- two microbatches: the train step's accumulated gradients and the
    # chunked prefill's joined caches, against the unsharded port's
    p1, o1, m1 = steps.make_train_step(cfg, None, q_chunk=S, remat="none",
                                       n_micro=2)(params, opt, tb)
    p2, o2, m2 = steps.jit_train_step(cfg, mesh, params, opt, tb, q_chunk=S,
                                      remat="none", n_micro=2)(params, opt,
                                                               tb)
    cache = init_cache(cfg, B, S)
    prompt = {"tokens": batch["tokens"]}
    l1, c1 = steps.make_prefill_step(cfg, None, q_chunk=S, n_micro=2)(
        params, copy.deepcopy(cache), prompt)
    l2, c2 = steps.jit_prefill_step(cfg, mesh, params, cache, prompt,
                                    q_chunk=S, n_micro=2)(params, cache,
                                                          prompt)
    out["n_micro"] = {"loss_err": abs(float(m1["loss"]) - float(m2["loss"])),
                      "err": _worst((p1, o1), (p2, o2))[0],
                      "prefill_err": float((l1 - whole(l2)).abs().max()),
                      "cache_err": _worst(c1, c2)[0]}

    # -- prefill and 4 greedy decode steps on the sequence-sharded cache
    for name, c in (("moe", cfg), ("gqa1", gqa1_cfg()), ("mla", mla_cfg()),
                    ("split", split_cfg())):
        pc = params if c is cfg else weights(c)
        b = {"tokens": torch.from_numpy(tokens(c))}
        cache = init_cache(c, B, S + 8)
        l1, c1 = steps.make_prefill_step(c, None, q_chunk=S)(
            pc, copy.deepcopy(cache), b)
        l2, c2 = steps.jit_prefill_step(c, mesh, pc, cache, b, q_chunk=S)(
            pc, cache, b)
        errs = [float((l1 - whole(l2)).abs().max())]
        dec1 = steps.make_decode_step(c)
        dec2 = steps.jit_decode_step(c, mesh, pc, cache, B)
        t1 = t2 = torch.argmax(l1, -1)[:, None]
        same = True
        for i in range(4):
            l1, c1 = dec1(pc, c1, t1, S + i)
            l2, c2 = dec2(pc, c2, t2, S + i)
            l2 = whole(l2)
            errs.append(float((l1 - l2).abs().max()))
            t1, t2 = torch.argmax(l1, -1)[:, None], torch.argmax(l2, -1)[:, None]
            same &= bool(torch.equal(t1, t2))
        seq_sharded = any(
            "Shard(dim=2)" in str(t.placements)
            for t in [v for seg in c2.values() for v in seg.values()])
        out[f"serve_{name}"] = {"err": max(errs), "cache_err": _worst(c1, c2)[0],
                                "same_tokens": same,
                                "seq_sharded": seq_sharded}

    # -- the GQA forward with replicated KV heads (one KV head)
    c = gqa1_cfg()
    pc = weights(c)
    b = {"tokens": torch.from_numpy(tokens(c))}
    d1, d2 = placed(c, pc, b)
    lg, _ = forward(c, d1, d2, ctx, remat="none", q_chunk=S)
    want = forward(c, pc, b, remat="none", q_chunk=S)[0]
    out["forward_gqa1"] = {"err": float((whole(lg) - want).abs().max())}

    # -- reshard_state from (2, 2) to (4, 1), (1, 4) and back, bit for bit
    state = reshard_state(cfg, mesh, params, opt)
    ok = True
    for shape in ((4, 1), (1, 4)):
        other = make_mesh(shape, ("data", "model"))
        moved = reshard_state(cfg, other, *state)
        back = reshard_state(cfg, mesh, *moved)
        ok &= _bitwise((params, opt), moved) and _bitwise((params, opt), back)
        ok &= all(t.device_mesh is other for t in
                  [moved[0]["embed"], moved[1].mu["embed"]])
    plain = reshard_state(cfg, None, *state)
    ok &= _bitwise((params, opt), plain) and not hasattr(plain[0]["embed"],
                                                         "placements")
    out["reshard"] = {"ok": bool(ok)}

    # -- a checkpoint saved on the mesh, restored with no mesh (and onto it)
    from repro_torch.checkpoint import checkpoint as ck

    root = ckpt_root
    ck.save(root, 7, state)
    got, step = ck.restore(root, (params, opt))
    back, _ = ck.restore(root, state)
    out["checkpoint"] = {"ok": bool(step == 7 and _bitwise(got, (params, opt))
                                    and _bitwise(back, state)
                                    and not hasattr(got[0]["embed"],
                                                    "placements"))}

    # -- train(mesh=...) cut by a failure, resumed onto the mesh, against
    # the unsharded train()
    from repro_torch.launch.train import SimulatedFailure, train

    small = split_cfg()
    kw = dict(steps=3, batch=4, seq_len=16, q_chunk=16, verbose=False,
              device="cpu")
    unsharded = train(small, **kw)
    cut_dir = os.path.join(root, "train")
    try:
        train(small, ckpt_dir=cut_dir, ckpt_every=1, fail_at_step=2,
              mesh=mesh, **kw)
        failed = False
    except SimulatedFailure:
        failed = True
    resumed = train(small, ckpt_dir=cut_dir, ckpt_every=1, mesh=mesh, **kw)
    out["train_mesh"] = {
        "failed": failed, "resumed_from": resumed.resumed_from,
        "err": max(abs(a - b) for a, b in
                   zip(unsharded.losses[resumed.resumed_from + 1:],
                       resumed.losses))}

    # -- last, the checks against the reference's numbers, which the
    # parent computes while the ranks run the checks above
    # -- the MoE model's forward and aux against the reference's
    dp_, db = placed(cfg, params, batch)
    logits, aux = forward(cfg, dp_, db, ctx, remat="none", q_chunk=S)
    out["moe_forward"] = {
        "err": float(np.abs(whole(logits).numpy() - ref["moe_logits"]).max()),
        "aux_err": abs(float(whole(aux)) - float(ref["moe_aux"]))}

    # -- each DP shard's routed output at the default capacity against the
    # reference's _moe_local on that shard's tokens alone
    cfg_d = dataclasses.replace(moe_cfg(1.25), n_shared_experts=0)
    lp = {k: v[0] for k, v in params["seg1"]["moe"].items()
          if k != "shared"}
    x = torch.from_numpy(moe_input(cfg_d))
    lpd = place(lp, param_specs({"moe": lp}, ax, cfg_d)["moe"], mesh)
    xd = place({"x": x}, {"x": batch_specs(cfg_d, ax, {"x": x})["x"]},
                     mesh)["x"]
    with record_collectives(mesh) as coll:
        y, _ = L.moe_apply(lpd, xd, cfg_d, ctx)
    y = whole(y).numpy()
    half = B // ax.dp_size
    out["moe_local_shards"] = {"err": max(
        float(np.abs(y[i * half:(i + 1) * half].reshape(-1, cfg_d.d_model)
                     - ref[f"moe_local_{i}"]).max())
        for i in range(ax.dp_size))}
    # -- its collectives: one all-reduce over "model" of the shard's output
    t_local = B * S // ax.dp_size
    out["moe_collectives"] = {
        "all_reduce_model_out": sum(
            1 for c in coll if c.kind == "all-reduce" and c.axis == "model"
            and c.shape == (half, S, cfg_d.d_model) and c.dtype == "f32"),
        "bytes": t_local * cfg_d.d_model * 4,
        "records": [list(map(str, c)) for c in coll]}

    # -- the split-projection Mamba forward against the reference's
    c = split_cfg()
    pc = weights(c)
    b = {"tokens": torch.from_numpy(tokens(c))}
    d1, d2 = placed(c, pc, b)
    lg, _ = forward(c, d1, d2, ctx, remat="none", q_chunk=S)
    out["forward_split"] = {
        "err": float(np.abs(whole(lg).numpy() - ref["split_logits"]).max())}

    # -- a kernel wrapper handed a DTensor raises
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd.ops import ssd_scan

    from torch.distributed.tensor import Replicate, distribute_tensor

    q = distribute_tensor(torch.zeros(B, 8, 4, 8), mesh,
                          [Replicate(), Replicate()])
    raised = []
    for call in (lambda: flash_attention(q, q, q),
                 lambda: ssd_scan(q, q[..., 0], q[0, 0, :, 0], q[:, :, 0],
                                  q[:, :, 0], q[0, 0, :, 0], chunk=8)):
        try:
            call()
            raised.append(False)
        except TypeError:
            raised.append(True)
    out["kernel_refuses_dtensor"] = {"ok": all(raised)}
    return out


def main(argv):
    init, rank, world, ref_path, out_path = argv
    rank, world = int(rank), int(world)
    os.environ["REPRO_TORCH_DEVICE"] = "cpu"
    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    from repro_torch.launch.mesh import make_mesh

    try:
        results = run(make_mesh((2, 2), ("data", "model")), Refs(ref_path),
                      os.path.join(os.path.dirname(out_path), "ckpt"))
        code = 0
    except Exception:
        results = {"error": traceback.format_exc()}
        code = 1
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(results, f)
    dist.destroy_process_group()
    return code


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
