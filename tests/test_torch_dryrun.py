"""The port's dry-run (``repro_torch.launch.dryrun``) held to the
reference's arithmetic, piece by piece, on the CPU.

The reference's own dry-run cannot run here (its reduced cells fail under
this jax), so the port is held to its rules rather than its output: the
sweep's cells and skip reasons, the microbatch auto-fit, the decode cells'
mandatory bytes (integers from the reference's ``cache_specs`` and
``cache_shape`` on an ``AbstractMesh``), the level extrapolation against a
full-depth count, per-rank (local) counting on a fake mesh, the tracker on
a fake trace against the same tracker on the real step, and the kernels'
shape-only routes.  ``record_collectives`` is held to the collective
DTensor issues inside an op.  Every fake process group is destroyed by the
``no_group`` fixture, even when a test fails.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

import repro.configs as ref_configs
import repro.distributed.sharding as ref_sharding
import repro.launch.specs as ref_specs
from repro_torch.configs import ShapeSpec, get_config, get_shape
from repro_torch.distributed import record_collectives
from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import attention_plain
from repro_torch.kernels.ssd import ops as sd
from repro_torch.kernels.ssd.ref import ssd_scan_plain
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, one_rank_mesh

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
DECODERS = [a for a in ref_configs.ARCH_NAMES if a != "hubert-xlarge"]


@pytest.fixture(autouse=True)
def no_group():
    """No process group outlives a test (the file shares an xdist worker
    with other files that make groups)."""
    yield
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


# ----------------------------------------------------------------- (a), (b)
def test_sweep_cells_and_skips_equal_the_references():
    got = dryrun.cells(("single",))
    ref_cells = list(ref_configs.all_cells(
        [ref_configs.get_config(a) for a in ref_configs.ARCH_NAMES]))
    assert got == [(c.name, s.name, "single") for c, s, _, _ in ref_cells]
    assert len(got) == 40
    runnable = 0
    for (arch, shape, mesh), (_, _, ok, why) in zip(got, ref_cells):
        if ok:
            runnable += 1
            continue
        assert dryrun.run_cell(arch, shape, mesh) == {
            "arch": arch, "shape": shape, "mesh": mesh,
            "status": "skipped", "reason": why}
    assert runnable == 32


def _ref_attempts(shape):
    """``repro/launch/dryrun.py``'s auto-fit rule, as it is written there."""
    if shape.kind == "train":
        micro_opts = [1, 2, 4, 8, 16]
    elif shape.kind == "prefill":
        micro_opts = [1, 2]
    else:
        micro_opts = [1]
    per_dev_batch = max(shape.global_batch // 16, 1)
    micro_opts = [m for m in micro_opts if per_dev_batch % m == 0] or [1]
    attempts = [(m, jnp.float32) for m in micro_opts]
    if shape.kind == "train":
        attempts.append((micro_opts[-1], jnp.bfloat16))
    return attempts


def test_microbatch_attempts_follow_the_references_rule():
    dtypes = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    for cfg, shape, ok, _ in ref_configs.all_cells(
            [ref_configs.get_config(a) for a in ref_configs.ARCH_NAMES]):
        if not ok:
            continue
        got = dryrun.micro_attempts(get_shape(shape.name))
        assert [(m, dtypes[d]) for m, d in got] == _ref_attempts(shape), \
            (cfg.name, shape.name)


# ---------------------------------------------------------------------- (c)
def _ref_mandatory(arch, shape_name, mesh):
    """The reference's decode floor (``dryrun.py:129-156``) on an
    ``AbstractMesh``: (cache bytes per chip, mandatory bytes per chip)."""
    shape, names = MESHES[mesh]
    amesh = AbstractMesh(shape, names)
    cfg = ref_configs.get_config(arch)
    sh = ref_configs.get_shape(shape_name)
    c = ref_specs.cache_shape(cfg, sh.global_batch, sh.seq_len)
    cspec = ref_sharding.cache_specs(c, ref_sharding.MeshAxes(amesh), cfg)
    import jax

    def dev_bytes(leaf, spec):
        shards = 1
        for e in spec:
            if e is None:
                continue
            for a in (e if isinstance(e, tuple) else (e,)):
                shards *= dict(zip(names, shape))[a]
        return int(np.prod(leaf.shape)) * leaf.dtype.itemsize // shards

    cache_dev = sum(dev_bytes(leaf, sp) for leaf, sp in zip(
        jax.tree.leaves(c), jax.tree.leaves(
            cspec, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
    return cache_dev, float(2 * cfg.param_count() / int(np.prod(shape))
                            + cache_dev)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", DECODERS)
def test_mandatory_bytes_equal_the_references(arch, mesh):
    for shape_name in ("decode_32k", "long_500k"):
        cfg, sh = get_config(arch), get_shape(shape_name)
        if not ref_configs.cell_is_runnable(ref_configs.get_config(arch),
                                            ref_configs.get_shape(
                                                shape_name))[0]:
            continue
        got = dryrun.mandatory_bytes(cfg, sh, MESHES[mesh])
        assert got == _ref_mandatory(arch, shape_name, mesh)
        assert isinstance(got[0], int) and got[0] > 0


# ---------------------------------------------------------------------- (d)
@pytest.mark.parametrize("arch, kind, cut", [
    ("qwen3-14b", "train", {}),
    ("deepseek-moe-16b", "prefill", {"num_layers": 5}),
    # the second shared-attention application past L2, as in zamba2-7b
    ("zamba2-7b", "prefill", {"num_layers": 6, "hybrid_attn_every": 4})])
def test_level_extrapolation_equals_a_full_depth_count(arch, kind, cut):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              q_head_pad_multiple=2, **cut)
    shape = ShapeSpec("small", 32, 4, kind)
    levels = dryrun.cost_levels(cfg)
    assert cfg.num_layers > levels[1]
    with dryrun.fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cuda")
        costs = dryrun.level_costs(cfg, shape, mesh, levels)
        full = dryrun.trace_cell(cfg, shape, mesh)
    assert dryrun.combine(cfg, costs, levels, "flops") == full["flops"] > 0
    assert dryrun.combine(cfg, costs, levels, "bytes") == full["bytes"] > 0
    assert dryrun.combine(cfg, costs, levels, "ici_bytes") == \
        full["coll"]["ici_bytes"]


# ---------------------------------------------------------------------- (e)
def test_a_tp_projection_is_counted_at_its_local_shapes():
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with dryrun.fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cuda")
        with dryrun.fake_mode():
            dev = dryrun.trace_device()
            x = DTensor.from_local(torch.empty(4, 16, device=dev), mesh,
                                   [Shard(0), Replicate()], run_check=False,
                                   shape=(8, 16), stride=(16, 1))
            w = DTensor.from_local(torch.empty(16, 16, device=dev), mesh,
                                   [Replicate(), Shard(1)], run_check=False,
                                   shape=(16, 32), stride=(32, 1))
            got = dryrun.track(lambda a, b: a @ b, x, w, mesh=mesh)
    # the rank's (4, 16) @ (16, 16), not the global (8, 16) @ (16, 32)
    assert got["flops"] == 2 * 4 * 16 * 16
    assert got["bytes"] == 4 * (4 * 16 + 16 * 16 + 4 * 16)
    assert got["input_bytes"] == 512 + 1024
    assert got["peak_bytes"] == 512 + 1024 + 512
    assert got["coll"]["counts"] == {}


def test_the_recorder_sees_the_all_gather_dtensor_issues_inside_an_op():
    """``y @ w2`` needs y's columns whole over "model": DTensor gathers them
    inside the product's dispatch, where a mode on the stack used to be
    popped."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    gen = torch.Generator().manual_seed(0)
    with dryrun.fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        x = distribute_tensor(torch.randn(8, 16, generator=gen), mesh,
                              [Shard(0), Replicate()])
        w1 = distribute_tensor(torch.randn(16, 32, generator=gen), mesh,
                               [Replicate(), Shard(1)])
        w2 = distribute_tensor(torch.randn(32, 32, generator=gen), mesh,
                               [Replicate(), Shard(1)])
        with record_collectives(mesh) as rec:
            y = x @ w1
            y @ w2
        local = y.to_local()
    assert len(rec) == 1
    kind, shape, dtype, axis = rec[0]
    # y's (4, 16) shard stacked over the 2 ranks of "model" on dim 0
    assert (kind, axis, dtype) == ("all-gather", "model", "f32")
    assert shape == (2 * local.shape[0], local.shape[1]) == (8, 16)


# ---------------------------------------------------------------------- (f)
def test_a_fake_trace_equals_the_same_tracker_on_the_real_step(tmp_path):
    """A reduced train step on a one-rank mesh: the fake trace's peak and
    counts equal the tracker's on the real step (gloo, CPU), exactly."""
    from repro_torch.distributed.sharding import place
    from repro_torch.launch import specs as S
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.tree import tree_map

    cfg = get_config("qwen3-14b").reduced()
    p = S.params_shape(cfg, dtype=torch.float32)
    o = S.opt_shape(p)
    b = S.input_specs(cfg, ShapeSpec("small", 32, 4, "train"))
    with dryrun.fake_group(1):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        fake = dryrun.trace_step("train", cfg, mesh, (p, o, b),
                                 device="cpu", q_chunk=32)
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda t: torch.randn(t.shape, generator=gen) * 0.02, p)
    batch = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype), b)
    with one_rank_mesh(tmp_path, "cpu") as mesh:
        step, specs = dryrun.mesh_step("train", cfg, mesh, (p, o, b),
                                       q_chunk=32)
        placed = [place(a, sp, mesh) for a, sp in zip(
            (params, init_opt_state(params), batch), specs)]
        real = dryrun.track(step, *placed, mesh=mesh)
    for key in ("peak_bytes", "input_bytes", "flops", "bytes",
                "kernel_calls"):
        assert fake[key] == real[key], key
    assert fake["peak_bytes"] > fake["input_bytes"] > 0


# ---------------------------------------------------------------------- (g)
def test_shape_only_routes_allocate_the_outputs_and_load_nothing(
        monkeypatch):
    def refuse():
        raise AssertionError("the shape-only route loaded the library")

    monkeypatch.setattr(runtime, "load_library", refuse)
    gen = torch.Generator().manual_seed(0)
    cases = [((1, 64, 4, 2, 64, 64), 0), ((1, 64, 2, 2, 192, 128), 16)]
    real = {}
    for (b, s, h, kh, d, dv), window in cases:
        q = torch.randn(b, s, h, d, generator=gen)
        k = torch.randn(b, s, kh, d, generator=gen)
        v = torch.randn(b, s, kh, dv, generator=gen)
        real[d] = attention_plain(q, k, v, causal=True, window=window)
    x = torch.randn(1, 32, 2, 8, generator=gen)
    dt = torch.rand(1, 32, 2, generator=gen)
    bc = torch.randn(1, 32, 8, generator=gen)
    a_neg, dd = -torch.rand(2, generator=gen), torch.rand(2, generator=gen)
    real["ssd"] = ssd_scan_plain(x, dt, a_neg, bc, bc, dd, chunk=8)

    calls = []
    before = (fa.LAUNCHES, fa.WIDE_LAUNCHES, sd.LAUNCHES)
    monkeypatch.setattr(runtime, "SHAPE_ONLY_HOOKS",
                        [lambda *a: calls.append(a)])
    with dryrun.fake_mode():
        dev = dryrun.trace_device()
        got = {}
        for (b, s, h, kh, d, dv), window in cases:
            got[d] = fa.flash_attention(
                torch.empty(b, s, h, d, device=dev),
                torch.empty(b, s, kh, d, device=dev),
                torch.empty(b, s, kh, dv, device=dev), window=window)
        got["ssd"] = sd.ssd_scan(
            torch.empty(x.shape, device=dev), torch.empty(dt.shape,
                                                          device=dev),
            torch.empty(2, device=dev), torch.empty(bc.shape, device=dev),
            torch.empty(bc.shape, device=dev), torch.empty(2, device=dev),
            chunk=8)
    for key, ref in real.items():
        assert runtime.is_fake(got[key])
        assert (tuple(got[key].shape), got[key].dtype) == \
            (tuple(ref.shape), ref.dtype), key
    assert [c[0] for c in calls] == ["flash_attention",
                                     "flash_attention_wide", "ssd"]
    assert all(ops > 0 and nbytes > 0 for _, ops, nbytes in calls)
    assert (fa.LAUNCHES, fa.WIDE_LAUNCHES, sd.LAUNCHES) == before
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        t = torch.empty(1, 64, 4, 64, device="meta")  # real, not fake
        fa.flash_attention(t, t, t)


# ---------------------------------------------------------------------- (h)
@pytest.mark.parametrize("arch", ["qwen3-14b", "deepseek-moe-16b",
                                  "mamba2-130m", "zamba2-7b",
                                  "hubert-xlarge"])
def test_the_ci_cell_traces(arch):
    res = dryrun.run_test_cell(arch)
    assert res["status"] == "ok" and res["temp_bytes"] > 0
    assert res["kernel_calls"]
    assert not dist.is_initialized()


def test_the_cli_prints_the_ci_cell(capsys):
    assert dryrun.main(["--test-cell", "hubert-xlarge"]) == 0
    assert '"status": "ok"' in capsys.readouterr().out.splitlines()[-1]
    assert not dist.is_initialized()
