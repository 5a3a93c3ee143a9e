"""The port's sharded paths on a (2, 2) ("data", "model") mesh of four CPU
processes (gloo), held to the reference's single-device math and to the
unsharded port, on two-layer cuts of the reduced configs (deepseek-moe-16b:
one dense layer, one MoE layer).

The reference's own sharded paths are not the oracle (its ``shard_map``
MoE test and its dry-run cells fail on this machine), so the sharded port
is held to what the reference computes on one device from the same
weights: the MoE model's forward and aux within the reference's own 5e-4
(``tests/test_distributed_numerics.py``) at ``capacity_factor`` 8.0, where
no token is dropped; at the default 1.25 each DP shard's routed output
within 1e-5 of the reference's ``_moe_local`` on that shard's tokens alone
(capacity from the shard's token count); the split-projection Mamba2
forward within 1e-4 of the reference's.  Against the unsharded port: one
``jit_train_step`` (loss within 1e-5, every parameter and moment within
1e-5), the same with two microbatches and a chunked prefill, prefill and 4 greedy decode steps on the sequence-sharded cache
(logits and caches within 1e-4, the same tokens) for the MoE model, a GQA
model with one KV head (replicated over "model"), the MLA model (its
latent cache sequence-sharded) and the split-projection Mamba; ``reshard_state`` to (4, 1), (1, 4) and back, and a checkpoint
saved on the mesh and restored without one, bit for bit; ``train(mesh=)``
cut by a failure and resumed onto the mesh, its losses within 1e-5 of the
unsharded ``train()``'s; the MoE layer's one all-reduce over "model"
of T_local x D x 4 bytes; a kernel wrapper refusing a DTensor.

One spawn per module: ``tests/torch_mesh_worker.py`` runs every check on
each of four subprocesses and rank 0 writes the results; the tests read
them from a module-scoped fixture.  The reference's numbers are computed
here, in the parent, from the same seeded weights and numpy inputs, while
the ranks run their other checks.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as ref_configs
import repro.models as ref_models
import repro.models.layers as ref_layers
import torch_mesh_worker as W
from repro_torch.tree import tree_map

WORLD = 4
REF_TOL, MOE_TOL, TOL, STEP_TOL = 5e-4, 1e-5, 1e-4, 1e-5
ROOT = Path(__file__).resolve().parents[1]


def _ref_tree(params):
    return jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), params))


def _references():
    """The reference's numbers on the port's seeded weights."""
    out = {}
    cfg = W.moe_cfg()
    jcfg = dataclasses.replace(
        ref_configs.get_config("deepseek-moe-16b").reduced(),
        capacity_factor=8.0, num_layers=W.LAYERS)
    jp = _ref_tree(W.weights(cfg))
    logits, aux = ref_models.forward(
        jcfg, jp, {"tokens": jnp.asarray(W.tokens(cfg))}, q_chunk=W.S,
        remat="none")
    out["moe_logits"], out["moe_aux"] = np.asarray(logits), np.asarray(aux)
    # the routed experts of layer 0 of the MoE segment, per DP shard
    lp = {k: v[0] for k, v in jp["seg1"]["moe"].items() if k != "shared"}
    x = W.moe_input(cfg)
    half = W.B // 2
    t_local = half * W.S
    dcfg = dataclasses.replace(jcfg, capacity_factor=1.25)
    cap = min(max(1, int(t_local * dcfg.moe_top_k * dcfg.capacity_factor)
                  // dcfg.n_routed_experts), t_local)
    for i in range(2):
        y, _ = ref_layers._moe_local(
            lp, jnp.asarray(x[i * half:(i + 1) * half].reshape(t_local, -1)),
            top_k=dcfg.moe_top_k, capacity=cap, tp_axis=None)
        out[f"moe_local_{i}"] = np.asarray(y)
    scfg = W.split_cfg()
    jscfg = dataclasses.replace(
        ref_configs.get_config("mamba2-130m").reduced(), ssm_split_proj=True,
        num_layers=W.LAYERS)
    split_logits, _ = ref_models.forward(
        jscfg, _ref_tree(W.weights(scfg)),
        {"tokens": jnp.asarray(W.tokens(scfg))}, remat="none")
    out["split_logits"] = np.asarray(split_logits)
    return out


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """The worker's results, by check name."""
    tmp = tmp_path_factory.mktemp("mesh")
    ref_path, out_path = tmp / "ref.npz", tmp / "out.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "REPRO_TORCH_DEVICE": "cpu", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_worker.py"),
         str(tmp / "pg"), str(r), str(WORLD), str(ref_path), str(out_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    logs = []
    try:
        # the reference's numbers while the ranks start (they read them
        # last), written whole by a rename
        np.savez(tmp / "ref.tmp.npz", **_references())
        os.replace(tmp / "ref.tmp.npz", ref_path)
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode()[-3000:])
    finally:
        for p in procs:
            p.kill()
    assert out_path.exists(), "\n".join(logs)
    results = json.loads(out_path.read_text())
    assert "error" not in results, results.get("error")
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return results


def test_moe_forward_and_aux_match_the_reference(mesh):
    r = mesh["moe_forward"]
    assert r["err"] < REF_TOL and r["aux_err"] < REF_TOL, r


def test_each_dp_shard_routes_as_the_reference_on_its_tokens(mesh):
    assert mesh["moe_local_shards"]["err"] < MOE_TOL, mesh["moe_local_shards"]


def test_moe_all_reduces_its_output_once_over_model(mesh):
    r = mesh["moe_collectives"]
    assert r["all_reduce_model_out"] == 1, r["records"]
    assert r["bytes"] == W.B // 2 * W.S * W.moe_cfg().d_model * 4


def test_train_step_matches_the_unsharded_step(mesh):
    r = mesh["train_step"]
    assert r["placed"] and r["kept"], r
    assert r["loss_err"] < STEP_TOL and r["err"] < STEP_TOL, r


def test_microbatched_train_and_prefill_match_the_unsharded_port(mesh):
    r = mesh["n_micro"]
    assert r["loss_err"] < STEP_TOL and r["err"] < STEP_TOL, r
    assert r["prefill_err"] < TOL and r["cache_err"] < TOL, r


@pytest.mark.parametrize("name", ["moe", "gqa1", "mla", "split"])
def test_prefill_and_decode_on_the_sequence_sharded_cache(mesh, name):
    r = mesh[f"serve_{name}"]
    assert r["same_tokens"] and r["seq_sharded"], r
    assert r["err"] < TOL and r["cache_err"] < TOL, r


def test_replicated_kv_heads_forward_matches_the_unsharded_port(mesh):
    assert mesh["forward_gqa1"]["err"] < TOL, mesh["forward_gqa1"]


def test_split_projection_forward_matches_the_reference(mesh):
    assert mesh["forward_split"]["err"] < TOL, mesh["forward_split"]


def test_reshard_state_across_meshes_is_bit_for_bit(mesh):
    assert mesh["reshard"]["ok"]


def test_checkpoint_on_the_mesh_restores_without_one(mesh):
    assert mesh["checkpoint"]["ok"]


def test_train_on_the_mesh_resumes_after_a_failure(mesh):
    r = mesh["train_mesh"]
    assert r["failed"] and r["resumed_from"] == 1, r
    assert r["err"] <= STEP_TOL, r


def test_kernel_wrappers_refuse_a_dtensor(mesh):
    assert mesh["kernel_refuses_dtensor"]["ok"]
