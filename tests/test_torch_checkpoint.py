"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``): a checkpoint written by either package
restores in the other, bit for bit, and the two packages write the same
manifest, name for name, for the same ``(params, opt)``.  The state is the
reduced mamba2-130m's parameters from the reference's ``init_params`` and
its AdamW state after one update (nonzero moments, step 1).  Also: keep-N,
a crashed ``.tmp-`` directory ignored, ``LATEST`` ahead of a crash, the
async writer, and the refusals (shape, leaf count, bf16).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as ref_ckpt
import repro.configs as ref_configs
import repro.models as ref_models
import repro.optim.adamw as ref_adamw
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.models import params_from_numpy
from repro_torch.optim import OptState, init_opt_state
from repro_torch.tree import leaves, tree_map


@pytest.fixture(scope="module")
def states():
    """(the reference's (params, opt), the port's same state)."""
    jcfg = ref_configs.get_config("mamba2-130m").reduced()
    jp = ref_models.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jo = ref_adamw.init_opt_state(jp)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, jnp.float32), jp)
    jp, jo, _ = ref_adamw.adamw_update(ref_adamw.AdamWConfig(), jp, grads, jo)
    cfg = get_config("mamba2-130m").reduced()
    host = jax.tree.map(np.asarray, (jp, jo))
    params = params_from_numpy(cfg, host[0], "cpu")
    opt = OptState(step=torch.tensor(int(jo.step), dtype=torch.int32),
                   mu=params_from_numpy(cfg, host[1].mu, "cpu"),
                   nu=params_from_numpy(cfg, host[1].nu, "cpu"))
    return (jp, jo), (params, opt)


def manifest(root, step):
    with open(os.path.join(root, f"step_{step:09d}", "manifest.json")) as f:
        return json.load(f)


def zeros_like_port(state):
    return tree_map(torch.zeros_like, state)


def test_same_manifest_name_for_name(states, tmp_path):
    ref_state, port_state = states
    ref_ckpt.save(str(tmp_path / "ref"), 1, ref_state)
    ckpt.save(str(tmp_path / "port"), 1, port_state)
    want, got = manifest(tmp_path / "ref", 1), manifest(tmp_path / "port", 1)
    assert got == want
    names = [e["name"] for e in got["leaves"]]
    assert names[0] == "0/embed" and "1/.step" in names
    assert any(n.startswith("1/.mu/seg0/mixer/") for n in names)
    for entry in got["leaves"]:
        a = np.load(tmp_path / "port" / "step_000000001" / entry["file"])
        b = np.load(tmp_path / "ref" / "step_000000001" / entry["file"])
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_reference_checkpoint_restores_in_the_port(states, tmp_path):
    ref_state, port_state = states
    ref_ckpt.save(str(tmp_path), 7, ref_state)
    got, step = ckpt.restore(str(tmp_path), zeros_like_port(port_state))
    assert step == 7 and isinstance(got[1], OptState)
    assert got[1].step.dtype == torch.int32 and int(got[1].step) == 1
    for a, b in zip(leaves(got), leaves(port_state)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_port_checkpoint_restores_in_the_reference(states, tmp_path):
    ref_state, port_state = states
    ckpt.save(str(tmp_path), 7, port_state)
    like = jax.tree.map(jnp.zeros_like, ref_state)
    got, step = ref_ckpt.restore(str(tmp_path), like)
    assert step == 7
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref_state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def small_state(k=0.0):
    params = {"w": torch.full((4, 3), k), "b": {"x": torch.arange(5.0) + k}}
    return params, init_opt_state(params)


def test_latest_and_keep_n(tmp_path):
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, small_state(float(s)), keep_n=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_000000003",
                                            "step_000000004"]
    got, step = ckpt.restore(str(tmp_path), small_state(), step=3)
    assert step == 3 and float(got[0]["w"][0, 0]) == 3.0


def test_crashed_tmp_dir_and_pointer_ahead_are_ignored(tmp_path):
    ckpt.save(str(tmp_path), 1, small_state(1.0))
    os.makedirs(tmp_path / ".tmp-000000002")  # a crash mid-write
    assert ckpt.latest_step(str(tmp_path)) == 1
    (tmp_path / "LATEST").write_text("2")  # the pointer ahead of the crash
    assert ckpt.latest_step(str(tmp_path)) == 1
    got, step = ckpt.restore(str(tmp_path), small_state())
    assert step == 1 and float(got[0]["b"]["x"][0]) == 1.0
    ckpt.save(str(tmp_path), 2, small_state(2.0))  # the retried write
    assert not (tmp_path / ".tmp-000000002").exists()
    assert ckpt.latest_step(str(tmp_path)) == 2


def test_async_checkpointer_snapshots_at_save(tmp_path):
    w = ckpt.AsyncCheckpointer(str(tmp_path), keep_n=2)
    state = small_state(1.0)
    w.save(5, state)
    state[0]["w"].fill_(9.0)  # written after save(): not in the checkpoint
    w.wait()
    got, step = ckpt.restore(str(tmp_path), small_state())
    assert step == 5 and float(got[0]["w"].max()) == 1.0


def test_async_checkpointer_raises_on_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    w = ckpt.AsyncCheckpointer(str(blocker / "sub"))
    w.save(1, small_state())
    with pytest.raises(OSError):
        w.wait()
    w.wait()  # the error is raised once


def test_refusals(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), small_state())
    ckpt.save(str(tmp_path), 1, small_state())
    params, opt = small_state()
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path),
                     ({"w": torch.zeros(3, 4), "b": params["b"]}, opt))
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), (params,))
    half = ({"w": torch.zeros(4, 3, dtype=torch.bfloat16), "b": params["b"]},
            opt)
    with pytest.raises(TypeError, match="A.12"):
        ckpt.save(str(tmp_path), 2, half)
    with pytest.raises(TypeError, match="A.12"):
        ckpt.restore(str(tmp_path), half)
    assert ckpt.latest_step(str(tmp_path)) == 1
