"""The port's sharding rules (``repro_torch.distributed.sharding``), shape
stand-ins (``repro_torch.launch.specs``), shape cells, elastic mesh choice
and collective pricing against the reference's, with no process group.

The reference's rules run on ``jax.sharding.AbstractMesh`` meshes of shape
(16, 16), (2, 16, 16) with ``pod`` and (2, 2); the port's on the same
``(shape, names)`` descriptors.  Every parameter, optimizer-moment, cache
and batch spec is held equal leaf for leaf, for the ten configs with
``q_head_pad_multiple=16`` (as ``tests/test_sharding_rules.py`` takes
them) and the two Mamba configs in the split-projection layout; the
parameter and moment specs must divide their dims evenly, as the
reference's checker demands at its ``jit`` boundary.  Nothing is
allocated: the reference's shapes come from ``jax.eval_shape``, the
port's from meta tensors.
"""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

import repro.configs as ref_configs
import repro.distributed.elastic as ref_elastic
import repro.distributed.hlo_analysis as ref_hlo
import repro.distributed.sharding as ref_sharding
import repro.launch.specs as ref_specs
from repro_torch import configs
from repro_torch.distributed import (MeshAxes, Spec, batch_specs,
                                     cache_specs, choose_mesh_shape,
                                     collective_bytes, opt_state_specs,
                                     param_specs)
from repro_torch.launch import specs
from repro_torch.tree import leaves_with_paths

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
}
CONFIGS = list(configs.ARCH_NAMES) + ["mamba2-130m+split", "zamba2-7b+split"]
# the configs with a decode cache (hubert-xlarge is encoder-only)
DECODERS = [n for n in CONFIGS if n != "hubert-xlarge"]


def _cfg(mod, name):
    base, _, split = name.partition("+")
    cfg = dataclasses.replace(mod.get_config(base), q_head_pad_multiple=16)
    return dataclasses.replace(cfg, ssm_split_proj=True) if split else cfg


def _ref_flat(tree):
    """{path: leaf} of a reference tree (PartitionSpecs or shape structs)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {ref_sharding._path_str(p): leaf for p, leaf in flat}


def _port_flat(shapes, spec_tree):
    """{path: Spec} of a port spec tree, walked along its shape tree (a
    ``Spec`` is a tuple, so the spec tree itself is not walked)."""
    out = {}
    for path, _ in leaves_with_paths(shapes):
        node = spec_tree
        for part in path.split("/"):
            node = getattr(node, part[1:]) if part.startswith(".") else \
                node[part]
        out[path] = node
    return out


@pytest.fixture(scope="module")
def shapes():
    """name -> (port cfg, ref cfg, port params, ref params), meta / eval
    shapes only."""
    out = {}
    for name in CONFIGS:
        cfg, jcfg = _cfg(configs, name), _cfg(ref_configs, name)
        out[name] = (cfg, jcfg, specs.params_shape(cfg),
                     ref_specs.params_shape(jcfg))
    return out


def _axes(mesh):
    shape, names = MESHES[mesh]
    return MeshAxes((shape, names)), ref_sharding.MeshAxes(
        AbstractMesh(shape, names))


@pytest.mark.parametrize("name", CONFIGS)
def test_params_shape_matches_the_reference(shapes, name):
    _, _, p, jp = shapes[name]
    ref = _ref_flat(jp)
    got = {k: v for k, v in leaves_with_paths(p)}
    assert list(got) == list(ref)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(ref[k].shape), k
        assert str(t.dtype).split(".")[-1] == ref[k].dtype.name, k


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_param_specs_match_the_reference(shapes, name, mesh):
    cfg, jcfg, p, jp = shapes[name]
    ax, jax_ = _axes(mesh)
    got = _port_flat(p, param_specs(p, ax, cfg))
    ref = _ref_flat(ref_sharding.param_specs(jp, jax_, jcfg))
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in ref.items()}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_opt_state_specs_match_the_reference(shapes, name, mesh):
    cfg, jcfg, p, jp = shapes[name]
    ax, jax_ = _axes(mesh)
    got = _port_flat(p, opt_state_specs(p, ax, cfg))
    ref = _ref_flat(ref_sharding.opt_state_specs(jp, jax_, jcfg))
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in ref.items()}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_specs_divide_evenly_and_name_each_axis_once(shapes, name, mesh):
    cfg, _, p, _ = shapes[name]
    ax, _ = _axes(mesh)
    for tag, tree in (("param", param_specs(p, ax, cfg)),
                      ("opt", opt_state_specs(p, ax, cfg))):
        for path, spec in _port_flat(p, tree).items():
            shape = dict(leaves_with_paths(p))[path].shape
            names = [a for e in spec if e is not None
                     for a in (e if isinstance(e, tuple) else (e,))]
            assert len(names) == len(set(names)), (tag, path, spec)
            for dim, entry in zip(shape, spec):
                if entry is not None:
                    n = int(np.prod([ax.shape[a] for a in (
                        entry if isinstance(entry, tuple) else (entry,))]))
                    assert dim % n == 0, (tag, path, spec, tuple(shape))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", DECODERS)
def test_cache_specs_match_the_reference(name, mesh):
    cfg, jcfg = _cfg(configs, name), _cfg(ref_configs, name)
    assert cfg.supports_decode
    ax, jax_ = _axes(mesh)
    c = specs.cache_shape(cfg, 128, 1024)
    jc = ref_specs.cache_shape(jcfg, 128, 1024)
    ref_shapes = _ref_flat(jc)
    assert {k: tuple(t.shape) for k, t in leaves_with_paths(c)} == \
        {k: tuple(v.shape) for k, v in ref_shapes.items()}
    got = _port_flat(c, cache_specs(c, ax, cfg))
    ref = _ref_flat(ref_sharding.cache_specs(jc, jax_, jcfg))
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in ref.items()}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_input_and_batch_specs_match_the_reference(name, mesh):
    cfg, jcfg = _cfg(configs, name), _cfg(ref_configs, name)
    ax, jax_ = _axes(mesh)
    for shape in configs.SHAPES.values():
        b = specs.input_specs(cfg, shape)
        jb = ref_specs.input_specs(jcfg, ref_configs.get_shape(shape.name))
        assert {k: (tuple(t.shape), str(t.dtype).split(".")[-1])
                for k, t in b.items()} == \
            {k: (tuple(v.shape), v.dtype.name) for k, v in jb.items()}
        # a decode step's scalar ``pos`` is placed apart (replicated)
        got = batch_specs(cfg, ax, {k: t for k, t in b.items() if t.ndim})
        ref = ref_sharding.batch_specs(
            jcfg, jax_, {k: v for k, v in jb.items() if v.shape})
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in ref.items()}


def test_shape_cells_match_the_reference():
    got = [(c.name, s, ok, why) for c, s, ok, why in configs.all_cells(
        [configs.get_config(n) for n in configs.ARCH_NAMES])]
    ref = [(c.name, s, ok, why) for c, s, ok, why in ref_configs.all_cells(
        [ref_configs.get_config(n) for n in ref_configs.ARCH_NAMES])]
    assert len(got) == 40
    assert [(n, dataclasses.asdict(s), ok, why) for n, s, ok, why in got] \
        == [(n, dataclasses.asdict(s), ok, why) for n, s, ok, why in ref]
    assert configs.get_shape("long_500k") == configs.SHAPES["long_500k"]


@pytest.mark.parametrize("model_axis", [None, 1, 2, 4, 8, 16, 3])
def test_choose_mesh_shape_matches_the_reference(model_axis):
    for n in range(1, 513):
        assert choose_mesh_shape(n, model_axis=model_axis) == \
            ref_elastic.choose_mesh_shape(n, model_axis=model_axis), n


def test_collective_pricing_matches_hlo_analysis():
    rng = np.random.default_rng(0)
    kinds = ["all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute"]
    dtypes = ["f32", "bf16", "s32", "s8", "f64", "u16"]
    records, lines = [], []
    for i in range(60):
        kind = kinds[i % len(kinds)]
        dtype = dtypes[int(rng.integers(len(dtypes)))]
        shape = tuple(int(d) for d in rng.integers(1, 64, int(
            rng.integers(0, 4))))
        records.append((kind, shape, dtype))
        dims = ",".join(map(str, shape))
        lines.append(f"  %x{i} = {dtype}[{dims}] {kind}(%p{i}), "
                     f"replica_groups={{}}")
    want = ref_hlo.collective_bytes("\n".join(lines))
    got = collective_bytes(records)
    assert got == want


def test_spec_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import placements

    class FakeMesh:
        mesh_dim_names = ("pod", "data", "model")

    got = placements(Spec(("pod", "data"), None, "model"), FakeMesh())
    assert got == (Shard(0), Shard(0), Shard(2))
    assert placements(Spec(None, None), FakeMesh()) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        placements(Spec(("data", "pod"), None), FakeMesh())
    with pytest.raises(ValueError):
        placements(Spec("data", "data"), FakeMesh())
