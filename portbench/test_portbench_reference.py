"""The plain reference against the port (``repro_torch``) on the CPU at a
tiny size of both families, and the weights the benchmark draws in the
port's layout."""

import numpy as np
import pytest
import torch

from portbench import check, harness, weights as W
from portbench.conftest import tiny_config
from portbench.reference import model as R
from portbench.reference.vet import vet_window
from portbench.traffic import Traffic

CONFIGS = ["deepseek-moe-16b", "deepseek-v2-lite-16b"]


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, prefix + (k,))
    else:
        yield prefix, tuple(tree.shape), tree.dtype


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_in_the_port_layout(name):
    from repro_torch.models import init_params

    c = tiny_config(name)
    port = init_params(harness.port_config(c), torch.Generator().manual_seed(0))
    ours = W.make(c, 2 ** 31 + 3, "cpu")
    assert sorted(flat(ours)) == sorted(flat(port))
    again = W.make(c, 2 ** 31 + 3, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        (t for _, t in sorted(_leaves(ours))),
        (t for _, t in sorted(_leaves(again)))))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mix", [
    {"batch": 1, "prompt_lengths": [48], "gen_tokens": 1},
    {"batch": 2, "prompt_lengths": [32], "gen_tokens": 6}],
    ids=["prefill", "decode"])
def test_reference_follows_the_port(name, mix):
    c = tiny_config(name)
    mix = dict(mix, dashboard=None)
    params = W.make(c, 11, "cpu")
    server = harness.Server(harness.port_config(c), params, mix,
                            torch.device("cpu"))
    traffic = Traffic(mix, c["vocab_size"], 11)
    got = [server.serve(traffic.request(i), harness.Spans(), keep=True)
           for i in range(2)]
    nums = check.judge(c, params, got)
    assert nums["route_gap"] == 0.0
    assert nums["logit_err"] < 1e-5 and nums["token_gap"] == 0.0


@pytest.mark.parametrize("tokens", [1, 2, 7, 64, 4096])
def test_capacity_is_the_ports(tokens):
    from repro_torch.models.layers import moe_capacity

    c = tiny_config("deepseek-moe-16b")
    assert R.capacity(R.Arch.from_file(c), tokens) == moe_capacity(
        harness.port_config(c), tokens)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.randn(10000, dtype=torch.float32)
    r = R.tf32(x)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert torch.equal(R.tf32(r), r)
    one = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11], dtype=torch.float32)
    assert R.tf32(one).tolist() == [1.0, 1 + 2 ** -9]  # ties to even


@pytest.mark.parametrize("seed", range(4))
def test_vet_matches_the_ports(seed):
    from repro_torch.core.vet import vet_pipeline

    times = np.random.default_rng(seed).lognormal(-2.0, 0.4, 32)
    vet, _, _, _, t = vet_pipeline(torch.tensor(times), omega=3, buckets=64)
    ours = vet_window(times, buckets=64)
    assert int(t) == ours["t"]
    assert float(vet) == pytest.approx(ours["vet"], rel=1e-5)
    assert check.vet_err(times, int(t), float(vet), 64) < 1e-5
