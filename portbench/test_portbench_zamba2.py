"""The Zamba2 family on the CPU at its tiny size (``families/zamba2.py``'s
``TINY``: 6 layers with shared-block uses at 1, 2, 4 and 5 over both
blocks, 2 groups of B and C, adapters of rank 8 below the width 64): the
port's prefill, and prefill then decode through the cache, against the
plain reference (``reference/zamba2.py``); the reference against
transformers' ``Zamba2ForCausalLM`` with the same weights; ``harness.run``
correct, and not correct with a planted fault; the new cell's metrics;
``ssd_roofline_pct`` on synthetic records; the layout at full size.

Tolerances, f32 on the CPU: logits to 1e-4 of the row's largest (the
port and the reference each sum in their own order; both lie within
~4e-5 of an f64 forward), served tokens the reference's best."""

import dataclasses
import json
import math
import os
import time
from pathlib import Path

import pytest
import torch

from portbench import check, families, harness, weights as W
from portbench.conftest import tiny_config
from portbench.reference import zamba2 as Z
from portbench.traffic import Traffic

ROOT = Path(__file__).resolve().parent.parent
NAME = "zamba2-7b-instruct"
TOL = 1e-4


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, prefix + (k,))
    else:
        yield prefix, tuple(tree.shape)


@pytest.fixture(scope="module")
def tiny_weights():
    c = tiny_config(NAME)
    return c, W.make(c, 2 ** 31 + 5, "cpu")


def serve(c, params, gen: int, cfg=None):
    """Two requests of batch 2 and 24-token prompts, ``gen`` tokens out,
    kept for the check; their ``judge`` numbers."""
    mix = {"batch": 2, "prompt_lengths": [24], "gen_tokens": gen,
           "dashboard": None}
    server = harness.Server(cfg or harness.port_config(c), params, mix,
                            torch.device("cpu"))
    traffic = Traffic(mix, c["vocab_size"], 7)
    got = [server.serve(traffic.request(i), harness.Spans(), keep=True)
           for i in range(2)]
    return check.judge(c, params, got)


def test_weights_in_the_port_layout(tiny_weights):
    from repro_torch.models import init_params

    c, params = tiny_weights
    port = init_params(harness.port_config(c),
                       torch.Generator().manual_seed(0))
    assert sorted(leaves(params)) == sorted(leaves(port))


@pytest.mark.parametrize("gen", [1, 4], ids=["prefill", "prefill_decode3"])
def test_the_port_follows_the_reference(tiny_weights, gen):
    c, params = tiny_weights
    nums = serve(c, params, gen)
    assert nums["logit_err"] < TOL and nums["token_gap"] == 0.0, nums


def test_decode_from_a_zero_state_does_not(tiny_weights):
    c, params = tiny_weights
    cfg = dataclasses.replace(harness.port_config(c), prefill_ssm_state=False)
    assert serve(c, params, 4, cfg)["logit_err"] > 100 * TOL


def _transformers_model(c, params):
    """transformers' Zamba2ForCausalLM at ``c``'s sizes, one chunk (its
    plain SSD path carries the state between chunks wrongly), with
    ``params`` copied in."""
    os.environ.setdefault("USE_TF", "0")
    tf = pytest.importorskip("transformers")
    keys = ("vocab_size", "max_position_embeddings", "hidden_size",
            "num_hidden_layers", "layers_block_type", "mamba_d_state",
            "mamba_d_conv", "mamba_expand", "mamba_ngroups", "n_mamba_heads",
            "use_conv_bias", "add_bias_linear", "intermediate_size",
            "hidden_act", "num_attention_heads", "num_key_value_heads",
            "num_mem_blocks", "use_shared_attention_adapter", "adapter_rank",
            "use_mem_rope", "rope_theta", "rms_norm_eps", "use_long_context",
            "time_step_limit")
    hc = tf.Zamba2Config(**{k: c[k] for k in keys}, chunk_size=64,
                         tie_word_embeddings=True,
                         attn_implementation="eager")
    m = tf.Zamba2ForCausalLM(hc).eval()
    ids, mixer = c["hybrid_layer_ids"], params["seg0"]["mixer"]

    def put(mod, t):
        assert mod.weight.shape == t.shape, (mod, t.shape)
        mod.weight.copy_(t)

    with torch.no_grad():
        m.model.embed_tokens.weight.copy_(params["embed"][:c["vocab_size"]])
        for li, layer in enumerate(m.model.layers):
            md = getattr(layer, "mamba_decoder", layer)
            mx, p = md.mamba, {k: v[li] for k, v in mixer.items()}
            put(md.input_layernorm, params["seg0"]["ln"][li])
            put(mx.in_proj, p["in_proj"].T)
            put(mx.out_proj, p["out_proj"].T)
            put(mx.conv1d, p["conv_w"].T[:, None, :])
            mx.conv1d.bias.copy_(p["conv_b"])
            for k in ("dt_bias", "A_log", "D"):
                getattr(mx, k).copy_(p[k])
            put(mx.norm, p["norm"])
            if li not in ids:
                continue
            u = ids.index(li)
            put(layer.linear, params["hybrid"]["linear"][u].T)
            st, blk = layer.shared_transformer, u % c["num_mem_blocks"]
            sp = params["shared_attn"]
            put(st.input_layernorm, sp["ln1"][blk])
            put(st.pre_ff_layernorm, sp["ln2"][blk])
            for n in ("q", "k", "v", "o"):
                put(getattr(st.self_attn, f"{n}_proj"),
                    sp["attn"][f"w{n}"][blk].T)
            ff = st.feed_forward
            put(ff.gate_up_proj, torch.cat([sp["mlp"]["gate"][blk],
                                            sp["mlp"]["up"][blk]], 1).T)
            put(ff.down_proj, sp["mlp"]["down"][blk].T)
            put(ff.gate_up_proj_adapter_list[u][0],
                params["hybrid"]["adapter_a"][u].T)
            put(ff.gate_up_proj_adapter_list[u][1],
                params["hybrid"]["adapter_b"][u].T)
        put(m.model.final_layernorm, params["final_norm"])
    return m


def test_the_reference_is_the_published_code(tiny_weights):
    c, params = tiny_weights
    m = _transformers_model(c, params)
    tokens = torch.randint(0, c["vocab_size"], (2, 40),
                           generator=torch.Generator().manual_seed(3))
    arch = Z.Arch.from_file(c)
    with torch.no_grad():
        want = m(tokens, use_cache=False, logits_to_keep=0).logits
        got = Z.logits_at(arch, params, Z.forward(arch, params, tokens))
    assert arch.chunk < tokens.shape[1]  # the reference crosses chunks
    assert (got - want).abs().max() < TOL * want.abs().max()


def run_tiny(tiny) -> dict:
    spec = tiny("zamba2-7b.ttft")
    return harness.run(spec, seed=2 ** 31 + 23, seconds=0.4, trace=False,
                       device=torch.device("cpu"),
                       started=time.perf_counter())


def test_harness_run_is_correct(tiny):
    out = run_tiny(tiny)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"logit_err", "token_gap"}
    assert out["window"]["sampled"] >= 1


@pytest.mark.parametrize("fault", ["scale_sqrt_head_dim", "adapter_dropped"])
def test_harness_run_with_a_fault_is_not_correct(tiny, monkeypatch, fault):
    from repro_torch.models import layers

    if fault == "scale_sqrt_head_dim":
        made = families.of(tiny_config(NAME)).port_config
        monkeypatch.setattr(
            families.of(tiny_config(NAME)), "port_config",
            lambda c: dataclasses.replace(
                made(c), attn_scale=c["attention_head_dim"] ** -0.5))
    else:
        mlp = layers.mlp_apply
        monkeypatch.setattr(layers, "mlp_apply",
                            lambda *a, adapter=None, **k: mlp(*a, **k))
    out = run_tiny(tiny)
    assert not out["correct"], out["checks"]


def test_the_new_cells_metrics():
    spec = harness.load_spec("zamba2-7b.ttft", ROOT)
    assert {m["name"] for m in spec.end_to_end} == {"ttft_ms_p90", "peak_gb",
                                                   "setup_s"}
    assert {m["name"] for m in spec.per_layer} == {
        "flash_roofline_pct", "mfu_pct", "gemm_ms_per_ktok", "idle_pct.ttft",
        "ssd_roofline_pct"}


def _reader(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "r", ROOT / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_ssd_roofline_pct():
    c = json.loads((ROOT / "portbench" / "configs" / f"{NAME}.json")
                   .read_text())
    fam = families.of(c)
    ms = 1_000_000
    spans = [("prefill", 0, 100 * ms, {"batch": 1, "prompt": 1024}),
             ("prefill", 200 * ms, 300 * ms, {"batch": 1, "prompt": 2048})]
    kernels = [("void repro_torch::ssd_gram_kernel<float>", 1 * ms, 2 * ms),
               ("void repro_torch::ssd_mma_kernel<float>", 2 * ms, 30 * ms),
               ("sm80_xmma_gemm_f32", 30 * ms, 90 * ms),
               ("void repro_torch::ssd_mma_kernel<float>", 210 * ms,
                250 * ms)]
    trace = {"kernels": kernels, "spans": spans}
    read = _reader("ssd_roofline_pct")
    got = read({"config": c, "trace": trace})
    bound = sum(
        max(ops / 165e12, nbytes / 3.35e12)
        for s in (1024, 2048)
        for ops, nbytes in [fam.ssd_cost(c, *x)
                            for x in fam.ssd_launches(c, 1, s)])
    assert got == pytest.approx(100 * bound / 0.069)
    assert len(fam.ssd_launches(c, 1, 1024)) == 81
    ops, nbytes = fam.ssd_cost(c, 1, 1024, 112, 64, 64, 2)
    q = 256  # the published chunk, not the port's 64
    assert ops == 2.0 * q * q * 64 * 4 * 2 + \
        (q * (q + 1) * 64 + 4.0 * q * 64 * 64) * 112 * 4
    assert nbytes == 4.0 * 1024 * (2 * 112 * 64 + 112 + 2 * 2 * 64)
    assert read({"config": c, "trace": {"kernels": kernels[2:3],
                                        "spans": spans}}) is None
    ds = json.loads((ROOT / "portbench" / "configs" / "deepseek-moe-16b.json")
                    .read_text())
    assert read({"config": ds, "trace": trace}) is None


def test_the_layout_counts_the_published_parameters():
    c = json.loads((ROOT / "portbench" / "configs" / f"{NAME}.json")
                   .read_text())
    got = sum(math.prod(shape) for _, shape, _ in W.layout(c))
    d, f, r = c["hidden_size"], c["intermediate_size"], c["adapter_rank"]
    di = c["mamba_expand"] * d
    gn = c["mamba_ngroups"] * c["mamba_d_state"]
    h, conv = c["n_mamba_heads"], di + 2 * gn
    mixer = d * (di + conv + h) + c["mamba_d_conv"] * conv + conv \
        + 3 * h + di + di * d + d  # in_proj, conv, A_log D dt_bias, norms
    a = c["attention_hidden_size"]
    block = a + 3 * a * a + a * d + d + 3 * d * f  # q k v 2D -> 2D, o, MLP
    use = d * d + r * (d + 2 * f)
    want = c["vocab_size"] * d + c["num_hidden_layers"] * mixer \
        + c["num_mem_blocks"] * block + len(c["hybrid_layer_ids"]) * use + d
    assert got == want
    assert 7.3e9 < got < 7.4e9
