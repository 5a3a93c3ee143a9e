"""The family seam: both DeepSeek configurations give, through it, the port
config, weight layout and yardstick they gave before it (literals taken
from the harness as it stood before the seam); a configuration of a second
family, made of new files only, runs through ``harness.run``; a family that
drops or does not declare a required number is not correct or refused."""

import json
import time
from pathlib import Path

import pytest
import torch

from portbench import families, harness, weights as W, yardstick as Y

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ["deepseek-moe-16b", "deepseek-v2-lite-16b"]

# 1/sqrt(fan_in) of the leaves below
D = 0.02209708691207961  # 2048
F = 0.009558988911273407  # 10944
E = 0.026650089544451305  # 1408
S = 0.018844459036110227  # 2816
R = 0.04419417382415922  # 512

PORT_CONFIG = {
    "deepseek-moe-16b": dict(
        name='deepseek-moe-16b', family='moe', attention='full',
        num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=10944, vocab_size=102400, n_routed_experts=64,
        n_shared_experts=2, moe_top_k=6, moe_d_ff=1408, first_dense_layers=1,
        capacity_factor=1.25, kv_lora_rank=0, qk_nope_dim=128,
        qk_rope_dim=64, v_head_dim=128, rope_theta=10000.0, norm_eps=1e-06,
        tie_embeddings=False),
    "deepseek-v2-lite-16b": dict(
        name='deepseek-v2-lite-16b', family='moe', attention='mla',
        num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=10944, vocab_size=102400, n_routed_experts=64,
        n_shared_experts=2, moe_top_k=6, moe_d_ff=1408, first_dense_layers=1,
        capacity_factor=1.25, kv_lora_rank=512, qk_nope_dim=128,
        qk_rope_dim=64, v_head_dim=128, rope_theta=10000.0, norm_eps=1e-06,
        tie_embeddings=False),
}


def _moe(n, attn):
    return [(("seg1", "ln1"), (n, 2048), 0.0)] + [
        (("seg1", "attn") + p, (n,) + s, x) for p, s, x in attn] + [
        (("seg1", "ln2"), (n, 2048), 0.0),
        (("seg1", "moe", "router"), (n, 2048, 64), D),
        (("seg1", "moe", "wg"), (n, 64, 2048, 1408), D),
        (("seg1", "moe", "wu"), (n, 64, 2048, 1408), D),
        (("seg1", "moe", "wd"), (n, 64, 1408, 2048), E),
        (("seg1", "moe", "shared", "gate"), (n, 2048, 2816), D),
        (("seg1", "moe", "shared", "up"), (n, 2048, 2816), D),
        (("seg1", "moe", "shared", "down"), (n, 2816, 2048), S)]


def _dense(attn):
    return [(("seg0", "ln1"), (1, 2048), 0.0)] + [
        (("seg0", "attn") + p, (1,) + s, x) for p, s, x in attn] + [
        (("seg0", "ln2"), (1, 2048), 0.0),
        (("seg0", "mlp", "gate"), (1, 2048, 10944), D),
        (("seg0", "mlp", "up"), (1, 2048, 10944), D),
        (("seg0", "mlp", "down"), (1, 10944, 2048), F)]


MHA = [(("wq",), (2048, 2048), D), (("wk",), (2048, 2048), D),
       (("wv",), (2048, 2048), D), (("wo",), (2048, 2048), D)]
MLA = [(("wq",), (2048, 3072), D), (("wkv_a",), (2048, 576), D),
       (("kv_norm",), (512,), 0.0), (("wkv_b",), (512, 4096), R),
       (("wo",), (2048, 2048), D)]
EDGES = [(("final_norm",), (2048,), 0.0), (("head",), (2048, 102400), D)]
LAYOUT = {
    "deepseek-moe-16b": [(("embed",), (102400, 2048), 0.02)] + _dense(MHA)
    + _moe(27, MHA) + EDGES,
    "deepseek-v2-lite-16b": [(("embed",), (102400, 2048), 0.02)] + _dense(MLA)
    + _moe(26, MLA) + EDGES,
}

# prefill_flops(c, 1, s) for s = 1024, 2048, 3072, 4096; flash_bound_s(c,
# 1, 4096)
YARDSTICK = {
    "deepseek-moe-16b": ((5054639636480.0, 10349378011136.0,
                          15884634554368.0, 21660409266176.0),
                         0.011664334003975759),
    "deepseek-v2-lite-16b": ((4736299302912.0, 9762089467904.0,
                              15077789925376.0, 20683400675328.0),
                             0.014059688308363636),
}


def config(name: str) -> dict:
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_port_config_as_before_the_seam(name):
    cfg = harness.port_config(config(name))
    got = {k: getattr(cfg, k) for k in PORT_CONFIG[name]}
    assert got == PORT_CONFIG[name]


@pytest.mark.parametrize("name", CONFIGS)
def test_layout_as_before_the_seam(name):
    assert W.layout(config(name)) == LAYOUT[name]


@pytest.mark.parametrize("name", CONFIGS)
def test_yardstick_as_before_the_seam(name):
    c = config(name)
    flops, bound = YARDSTICK[name]
    assert tuple(Y.prefill_flops(c, 1, s)
                 for s in (1024, 2048, 3072, 4096)) == flops
    assert Y.flash_bound_s(c, 1, 4096) == bound


@pytest.mark.parametrize("name", CONFIGS)
def test_deepseek_requires_its_three_numbers(name):
    fam = families.of(config(name))
    assert fam.NUMBERS == ("route_gap", "logit_err", "token_gap")
    assert fam.__file__ == str(families.DIR / "deepseek_moe.py")


# ---------------------------------------------------------------- a second
# family, all-dense, through the port's dense layers, judged by the
# DeepSeek reference's dense path; written to a temporary root
DENSE = '''"""A tiny all-dense family for the seam's test."""

import torch

from portbench.reference import model as R
from portbench.weights import vocab_padded

NUMBERS = ("logit_err", "token_gap")
DROP = ()  # numbers judge leaves out


def TINY(c):
    return dict(c)


def port_config(c):
    from repro_torch.configs.base import ArchConfig

    h = c["num_attention_heads"]
    return ArchConfig(
        name=c["name"], family="dense", num_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], num_heads=h, num_kv_heads=h,
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        norm_eps=float(c["rms_norm_eps"]), rope_theta=float(c["rope_theta"]),
        tie_embeddings=bool(c["tie_word_embeddings"]))


def layout(c):
    d, n = c["hidden_size"], c["num_hidden_layers"]
    f, vp = c["intermediate_size"], vocab_padded(c["vocab_size"])
    leaves = [(("embed",), (vp, d), 0.02), (("seg0", "ln1"), (n, d), 0.0)]
    leaves += [(("seg0", "attn", w), (n, d, d), d ** -0.5)
               for w in ("wq", "wk", "wv", "wo")]
    leaves += [(("seg0", "ln2"), (n, d), 0.0),
               (("seg0", "mlp", "gate"), (n, d, f), d ** -0.5),
               (("seg0", "mlp", "up"), (n, d, f), d ** -0.5),
               (("seg0", "mlp", "down"), (n, f, d), f ** -0.5),
               (("final_norm",), (d,), 0.0), (("head",), (d, vp), d ** -0.5)]
    return leaves


def _arch(c):
    h, n = c["num_attention_heads"], c["num_hidden_layers"]
    return R.Arch(
        layers=n, d_model=c["hidden_size"], heads=h,
        head_dim=c["hidden_size"] // h, d_ff=c["intermediate_size"],
        moe_d_ff=0, experts=0, shared=0, top_k=0, dense_layers=n,
        vocab=c["vocab_size"], eps=float(c["rms_norm_eps"]),
        rope_theta=float(c["rope_theta"]), kv_lora_rank=0, qk_nope=0,
        qk_rope=0, v_dim=0, norm_topk=False,
        tied=bool(c["tie_word_embeddings"]), capacity_factor=0.0)


def judge(c, weights, samples, precision="f32"):
    if not samples:
        return {}
    arch, out = _arch(c), dict.fromkeys(NUMBERS, 0.0)
    device = weights["embed"].device
    for got in samples:
        s, gen = got.request.prompt_len, got.request.gen_tokens
        ids = torch.cat([torch.from_numpy(got.request.tokens),
                         torch.from_numpy(got.tokens[:, :gen - 1])], dim=1)
        positions = [s - 1 + j for j in range(gen)]
        with torch.no_grad():
            hidden, _, _ = R.forward(arch, weights, ids.to(device),
                                     [(0, ids.shape[1])],
                                     precision=precision)
            ref = R.logits_at(arch, weights, hidden[:, positions], precision)
        b = ref.shape[0]
        ref = ref.reshape(-1, ref.shape[-1]).cpu()
        prog = got.logits.transpose(0, 1).reshape(ref.shape[0], -1)
        nums = R.judge_logits(prog[:, :arch.vocab], ref,
                              torch.from_numpy(got.tokens).reshape(b * gen))
        for k in out:
            out[k] = max(out[k], nums[k])
    return {k: v for k, v in out.items() if k not in DROP}


def prefill_flops(c, b, s):
    d, n, f = c["hidden_size"], c["num_hidden_layers"], c["intermediate_size"]
    pairs = s * (s + 1) // 2
    return n * (2.0 * (4 * d * d + 3 * d * f) * b * s + 4.0 * d * pairs * b) \\
        + 2.0 * d * c["vocab_size"] * b


def flash_launches(c, b, s):
    h = c["num_attention_heads"]
    d = c["hidden_size"] // h
    return [(b, s, h, h, d, d, True)] * c["num_hidden_layers"]
'''

TINY_DENSE = {
    "name": "tiny-dense", "source": "a test's own configuration",
    "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
    "intermediate_size": 128, "vocab_size": 300, "rms_norm_eps": 1e-6,
    "rope_theta": 10000, "tie_word_embeddings": False, "reduced": [],
    "runs": {"family": "tiny_dense"}}


def second_family(tmp_path: Path, monkeypatch, source: str = DENSE,
                  family: str = "tiny_dense") -> Path:
    """A root holding a configuration of family ``family`` (``source``),
    its one cell and mix, and the family file in a families directory
    the harness is pointed at; returns the root."""
    own = tmp_path / "portbench"
    for sub in ("families", "configs", "workloads", "mixes"):
        (own / sub).mkdir(parents=True)
    (own / "families" / f"{family}.py").write_text(source)
    c = dict(TINY_DENSE, runs={"family": family})
    (own / "configs" / "tiny-dense.json").write_text(json.dumps(c))
    (own / "mixes" / "short.json").write_text(json.dumps(
        {"batch": 2, "prompt_lengths": [8, 16], "gen_tokens": 3,
         "dashboard": None}))
    (own / "workloads" / "tinydense.short.json").write_text(json.dumps(
        {"trace_requests": 1,
         "check": {"sample": 3, "sample_from": 4,
                   "limits": {"logit_err": 3e-4, "token_gap": 3e-4}}}))
    bench = {
        "command": ["python3", "portbench/run.py"], "paths": ["portbench"],
        "run_seconds": 1,
        "configs": [{"name": "tiny-dense", "source": c["source"],
                     "file": "portbench/configs/tiny-dense.json",
                     "reduced": [], "why": "a dense family"}],
        "workloads": [{"name": "tinydense.short", "config": "tiny-dense",
                       "traffic": "short", "chips": 1,
                       "why": "short prompts through dense layers"}],
        "end_to_end": [
            {"name": "output_tokens_per_s", "unit": "tokens/s",
             "better": "higher", "bound": 0.25, "source": "host_clock"},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": [
            {"name": "decode_ms_per_step", "unit": "ms", "better": "lower",
             "source": "host_clock", "layer": "serve loop",
             "moves": "output_tokens_per_s"}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(families, "DIR", own / "families")
    return tmp_path


def run_second_family(root: Path) -> dict:
    spec = harness.load_spec("tinydense.short", root)
    return harness.run(spec, seed=2 ** 31 + 19, seconds=0.5, trace=False,
                       device=torch.device("cpu"),
                       started=time.perf_counter())


def tree_shapes(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_shapes(v, prefix + (k,))
    else:
        yield prefix, tuple(tree.shape)


def test_second_family_from_new_files_runs_correct(tmp_path, monkeypatch):
    from repro_torch.models import init_params

    before = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    root = second_family(tmp_path, monkeypatch)
    spec = harness.load_spec("tinydense.short", root)
    port = init_params(harness.port_config(spec.config),
                       torch.Generator().manual_seed(0))
    assert sorted(tree_shapes(W.make(spec.config, 3, "cpu"))) == \
        sorted(tree_shapes(port))
    out = run_second_family(root)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"logit_err", "token_gap"}
    assert out["window"]["sampled"] >= 1
    assert {"output_tokens_per_s", "setup_s"} == set(out["metrics"])
    after = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert after == before  # no file of the benchmark touched


def test_second_family_without_token_gap_is_not_correct(tmp_path,
                                                        monkeypatch):
    source = DENSE.replace('DROP = ()', 'DROP = ("token_gap",)')
    root = second_family(tmp_path, monkeypatch, source, "tiny_dense_no_gap")
    out = run_second_family(root)
    assert "token_gap" not in out["checks"]
    assert out["checks"]["logit_err"]["value"] <= \
        out["checks"]["logit_err"]["limit"]
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("broken,error,words", [
    ("no_file", FileNotFoundError, ("no_file", "no_file.py")),
    ("no_judge", AttributeError, ("no_judge", "judge")),
    ("no_logit_err", ValueError, ("no_logit_err", "logit_err")),
    ("no_token_gap", ValueError, ("no_token_gap", "token_gap"))])
def test_a_broken_family_is_refused_before_set_up(tmp_path, monkeypatch,
                                                  broken, error, words):
    source = {
        "no_file": DENSE,
        "no_judge": DENSE.replace("def judge(", "def _judge("),
        "no_logit_err": DENSE.replace('NUMBERS = ("logit_err", "token_gap")',
                                      'NUMBERS = ("token_gap",)'),
        "no_token_gap": DENSE.replace('NUMBERS = ("logit_err", "token_gap")',
                                      'NUMBERS = ("logit_err",)')}[broken]
    root = second_family(tmp_path, monkeypatch, source, broken)
    if broken == "no_file":
        (root / "portbench" / "families" / "no_file.py").unlink()
    with pytest.raises(error) as got:
        harness.load_spec("tinydense.short", root)
    assert all(w in str(got.value) for w in words), str(got.value)
