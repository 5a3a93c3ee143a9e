"""The port's attention (``repro_torch.kernels.flash_attention`` and
``repro_torch.models.layers``) against the reference's on the same inputs.

Kernel function: the port's ``flash_attention`` on CPU tensors (which runs
``attention_plain``) against the reference's Pallas ``flash_attention`` in
interpret mode, as ``tests/test_kernels.py`` runs it, and against its dense
oracle ``attention_ref``, over every case of that suite's ``ATTN_SWEEP``
plus h2o-danube-3-4b's head shape (D = 120, GQA 4:1, a window shorter than
the sequence).  Tolerances are that suite's: 2e-5 (rtol and atol) in f32,
2e-2 in bf16.

Layer: the port's ``layers.attention`` and ``decode_attention`` against
the reference's on the single-block path, the windowed and unwindowed
query-chunked branches, and one-token decode on both sides of the window,
in f32 to 2e-5; a ragged ``q_chunk`` is refused as the reference refuses
it.  Inputs are numpy normals from a seed, handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import layers as JL
from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention, live_pairs)
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import layers as L
from test_kernels import ATTN_SWEEP

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
H2O_CASE = (1, 256, 8, 2, 120, True, 64)  # D=120, GQA 4:1, window < S


def qkv(b, s, h, kh, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kh, d)).astype(np.float32),
            rng.standard_normal((b, s, kh, d)).astype(np.float32))


def both(arrays, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("b,s,h,kh,d,causal,window",
                         ATTN_SWEEP + [H2O_CASE])
def test_kernel_function_matches_reference_f32(b, s, h, kh, d, causal,
                                               window):
    (jq, jk, jv), (q, k, v) = both(qkv(b, s, h, kh, d, seed=s + d), "float32")
    before = fa.LAUNCHES
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert fa.LAUNCHES == before  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, h, d)
    for want in (jax_flash(jq, jk, jv, causal=causal, window=window),
                 attention_ref(jq, jk, jv, causal=causal, window=window)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL["float32"], atol=TOL["float32"])


@pytest.mark.parametrize("shape", [(1, 256, 4, 2, 64, True, 0), H2O_CASE],
                         ids=["test_kernels_bf16", "h2o_head"])
def test_kernel_function_matches_reference_bf16(shape):
    b, s, h, kh, d, causal, window = shape
    (jq, jk, jv), (q, k, v) = both(qkv(b, s, h, kh, d, seed=7), "bfloat16")
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    for want in (jax_flash(jq, jk, jv, causal=causal, window=window),
                 attention_ref(jq, jk, jv, causal=causal, window=window)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.parametrize("q_chunk", [1, 7, 64, 512])
def test_plain_version_does_not_depend_on_its_chunk(q_chunk):
    """Each row's softmax runs over its whole span, so the query chunk only
    changes the memory the plain version needs."""
    _, (q, k, v) = both(qkv(1, 200, 4, 2, 32, seed=3), "float32")
    want = attention_plain(q, k, v, causal=True, window=48, q_chunk=200)
    got = attention_plain(q, k, v, causal=True, window=48, q_chunk=q_chunk)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_live_pairs_counts_the_unmasked_pairs():
    for s, causal, window in ((200, True, 0), (384, True, 128),
                              (256, False, 0), (64, False, 16)):
        pos = np.arange(s)
        mask = np.ones((s, s), bool)
        if causal:
            mask &= pos[:, None] >= pos[None, :]
        if window:
            mask &= pos[:, None] - pos[None, :] < window
        assert live_pairs(s, causal=causal, window=window) == mask.sum()
    # the serve shape of h2o-danube-3-4b: sum over q of min(q + 1, 4096)
    assert live_pairs(7168, causal=True, window=4096) == 20_973_568


def test_kernel_wrapper_refuses_other_devices():
    q = torch.zeros((1, 8, 2, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention(q, q, q)


# ------------------------------------------------------------------ layers
LAYER_CASES = {
    # name: (B, S, H, KH, D, causal, window, q_chunk) -> reference branch
    "single_block_swa_gqa": (2, 24, 4, 2, 32, True, 8, 1024),
    "single_block_bidirectional": (1, 24, 4, 4, 16, False, 0, 1024),
    "chunked_windowed": (2, 64, 4, 2, 32, True, 16, 16),
    "chunked_causal": (2, 64, 4, 1, 32, True, 0, 16),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_attention_matches_reference(case):
    b, s, h, kh, d, causal, window, q_chunk = LAYER_CASES[case]
    (jq, jk, jv), (q, k, v) = both(qkv(b, s, h, kh, d, seed=len(case)),
                                   "float32")
    want = np.asarray(JL.attention(jq, jk, jv, causal=causal, window=window,
                                   q_chunk=q_chunk))
    for plain in (False, True):
        got = L.attention(q, k, v, causal=causal, window=window,
                          q_chunk=q_chunk, plain=plain)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL["float32"],
                                   atol=TOL["float32"])


def test_layer_attention_refuses_a_ragged_query_chunk():
    (jq, jk, jv), (q, k, v) = both(qkv(1, 72, 4, 2, 16), "float32")
    with pytest.raises(ValueError, match="multiple of the attention query"):
        L.attention(q, k, v, window=16, q_chunk=16)
    with pytest.raises(AssertionError):  # the reference asserts the same
        JL.attention(jq, jk, jv, window=16, q_chunk=16)


@pytest.mark.parametrize("pos", [5, 16, 17, 40])
@pytest.mark.parametrize("window", [0, 16])
def test_decode_attention_matches_reference(pos, window):
    """One query against a 48-slot cache holding ``pos`` tokens: inside the
    window (pos <= 16) and past it."""
    rng = np.random.default_rng(pos + window)
    qn = rng.standard_normal((2, 1, 8, 24)).astype(np.float32)
    kc = rng.standard_normal((2, 48, 2, 24)).astype(np.float32)
    vc = rng.standard_normal((2, 48, 2, 24)).astype(np.float32)
    want = JL.decode_attention(jnp.asarray(qn), jnp.asarray(kc),
                               jnp.asarray(vc), pos, window=window)
    got = L.decode_attention(torch.from_numpy(qn), torch.from_numpy(kc),
                             torch.from_numpy(vc), pos, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL["float32"], atol=TOL["float32"])


def test_rope_and_mlp_match_reference():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 12, 4, 32)).astype(np.float32)
    pos = np.arange(12)[None, :]
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.1
         for k, s in (("gate", (32, 48)), ("up", (32, 48)),
                      ("down", (48, 32)))}
    h = rng.standard_normal((2, 5, 32)).astype(np.float32)
    want = JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(h))
    got = L.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
