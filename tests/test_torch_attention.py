"""The port's attention (``repro_torch.kernels.flash_attention`` and
``repro_torch.models.layers``) against the reference's on the same inputs.

Kernel function: the port's ``flash_attention`` on CPU tensors (which runs
``attention_plain``) against the reference's Pallas ``flash_attention`` in
interpret mode, as ``tests/test_kernels.py`` runs it, and against its dense
oracle ``attention_ref``, over every case of that suite's ``ATTN_SWEEP``
plus h2o-danube-3-4b's head shape (D = 120, GQA 4:1, a window shorter than
the sequence) and three head dimensions of the CUDA wrapper's wide entry
(136, 192, 256).  Tolerances are that suite's: 2e-5 (rtol and atol) in f32,
2e-2 in bf16.

Kernel numerics: the CUDA kernel cannot run here, so plain-PyTorch
emulations of its two arithmetics (``flash_emulated``: the online softmax
over the kernel's key tiles in base 2, V at its own width, with bf16 P
before P V in the bf16 entries, and each f32 product carried as three TF32
products, each tile's P V a partial added in f32, in the f32 entries; the
key tiles are each entry's, ``KEY_TILE``) are held to the same references
and tolerances, at small shapes with D = 120, GQA and a window, and at the
wide entries' D = 136, 192 and 256 with V of 128 and of D.  The reference's
Pallas kernel takes V as wide as Q and K: it gets V zero-padded to D, and
its first Dv columns are compared.  These helpers live here, not in the
package.

Layer: the port's ``layers.attention`` and ``decode_attention`` against
the reference's on the single-block path, the windowed and unwindowed
query-chunked branches, and one-token decode on both sides of the window,
in f32 to 2e-5; a ragged ``q_chunk`` is refused as the reference refuses
it.  Inputs are numpy normals from a seed, handed to both packages.
"""

import math
import re

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
# head dimensions the CUDA wrapper sends to its wide entries (136 to 256):
# MLA's 192, and both ends with GQA, a window and no mask
WIDE_CASES = [(1, 128, 4, 2, 136, True, 48), (1, 128, 2, 2, 192, True, 0),
              (1, 64, 4, 1, 256, False, 0)]


def qkv(b, s, h, kh, d, seed=0, dv=None):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kh, d)).astype(np.float32),
            rng.standard_normal((b, s, kh, dv or d)).astype(np.float32))


def references(jq, jk, jv, *, causal, window):
    """The reference's Pallas kernel (on V zero-padded to Q's width, its
    first Dv columns) and its dense oracle."""
    d, dv = jq.shape[-1], jv.shape[-1]
    padded = jnp.pad(jv, ((0, 0),) * 3 + ((0, d - dv),))
    return (jax_flash(jq, jk, padded, causal=causal, window=window)[..., :dv],
            attention_ref(jq, jk, jv, causal=causal, window=window))


def both(arrays, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("b,s,h,kh,d,causal,window",
                         ATTN_SWEEP + [H2O_CASE] + WIDE_CASES)
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


@pytest.mark.parametrize("b,s,h,kh,d,dv,causal,window",
                         [(1, 128, 2, 2, 192, 128, True, 0),
                          (1, 96, 4, 2, 136, 64, True, 40),
                          (1, 64, 4, 1, 256, 136, False, 0),
                          (1, 96, 4, 2, 24, 16, True, 0),
                          (1, 80, 4, 2, 120, 60, True, 30),
                          (1, 64, 2, 2, 192, 60, True, 0)],
                         ids=["mla", "d136_v64_window", "d256_v136",
                              "reduced_mla", "d120_v60_window", "d192_v60"])
def test_kernel_function_takes_v_at_its_own_width(b, s, h, kh, d, dv, causal,
                                                  window):
    """V narrower than Q and K, of any width up to theirs (the wrapper
    pads it to the width its entry takes on the card): an output of V's
    width, equal to the reference on V zero-padded to Q's width."""
    (jq, jk, jv), (q, k, v) = both(qkv(b, s, h, kh, d, seed=dv, dv=dv),
                                   "float32")
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert tuple(got.shape) == (b, s, h, dv)
    for want in references(jq, jk, jv, causal=causal, window=window):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL["float32"], atol=TOL["float32"])


def test_kernel_wrapper_refuses_other_devices():
    q = torch.zeros((1, 8, 2, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention(q, q, q)


def test_wrapper_block_shape_follows_the_kernel_source():
    """``ops.block_rows`` and ``ops.smem_bytes`` copy the constants of
    ``csrc/flash_attention.cu``; evaluate the source's ``constexpr`` chain
    so that a change there fails here instead of misreporting."""
    from repro_torch.kernels import runtime
    src = (runtime.CSRC / "flash_attention.cu").read_text()
    consts = {}
    for name, expr in re.findall(
            r"^constexpr (?:int|size_t) (\w+) = ([^;]+);", src, re.M):
        consts[name] = eval(expr, {"__builtins__": {}}, consts)
    assert fa.block_rows(torch.bfloat16) == consts["kBm"]
    assert fa.smem_bytes(torch.bfloat16) == consts["kBf16Smem"]
    assert fa.block_rows(torch.float32) == consts["kF32Bm"]
    assert fa.smem_bytes(torch.float32) == consts["kF32Smem"]


def test_runtime_signatures_follow_the_c_entries():
    """``runtime``'s ctypes argtypes for each flash entry name the
    parameters of its ``extern "C"`` declaration in the source, in order
    (the wide entries take V's width after the head dimension)."""
    import ctypes
    from repro_torch.kernels import runtime
    src = (runtime.CSRC / "flash_attention.cu").read_text()
    kinds = {"float": ctypes.c_float, "int": ctypes.c_int,
             "cudaStream_t": ctypes.c_void_p}
    for entry in (*fa._ENTRY.values(), *fa._WIDE_ENTRY.values()):
        params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)[1]
        want = [ctypes.c_void_p if "*" in p else kinds[p.split()[0]]
                for p in params.split(",")]
        assert runtime._SIGNATURES[entry] == want, entry
        names = [p.split()[-1].lstrip("*") for p in params.split(",")]
        assert ("vdim" in names) == (entry in fa._WIDE_ENTRY.values())


# ------------------------------------------------- the kernel's numerics
def tf32_rna(x):
    """f32 -> TF32 (10-bit mantissa), nearest with ties away from zero, by
    bit rounding, as the f32 kernel rounds a finite value."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a, b):
    """a @ b in f32 from three TF32 products: a = ab + as, b = bb + bs with
    ab = tf32(a), as = tf32(a - ab); as bb + ab bs + ab bb (each product is
    exact in f32: two 11-bit significands)."""
    ab, bb = tf32_rna(a), tf32_rna(b)
    as_, bs = tf32_rna(a - ab), tf32_rna(b - bb)
    return (as_ @ bb + ab @ bs) + ab @ bb


# keys per tile of each kernel: (numerics, the widest D of its tiles) ->
# keys.  bf16: flash_wgmma_bf16<2, 128> (D up to 128) and <3, 128> take
# 128, <4, 64> (D above 192) 64; f32: flash_wgmma_tf32 (D up to 128) and
# flash_wgmma_wide_tf32<6, 32> take 32, <8, 16> 16.
KEY_TILE = {("bf16", 192): 128, ("bf16", 256): 64,
            ("tf32x3", 192): 32, ("tf32x3", 256): 16}


def key_tile(numerics, d):
    return KEY_TILE[numerics, 192 if d <= 192 else 256]


def flash_emulated(q, k, v, *, causal, window, tile, numerics):
    """The kernel's arithmetic in plain PyTorch: an online softmax over
    ``tile``-key tiles, scores in base 2 (scale times log2 e, rounded to
    f32 as the kernel's launcher rounds it), a row with nothing live yet on
    base 0.  V may be narrower than Q and K; the output has its width.
    Each tile's P V is a partial of its own, added to the rescaled
    accumulator in f32.  ``numerics="bf16"``: products of the bf16 inputs
    summed in f32 and P rounded to bf16 before P V (the bf16 entries);
    ``"tf32x3"``: both products as three TF32 products (the f32 entries).
    ``key_tile`` gives each entry's tile."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    mm = mm_3xtf32 if numerics == "tf32x3" else torch.matmul
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(g, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, dim=2).transpose(1, 2)
    sl2 = float(np.float32(1.0 / math.sqrt(d)) * np.float32(math.log2(math.e)))
    m = torch.full((b, h, s), -torch.inf)
    l = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, v.shape[-1]))
    qpos = torch.arange(s)[:, None]
    for k0 in range(0, s, tile):
        k1 = min(k0 + tile, s)
        x = mm(qf, kf[:, :, k0:k1].transpose(-1, -2)) * sl2
        kpos = torch.arange(k0, k1)[None, :]
        live = torch.ones((s, k1 - k0), dtype=torch.bool)
        if causal:
            live &= qpos >= kpos
        if window:
            live &= qpos - kpos < window
        x = x.masked_fill(~live, -torch.inf)
        mn = torch.maximum(m, x.amax(-1))
        base = torch.where(mn == -torch.inf, 0.0, mn)
        alpha = torch.exp2(m - base)
        p = torch.exp2(x - base[..., None])
        l = l * alpha + p.sum(-1)
        if numerics == "bf16":
            p = p.to(torch.bfloat16).float()
        part = mm(p, vf[:, :, k0:k1])
        acc = acc * alpha[..., None] + part
        m = mn
    inv = torch.where(l > 0, 1.0 / l, 0.0)
    return (acc * inv[..., None]).transpose(1, 2).to(q.dtype)


EMU_CASES = {
    # (B, S, H, KH, D, causal, window, Dv): D = 120 with GQA 4:1 and a
    # window below S, ragged S with a window no multiple of the tiles, MQA
    # bidirectional
    "h2o_head": H2O_CASE + (120,),
    "ragged_window_d120": (2, 200, 8, 2, 120, True, 100, 120),
    "mqa_bidirectional": (1, 160, 4, 1, 32, False, 0, 32),
    # the wide entries: D = 136 (GQA, a window), MLA's 192 with V of 128
    # and of 192, 256 (64- and 16-key tiles) with V of 128 and of 256
    "wide_d136_gqa_window": (1, 144, 4, 2, 136, True, 50, 136),
    "wide_mla_d192_v128": (1, 160, 2, 2, 192, True, 0, 128),
    "wide_d192_v192_bidirectional": (1, 96, 2, 1, 192, False, 0, 192),
    "wide_d256_v128": (1, 160, 2, 2, 256, True, 0, 128),
    "wide_d256_v256_mqa_window": (1, 96, 4, 1, 256, True, 40, 256),
}


@pytest.mark.parametrize("case", sorted(EMU_CASES))
def test_bf16_tensor_core_numerics_match_reference(case):
    """bf16 P before P V over the key tiles of each ``flash_wgmma_bf16``
    instantiation stays inside the bf16
    tolerance of the reference's Pallas kernel and its dense oracle."""
    b, s, h, kh, d, causal, window, dv = EMU_CASES[case]
    (jq, jk, jv), (q, k, v) = both(qkv(b, s, h, kh, d, seed=s + 1, dv=dv),
                                   "bfloat16")
    got = flash_emulated(q, k, v, causal=causal, window=window,
                         tile=key_tile("bf16", d), numerics="bf16")
    assert got.dtype == torch.bfloat16 and got.shape[-1] == dv
    for want in references(jq, jk, jv, causal=causal, window=window):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.parametrize("case", sorted(EMU_CASES))
def test_3xtf32_numerics_match_reference(case):
    """Three TF32 products per f32 product over the key tiles of each f32
    kernel (``flash_wgmma_tf32``, ``flash_wgmma_wide_tf32``) keep the f32
    tolerance of the reference's Pallas kernel and its dense oracle."""
    b, s, h, kh, d, causal, window, dv = EMU_CASES[case]
    (jq, jk, jv), (q, k, v) = both(qkv(b, s, h, kh, d, seed=s + 2, dv=dv),
                                   "float32")
    got = flash_emulated(q, k, v, causal=causal, window=window,
                         tile=key_tile("tf32x3", d), numerics="tf32x3")
    assert got.shape[-1] == dv
    for want in references(jq, jk, jv, causal=causal, window=window):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL["float32"], atol=TOL["float32"])


def test_one_tf32_product_misses_the_f32_tolerance():
    """Why three products: one TF32 pass keeps ~3 digits and misses
    2e-5 + 2e-5 |o| at the h2o head shape."""
    b, s, h, kh, d, causal, window = H2O_CASE
    _, (q, k, v) = both(qkv(b, s, h, kh, d, seed=5), "float32")
    want = attention_plain(q, k, v, causal=causal, window=window)
    one = flash_emulated(tf32_rna(q), tf32_rna(k), tf32_rna(v),
                         causal=causal, window=window, tile=32,
                         numerics="plain")
    tol = TOL["float32"]
    assert float(((one - want).abs() / (tol + tol * want.abs())).max()) > 1


def test_tf32_rna_rounds_nearest_ties_away_and_splits_exactly():
    ulp = 2.0 ** -10  # TF32's unit in the last place at 1.0
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 3 * ulp / 2, 0.0, -0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 0.0, -0.0])
    torch.testing.assert_close(tf32_rna(x), want, rtol=0, atol=0)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32)) * 100
    big = tf32_rna(r)
    small = tf32_rna(r - big)
    assert torch.all((big.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((small.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((r - big).abs() <= r.abs() * 2.0 ** -11)
    assert torch.all((r - (big + small)).abs() <= r.abs() * 2.0 ** -22)


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
