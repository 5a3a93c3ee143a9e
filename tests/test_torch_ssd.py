"""The port's SSD scan (``repro_torch.kernels.ssd``) against the reference's
on the same inputs: ``repro.kernels.ssd.ref.ssd_ref`` (the stepwise
oracle) and ``repro.models.layers._ssd_chunked`` in its vectorised and
``sequential=True`` forms.  On CPU tensors ``ops.ssd`` runs the plain
version, so this holds the plain version, the wrapper's argument handling
and the port's own stepwise oracle.

Kernel numerics: the CUDA kernel cannot run here, so ``ssd_emulated``
repeats its arithmetic in plain PyTorch (16-column P slices, the chunk
padded to 16 and N to the 32-column pieces, seg added in sequence in f32,
G = C B^T once per chunk, every product as three TF32 products in the
``mma`` k-step order, the state updated chunk after chunk
in IEEE f32) and is held to the reference's Pallas kernel in interpret
mode, as ``TestSSD`` runs it, and to ``_ssd_chunked``.  Tests also hold
the wrapper's copy of the kernel's shared-memory layout to the source's
``constexpr`` lines and ``ssd_smem`` regions, and check that it takes
every shape the SIMT kernel before it took.

Inputs are TestSSD's (``tests/test_kernels.py``), made with numpy from a
seed; tolerances are that suite's: 2e-4 (rtol and atol) in f32, 5e-2 with
bf16 x/B/C, 2e-4 between chunk sizes 32 and 64 (the state carried across
chunks).
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.ssd.ops import ssd as jax_ssd
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref
from repro.models.layers import _ssd_chunked
from repro_torch.kernels import runtime
from repro_torch.kernels.ssd import ops as sd
from repro_torch.kernels.ssd import ssd, ssd_ref, ssd_scan_plain


def make_inputs(b, t, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 8.0, h)).astype(np.float32)
    bb = rng.standard_normal((b, t, n)).astype(np.float32)
    cc = rng.standard_normal((b, t, n)).astype(np.float32)
    d = np.ones(h, np.float32)
    return x, dt, a_log, bb, cc, d


CASES = {
    # name: (shape (B,T,H,P,N), dtype of x/B/C, chunks, tolerance)
    "f32_reduced": ((2, 64, 4, 16, 16), "float32", (8,), 2e-4),
    "f32_chunk16": ((1, 96, 3, 32, 16), "float32", (16,), 2e-4),
    "bf16": ((1, 128, 2, 32, 16), "bfloat16", (64,), 5e-2),
    "chunk32_vs_64": ((1, 256, 2, 32, 16), "float32", (32, 64), 2e-4),
    # P, N and the chunk multiples of 4 but not of 8 or 16: padded edges
    "odd_p12_n20_c12": ((2, 96, 3, 12, 20), "float32", (12,), 2e-4),
    "odd_p12_n20_c12_bf16": ((2, 96, 3, 12, 20), "bfloat16", (12,), 5e-2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ssd_matches_reference(case):
    shape, dtype, chunks, tol = CASES[case]
    x, dt, a_log, bb, cc, d = make_inputs(*shape, seed=len(case))
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    jx, jb, jc = (jnp.asarray(v).astype(jdt) for v in (x, bb, cc))
    tx, tb, tc = (torch.from_numpy(v).to(tdt) for v in (x, bb, cc))
    jargs = (jx, jnp.asarray(dt), jnp.asarray(a_log), jb, jc, jnp.asarray(d))
    targs = (tx, torch.from_numpy(dt), torch.from_numpy(a_log), tb, tc,
             torch.from_numpy(d))

    oracle = np.asarray(jax_ssd_ref(*jargs), np.float32)
    port_oracle = ssd_ref(*targs)
    assert port_oracle.dtype == tdt
    np.testing.assert_allclose(port_oracle.float().numpy(), oracle,
                               rtol=tol, atol=tol)
    outs = []
    for chunk in chunks:
        got = ssd(*targs, chunk=chunk)
        assert got.dtype == tdt and tuple(got.shape) == shape[:4]
        got = got.float().numpy()
        for want in (oracle,
                     np.asarray(_ssd_chunked(*jargs, chunk), np.float32),
                     np.asarray(_ssd_chunked(*jargs, chunk, sequential=True),
                                np.float32)):
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        outs.append(got)
    for other in outs[1:]:
        np.testing.assert_allclose(other, outs[0], rtol=tol, atol=tol)


def test_ssd_refuses_a_ragged_chunk():
    x, dt, a_log, bb, cc, d = (torch.from_numpy(v)
                               for v in make_inputs(1, 12, 2, 8, 8))
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        ssd(x, dt, a_log, bb, cc, d, chunk=8)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        ssd_scan_plain(x, dt, -torch.exp(a_log), bb, cc, d, chunk=8)


# ------------------------------------------------- the kernel's numerics
def tf32_rna(x):
    """f32 -> TF32 (10-bit mantissa), nearest with ties away from zero, by
    bit rounding, as the kernel's ``tf32_rna`` rounds a finite value."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mma3(acc, a, b):
    """``acc + a @ b`` as the kernel sums each tile over the depth in steps
    of 8 (``mma.sync`` m16n8k8): a = ab + as, b = bb + bs (TF32 parts),
    then as bb, ab bs and ab bb in that order (the kernel's passes 0-2),
    each step's eight products exact and added to the f32 accumulator with
    one rounding.  An operand exact in TF32 (bf16 inputs) has as = 0, so the
    kernel's skipped products add exact zeros here."""
    ab, bb = tf32_rna(a), tf32_rna(b)
    as_, bs = tf32_rna(a - ab), tf32_rna(b - bb)
    for k in range(0, a.shape[-1], 8):
        for x, y in ((as_, bb), (ab, bs), (ab, bb)):
            acc = (acc.double() + x[..., k:k + 8].double()
                   @ y[..., k:k + 8, :].double()).float()
    return acc


def by_piece(mma, acc, a, b, piece=32):
    """``acc + a @ b`` over the depth in pieces of ``piece``: each piece's
    ``mma`` sum from zero, then added to ``acc`` with one f32 rounding, as
    the kernel sums every product (the tensor cores' accumulation is not
    IEEE, so a long chain into one accumulator drifts; the pieces are
    also independent chains)."""
    for k in range(0, a.shape[-1], piece):
        acc = acc + mma(torch.zeros_like(acc), a[..., k:k + piece],
                        b[..., k:k + piece, :])
    return acc


def serial_scan(v):
    """Inclusive sums along the last axis added in sequence, each add
    rounded to f32, as the kernel (and the plain version's cumsum on the
    card) adds them."""
    out, acc = torch.empty_like(v), torch.zeros_like(v[..., 0])
    for j in range(v.shape[-1]):
        acc = acc + v[..., j]
        out[..., j] = acc
    return out


def ssd_emulated(x, dt, a_neg, b, c, d, *, chunk, mma=mma3):
    """The arithmetic of ``csrc/ssd.cu`` in plain PyTorch: P padded to
    16-column slices, the chunk to a multiple of 16 and N to the 32-column
    pieces (zeros, dt = 0), then per chunk seg by ``serial_scan`` and
    G = C B^T once for all heads (the kernel's prologue), y^T = h C^T and
    S = (X o w)^T B, the state h = h exp(last) + S in IEEE f32, then
    y^T = exp(seg_i) y^T + X^T scores^T (that product summed from zero,
    then added to the scaled sum) and y = y^T + d x; every product by
    ``mma``, each over its depth in 32-step pieces by ``by_piece``."""
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    cp, npad, pp = -(-chunk // 16) * 16, -(-n // 32) * 32, -(-p // 16) * 16
    xf, bf, cf = x.float(), b.float(), c.float()
    a, dd = a_neg.float(), d.float()
    tri = torch.ones(cp, cp, dtype=torch.bool).tril()
    state = torch.zeros(bsz, h, pp, npad)
    ys = []
    for t0 in range(0, t, chunk):
        sl = slice(t0, t0 + chunk)
        X = torch.zeros(bsz, h, cp, pp)
        X[:, :, :chunk, :p] = xf[:, sl].permute(0, 2, 1, 3)
        B = torch.zeros(bsz, 1, cp, npad)
        B[:, 0, :chunk, :n] = bf[:, sl]
        C = torch.zeros(bsz, 1, cp, npad)
        C[:, 0, :chunk, :n] = cf[:, sl]
        D = torch.zeros(bsz, h, cp)
        D[..., :chunk] = dt[:, sl].float().permute(0, 2, 1)
        seg = serial_scan(D * a[:, None])
        last = seg[..., -1:]
        w = torch.exp(last - seg) * D
        G = by_piece(mma, torch.zeros(bsz, 1, cp, cp), C, B.transpose(-1, -2))
        y_out = by_piece(mma, torch.zeros(bsz, h, pp, cp), state,
                         C.transpose(-1, -2))
        s_chunk = by_piece(mma, torch.zeros(bsz, h, pp, npad),
                           (X * w[..., None]).transpose(-1, -2), B)
        state = state * torch.exp(last)[..., None] + s_chunk
        li = torch.where(tri, seg[..., :, None] - seg[..., None, :],
                         -torch.inf)
        scores = G * torch.exp(li) * D[..., None, :]
        y = (torch.exp(seg)[..., None, :] * y_out
             + by_piece(mma, torch.zeros_like(y_out), X.transpose(-1, -2),
                        scores.transpose(-1, -2))
             ) + dd[:, None, None] * X.transpose(-1, -2)
        ys.append(y[:, :, :p, :chunk])
    return torch.cat(ys, dim=-1).permute(0, 3, 1, 2).to(x.dtype)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_numerics_match_reference(case):
    """The kernel's arithmetic (``ssd_emulated``) against the reference's
    Pallas kernel in interpret mode and ``_ssd_chunked``, at TestSSD's
    tolerances; chunk 32 against chunk 64 where the case asks."""
    shape, dtype, chunks, tol = CASES[case]
    x, dt, a_log, bb, cc, d = make_inputs(*shape, seed=len(case) + 1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = (jnp.asarray(x).astype(jdt), jnp.asarray(dt), jnp.asarray(a_log),
             jnp.asarray(bb).astype(jdt), jnp.asarray(cc).astype(jdt),
             jnp.asarray(d))
    tx, tb, tc = (torch.from_numpy(v).to(tdt) for v in (x, bb, cc))
    a_neg = -torch.exp(torch.from_numpy(a_log))
    outs = []
    for chunk in chunks:
        got = ssd_emulated(tx, torch.from_numpy(dt), a_neg, tb, tc,
                           torch.from_numpy(d), chunk=chunk)
        assert got.dtype == tdt and tuple(got.shape) == shape[:4]
        got = got.float().numpy()
        for want in (jax_ssd(*jargs, chunk=chunk),
                     _ssd_chunked(*jargs, chunk)):
            np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                       rtol=tol, atol=tol)
        outs.append(got)
    for other in outs[1:]:
        np.testing.assert_allclose(other, outs[0], rtol=tol, atol=tol)


def test_one_tf32_product_misses_the_f32_tolerance():
    """Why three products: one TF32 pass keeps ~3 digits and misses
    2e-4 + 2e-4 |y| on TestSSD's reduced case."""
    shape, _, (chunk,), tol = CASES["f32_reduced"]
    x, dt, a_log, bb, cc, d = (torch.from_numpy(v)
                               for v in make_inputs(*shape, seed=4))
    a_neg = -torch.exp(a_log)
    want = ssd_scan_plain(x, dt, a_neg, bb, cc, d, chunk=chunk)

    def one_product(acc, a, b):
        a, b = tf32_rna(a), tf32_rna(b)
        return (acc.double() + a.double() @ b.double()).float()

    one = ssd_emulated(x, dt, a_neg, bb, cc, d, chunk=chunk, mma=one_product)
    got = ssd_emulated(x, dt, a_neg, bb, cc, d, chunk=chunk)
    assert float(((got - want).abs() / (tol + tol * want.abs())).max()) < 1
    assert float(((one - want).abs() / (tol + tol * want.abs())).max()) > 1


def _smem_from_source(src, k):
    """``ssd_smem`` of ``csrc/ssd.cu`` evaluated from its own lines: its
    ``const size_t`` locals and each region's ``off += ...;`` in order, as
    a function of (cp, npad, rows, esize)."""
    body = src[src.index("SsdSmem ssd_smem("):]
    body = body[:body.index("return s;")]
    lines = [ln.strip() for ln in body.splitlines()]
    locals_ = re.findall(r"const size_t (\w+) = ([^;]+);", body)
    regions = [ln[len("off += "):-1] for ln in lines
               if ln.startswith("off += ")]
    assert regions and all(ln.endswith(";") for ln in lines
                           if ln.startswith("off += "))

    def py(expr):
        return expr.replace("static_cast<size_t>", "")

    def smem(cp, npad, rows, esize):
        env = dict(k, cp=cp, npad=npad, rows=rows, esize=esize,
                   align16=lambda v: (v + 15) // 16 * 16)
        for name, expr in locals_:
            env[name] = eval(py(expr), {"__builtins__": {}}, env)
        return sum(eval(py(r), {"__builtins__": {}}, env) for r in regions)

    return smem, len(regions)


def _source_constants():
    src = (runtime.CSRC / "ssd.cu").read_text()
    k = {}
    for name, expr in re.findall(
            r"^constexpr (?:int|size_t) (\w+) = ([^;]+);", src, re.M):
        k[name] = eval(expr, {"__builtins__": {}}, k)
    return src, k


def test_wrapper_geometry_follows_the_kernel_source():
    """``ops.smem_bytes`` copies ``ssd_smem`` of ``csrc/ssd.cu``: evaluate
    the source's ``constexpr`` chain and ``ssd_smem``'s own region lines so
    that a region added, resized or reordered there fails here instead of
    misreporting (or refusing) shapes.  (On the card,
    ``tests/test_torch_gpu.py`` holds the copy to the built library's
    ``ssd_scan_smem_bytes``.)"""
    src, k = _source_constants()
    assert (sd._UNITS, sd._PIECE, sd._PAD, sd._MAX_CHUNK, sd._MAX_SMEM) == (
        k["kSsdUnits"], k["kSsdPiece"], k["kSsdPad"], k["kSsdMaxChunk"],
        k["kSsdMaxSmem"])
    smem, n_regions = _smem_from_source(src, k)
    assert n_regions == 7
    for p in (4, 12, 16, 64, 128):
        for n in (4, 16, 20, 128, 256, 1248, 2496):
            for chunk in (4, 8, 12, 32, 48, 64):
                for dtype, esize in ((torch.float32, 4), (torch.bfloat16, 2)):
                    cp = -(-chunk // 16) * 16
                    npad = -(-n // k["kSsdPiece"]) * k["kSsdPiece"]
                    rows = min(k["kSsdWidth"], p)
                    assert sd.smem_bytes(p, n, chunk, dtype) == smem(
                        cp, npad, rows, esize), (p, n, chunk, dtype)
    # the serve shape of mamba2-130m: 86.25 KiB in f32, two blocks an SM
    # (228 KiB, 1 KiB of it reserved a block)
    assert sd.smem_bytes(64, 128, 64) == 88320
    assert 2 * (88320 + 1024) <= 228 * 1024 and k["kSsdBlocksPerSm"] == 2
    assert sd.smem_bytes(64, 128, 64, torch.bfloat16) == 57600


def test_wrapper_takes_every_shape_the_simt_kernel_took():
    """The state holds min(32, P) rows of N, so every (P, N, chunk) that the
    SIMT kernel before it took (its shared memory, 4 ((P + 2 chunk)(N + 1)
    + chunk P + chunk^2 + 4 chunk) bytes, within a block's limit) fits, in
    both types; the widest state at P >= 32 is N = 1248."""
    def simt(p, n, c):
        return 4 * ((p + 2 * c) * (n + 1) + c * p + c * c + 4 * c)

    for p in range(4, 257, 4):
        for chunk in range(4, 65, 4):
            for n in range(4, 6000, 4):
                if simt(p, n, chunk) > sd._MAX_SMEM:
                    break
                for dtype in (torch.float32, torch.bfloat16):
                    assert sd.smem_bytes(p, n, chunk, dtype) <= sd._MAX_SMEM, (
                        p, n, chunk, dtype)
    assert sd.smem_bytes(64, 1248, 64) <= sd._MAX_SMEM
    assert sd.smem_bytes(64, 1280, 64) > sd._MAX_SMEM
