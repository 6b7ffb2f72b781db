"""The kernels' plain PyTorch versions against the JAX reference, and the
CUDA kernels against their plain versions on the card.

On the CPU every ``repro_torch.kernels.ops`` wrapper runs its plain version
(``kernels/ref.py``); those are held against ``repro.kernels.ops`` run in
Pallas interpret mode and against ``repro.kernels.ref``. ``bitset_dist`` is
exact; distances are allclose at rtol 1e-5 (another float summation order).
Attention in float32 is allclose at 1e-5 (the plain version takes keys in
blocks of 128, the Pallas runs here in blocks of 64: another partition of
the online softmax); in bf16 the outputs, rounded to bf16 from float32
values that agree to about 1e-6, may differ by one bf16 rounding step,
2^-7 of the value. The CUDA kernels are held against their plain versions
in ``test_torch_cuda.py``.
"""
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.flash_attn import flash_attention as rflash
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _packed(rng, n, d, a):
    x = rng.normal(size=(n, d)).astype(np.float32)
    norm = (x * x).sum(-1, keepdims=True)
    words = rng.integers(0, 2 ** 32, (n, a), dtype=np.uint64).astype(
        np.uint32)
    words[0, 0] = 0x7FC00001                 # a NaN-looking payload
    words[1, 0] = 0xFFFFFFFF
    words[2, -1] = 0x80000000                # -0.0 as a float
    return np.concatenate([x, norm, words.view(np.float32)], axis=1)


# (N, B, C, d, A); d = 100 with A = 1, 2, 3 gives the row widths 102, 103
# and 104 words, which the CUDA kernel reads in pairs, singly and in fours
@pytest.mark.parametrize("shape", [(64, 3, 7, 12, 1), (200, 5, 48, 100, 2),
                                   (300, 2, 144, 100, 1),
                                   (300, 1, 145, 100, 3),
                                   (300, 3, 1, 100, 2)])
def test_fused_expand_plain_matches_reference(shape):
    N, B, C, d, A = shape
    rng = np.random.default_rng(0)
    packed = _packed(rng, N, d, A)
    ids = rng.integers(-3, N + 3, (B, C)).astype(np.int32)
    ids[0, 0], ids[-1, -1] = -1, N           # clamped to the first, last row
    q = rng.normal(size=(B, d)).astype(np.float32)
    qn = (q * q).sum(-1)
    d2, words = ops.fused_expand(_t(packed), _t(ids), _t(q), _t(qn), d=d)
    rd2, rwords = rops.fused_expand(packed, ids, q, qn, d=d, interpret=True)
    np.testing.assert_allclose(d2.numpy(), np.asarray(rd2), rtol=1e-5,
                               atol=1e-4)
    assert np.array_equal(words.numpy().view(np.uint32),
                          np.asarray(rwords).view(np.uint32))
    od2, _ = rref.fused_expand_ref(packed, np.clip(ids, 0, N - 1), q, qn,
                                   d=d)
    np.testing.assert_allclose(d2.numpy(), np.asarray(od2), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("same_base", [True, False])
def test_gather_dist_tile_plain_matches_reference(same_base):
    rng = np.random.default_rng(1)
    tile, n_tiles, dp, B = 64, 4, 24, 9
    xb = rng.normal(size=(tile * n_tiles, dp)).astype(np.float32)
    q = rng.normal(size=(B, dp)).astype(np.float32)
    base = (np.full(B, 2) if same_base
            else rng.integers(0, n_tiles, B)).astype(np.int32)
    got = ops.gather_dist_tile(_t(xb), _t(base), _t(q), tile=tile)
    want = rops.gather_dist_tile(xb, base, q, tile=tile, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    rows = base[:, None] * tile + np.arange(tile)
    oracle = np.maximum(((xb[rows] - q[:, None]) ** 2).sum(-1), 0)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=1e-4)


def test_gather_dist_tile_plain_is_the_kernels_sequential_sum():
    """The plain version sums d in order with a rounded multiply then a
    rounded add per term, the CUDA kernel's arithmetic: check it against a
    float32 loop in numpy, bit for bit."""
    rng = np.random.default_rng(2)
    xb = rng.normal(size=(32, 16)).astype(np.float32)
    q = rng.normal(size=(3, 16)).astype(np.float32)
    got = ref.gather_dist_tile(_t(xb), torch.zeros(3, dtype=torch.int32),
                               _t(q), tile=32).numpy()
    dot = np.zeros((3, 32), np.float32)
    xn = np.zeros(32, np.float32)
    qn = np.zeros(3, np.float32)
    for k in range(16):
        dot = dot + q[:, k:k + 1] * xb[None, :, k]
        xn = xn + xb[:, k] * xb[:, k]
        qn = qn + q[:, k] * q[:, k]
    assert np.array_equal(got, np.maximum(xn - 2 * dot + qn[:, None], 0))


def _check_bitset_plain(op, B, N, W):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2 ** 32, (B, W), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (N, W), dtype=np.uint64).astype(np.uint32)
    a[0] = 0xFFFFFFFF
    got = ops.bitset_dist(_t(a.view(np.int32)), _t(b.view(np.int32)), op=op)
    wrap = rops.hamming if op == "xor" else rops.subset_deficit
    want = wrap(a, b, interpret=True)
    oracle = (rref.hamming_ref if op == "xor" else rref.subset_deficit_ref)(
        jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), np.asarray(oracle))
    named = ops.hamming if op == "xor" else ops.subset_deficit
    assert torch.equal(named(_t(a.view(np.int32)), _t(b.view(np.int32))),
                       got)


# W up to 2 takes the CUDA kernel's runs of four outputs, above it the tiles
@pytest.mark.parametrize("op", ["xor", "deficit"])
@pytest.mark.parametrize("W", [1, 2, 3, 4, 5, 32, 33, 40, 1024])
def test_bitset_dist_plain_exact(op, W):
    _check_bitset_plain(op, 17, 29, W)


# output rows that start off a 16-byte boundary (N % 4 != 0: each of the
# four offsets among 37 rows) and one query
@pytest.mark.parametrize("op", ["xor", "deficit"])
@pytest.mark.parametrize("W", [1, 33])
@pytest.mark.parametrize("B,N", [(1, 1), (1, 3), (1, 4097), (37, 4095)])
def test_bitset_dist_plain_exact_ragged(op, W, B, N):
    _check_bitset_plain(op, B, N, W)


def test_wrappers_count_no_launch_on_the_cpu_and_reject_mixed_devices():
    ops.reset_launches()
    a = torch.zeros((2, 1), dtype=torch.int32)
    ops.subset_deficit(a, a)
    assert all(v == 0 for v in ops.LAUNCHES.values())
    with pytest.raises(ValueError):
        ops.bitset_dist(a, a, op="and")


def _bf16_np(a):
    """float32 values rounded to bf16, as float32 (one value for both
    packages)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


# d = 13 and 12300 are the widths the CUDA kernel takes with single-value
# loads and in many passes (wider than its old 48 KiB query buffer);
# allclose at rtol 1e-5, atol 1e-4: another float summation order
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,C,N,d", [(4, 8, 64, 16), (16, 32, 200, 64),
                                     (2, 5, 33, 100), (2, 3, 40, 13),
                                     (2, 3, 20, 12300)])
def test_gather_dist_plain_matches_reference(B, C, N, d, dtype):
    rng = np.random.default_rng(6)
    xb = rng.normal(size=(N, d)).astype(np.float32)
    if dtype == "bfloat16":
        xb = _bf16_np(xb)
    q = rng.normal(size=(B, d)).astype(np.float32)
    ids = rng.integers(-4, N + 4, (B, C)).astype(np.int32)   # clipped
    txb = _t(xb).to(getattr(torch, dtype))
    got = ops.gather_dist(txb, _t(ids), _t(q))
    want = rops.gather_dist(jnp.asarray(xb, getattr(jnp, dtype)), ids, q,
                            interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    oracle = rref.gather_dist_ref(xb, np.clip(ids, 0, N - 1), q)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_dist_takes_wide_rows_on_the_cpu(dtype):
    """d above 12288 (the old kernel's 48 KiB query buffer): the wrapper
    takes it, runs the plain version on CPU tensors and counts no launch;
    the sum matches one in float64."""
    rng = np.random.default_rng(8)
    N, d = 10, 12289
    xb = _t(rng.normal(size=(N, d)).astype(np.float32)).to(dtype)
    q = rng.normal(size=(2, d)).astype(np.float32)
    ids = np.array([[0, 9, -1], [3, 10, 4]], np.int32)
    ops.reset_launches()
    got = ops.gather_dist(xb, _t(ids), _t(q))
    assert ops.LAUNCHES["gather_dist"] == 0
    rows = xb.double().numpy()[np.clip(ids, 0, N - 1)]
    want = ((rows - q.astype(np.float64)[:, None]) ** 2).sum(-1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,d", [(8, 32, 16), (64, 100, 48),
                                   (33, 257, 130)])
def test_l2dist_plain_matches_reference(B, N, d, dtype):
    rng = np.random.default_rng(7)
    q = rng.normal(size=(B, d)).astype(np.float32)
    xb = rng.normal(size=(N, d)).astype(np.float32)
    if dtype == "bfloat16":
        q, xb = _bf16_np(q), _bf16_np(xb)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    got = ops.l2dist(_t(q).to(tdt), _t(xb).to(tdt))
    want = rops.l2dist(jnp.asarray(q, jdt), jnp.asarray(xb, jdt),
                       interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(rref.l2dist_ref(q, xb)),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("B,H,Hkv,Tq,Tk,D,causal", [
    (1, 2, 2, 64, 64, 32, True),
    (2, 4, 2, 128, 128, 64, True),     # GQA
    (1, 4, 1, 64, 128, 32, False),     # MQA, cross-length, bidirectional
    (1, 2, 2, 256, 256, 16, True),     # several q and k blocks
    (1, 2, 1, 200, 200, 12, True),     # ragged T and D
])
def test_flash_attention_plain_matches_reference(B, H, Hkv, Tq, Tk, D,
                                                 causal):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, H, Tq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Tk, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Tk, D)).astype(np.float32)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal).numpy()
    if Tq % 64 == 0 and Tk % 64 == 0:        # the Pallas needs whole blocks
        want = rflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, block_q=64, block_k=64, interpret=True)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    oracle = rref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=1e-5,
                               atol=1e-5)


def test_flash_attention_plain_bf16():
    rng = np.random.default_rng(1)
    q, k, v = (_bf16_np(rng.normal(size=(1, 2, 128, 32))) for _ in range(3))
    got = ops.flash_attention(*(_t(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    want = np.asarray(rflash(*(jnp.asarray(a, jnp.bfloat16)
                               for a in (q, k, v)), interpret=True),
                      np.float32)
    got = got.float().numpy()
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-6)


def test_flash_attention_causal_needs_equal_lengths():
    q = torch.zeros((1, 2, 8, 16))
    k = torch.zeros((1, 2, 16, 16))
    with pytest.raises(ValueError, match="Tq == Tk"):
        ops.flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="Tq == Tk"):
        ref.flash_attention(q, k, k, causal=True)
    assert ops.flash_attention(q, k, k, causal=False).shape == q.shape


def _flash_tensor_core_arithmetic(q, k, v, *, split: bool):
    """The tensor-core kernel's arithmetic (``csrc/flash_attention.cu``) in
    plain torch, causal: S = Q K^T from bf16 values in float32, the 1/sqrt(D)
    scale after the product, the reference's online softmax over blocks of
    128 keys, and P.V with P rounded to bf16, as p_hi alone (``split``
    False) or as p_hi + p_lo with p_lo = bf16(p - p_hi) (True)."""
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    qf = q.float().reshape(B, Hkv, G * T, D)
    rows = torch.arange(T).repeat(G)[:, None]
    m = torch.full((B, Hkv, G * T, 1), -math.inf)
    l = torch.zeros((B, Hkv, G * T, 1))
    acc = torch.zeros((B, Hkv, G * T, D))
    for k0 in range(0, T, 128):
        kb, vb = k[:, :, k0:k0 + 128].float(), v[:, :, k0:k0 + 128].float()
        s = (qf @ kb.transpose(-1, -2)) * (1.0 / math.sqrt(D))
        cols = torch.arange(k0, k0 + kb.shape[2])
        s = torch.where(rows >= cols[None, :], s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(torch.isfinite(s), torch.exp(s - m_safe), 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        p_hi = p.bfloat16().float()
        pv = p_hi @ vb
        if split:
            pv = pv + (p - p_hi).bfloat16().float() @ vb
        acc = acc * corr + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).reshape(B, H, T, D).bfloat16()


def test_flash_attention_split_p_keeps_the_bf16_gate():
    """Why the tensor-core kernel splits P. With bf16 inputs (GQA, 256
    tokens, D = 64) against the JAX kernel in interpret mode, the gate that
    the card's comparison applies, |out - ref| <= 2^-7 |ref| + 1e-5, holds
    for p_hi + p_lo everywhere. With P rounded once to bf16, as SDPA does,
    6502 of the 65536 outputs fall outside it (the worst by 0.00197): an
    error of 2^-9 of p moves outputs near zero by more than 1e-5."""
    rng = np.random.default_rng(0)
    q, k, v = (_bf16_np(rng.normal(size=s)) for s in
               ((1, 4, 256, 64), (1, 2, 256, 64), (1, 2, 256, 64)))
    want = np.asarray(rflash(*(jnp.asarray(a, jnp.bfloat16)
                               for a in (q, k, v)), interpret=True),
                      np.float32)
    tol = 2.0 ** -7 * np.abs(want) + 1e-5
    tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    split = _flash_tensor_core_arithmetic(tq, tk, tv, split=True)
    assert np.all(np.abs(split.float().numpy() - want) <= tol)
    single = _flash_tensor_core_arithmetic(tq, tk, tv, split=False)
    assert np.sum(np.abs(single.float().numpy() - want) > tol) > 0.05 * want.size


def _tf32(x):
    """float32 values rounded to TF32 as ``cvt.rna.tf32.f32`` does: to
    nearest on the bit pattern, ties away from zero (add half of the 13
    dropped bits' weight to the magnitude, then clear them); inf and NaN are
    kept."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    finite = (b & np.uint32(0x7F800000)) != np.uint32(0x7F800000)
    r = (b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return np.where(finite, r, b).view(np.float32)


def _split(x):
    """x = hi + lo, both TF32 (``csrc/tf32x3.cuh``)."""
    hi = _tf32(x)
    return hi, _tf32(np.float32(x) - hi)


def test_tf32_split_rebuilds_float32():
    """hi keeps 10 fraction bits (the low 13 are zero), lo the next 11, so
    hi + lo is x to within 2^-22 |x| over float32's normal range; ties round
    away from zero; inf and NaN pass."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=20000) * np.exp2(rng.integers(-100, 100, 20000))
         ).astype(np.float32)
    hi, lo = _split(x)
    for part in (hi, lo):
        assert not np.any(part.view(np.uint32) & np.uint32(0x1FFF))
    assert np.all(np.abs(hi.astype(np.float64) + lo - x)
                  <= 2.0 ** -22 * np.abs(x.astype(np.float64)))
    assert np.all(np.abs(hi - x) <= 2.0 ** -11 * np.abs(x))
    tie = np.array([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12],
                   np.float32)
    assert np.array_equal(_tf32(tie), np.array([1 + 2 ** -10,
                                                -(1 + 2 ** -10), 1],
                                               np.float32))
    special = np.array([np.inf, -np.inf, np.nan], np.float32)
    got = _tf32(special)
    assert np.array_equal(got[:2], special[:2]) and np.isnan(got[2])


def _tf32_product(a, b, passes):
    """a @ b.T of float32 matrices as the tensor cores take it: one TF32
    pass (hi.hi) or three (lo.hi + hi.lo + hi.hi), products of TF32 values
    (exact in float32) summed in float32."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    if passes == 1:
        return a_hi @ b_hi.T
    return a_lo @ b_hi.T + a_hi @ b_lo.T + a_hi @ b_hi.T


def test_l2dist_split_tf32_holds_the_d2_tolerance():
    """Why csrc/l2dist.cu takes three TF32 passes. At d = 100 against the
    JAX kernel in interpret mode, |q|^2 + |x|^2 - 2 q.x with the three-pass
    product stays within the card's d2 tolerance, 1e-5 (|q|^2 + |x|^2),
    everywhere (chip_smoke.DTOL; its worst entry here is 0.038 of it);
    with one pass 73% of the entries fall outside it, the worst by 12.7
    times: q.x then loses about 2^-11 of each term."""
    rng = np.random.default_rng(12)
    q = rng.normal(size=(64, 100)).astype(np.float32)
    xb = rng.normal(size=(600, 100)).astype(np.float32)
    want = np.asarray(rops.l2dist(q, xb, interpret=True))
    qn = (q * q).sum(-1)[:, None]
    xn = (xb * xb).sum(-1)[None, :]
    limit = 1e-5 * (qn + xn)
    for passes, ok in ((3, True), (1, False)):
        got = np.maximum(qn + xn - 2 * _tf32_product(q, xb, passes), 0)
        bad = np.abs(got - want) > limit
        if ok:
            assert not bad.any()
            assert np.max(np.abs(got - want) / limit) < 0.5
        else:
            assert bad.mean() > 0.5


def _flash_split_tf32(q, k, v, *, passes, block_k=32):
    """csrc/flash_attention_f32.cu's arithmetic in numpy, causal: q scaled
    by 1/sqrt(D) in float32, S and P.V through ``_tf32_product`` (its split
    of every operand), the TPU kernel's online softmax over tiles of
    ``block_k`` keys (the kernel's tile at D <= 128) with its -inf guards,
    out = acc / max(l, 1e-30)."""
    B, H, T, D = q.shape
    G = H // k.shape[1]
    out = np.zeros_like(q)
    scale = np.float32(1.0 / math.sqrt(D))
    rows = np.arange(T)[:, None]
    for b in range(B):
        for h in range(H):
            qs = q[b, h] * scale
            kh, vh = k[b, h // G], v[b, h // G]
            m = np.full((T, 1), -np.inf, np.float32)
            l = np.zeros((T, 1), np.float32)
            acc = np.zeros((T, D), np.float32)
            for k0 in range(0, T, block_k):
                kb, vb = kh[k0:k0 + block_k], vh[k0:k0 + block_k]
                s = _tf32_product(qs, kb, passes)
                cols = np.arange(k0, k0 + kb.shape[0])[None, :]
                s = np.where(rows >= cols, s, -np.inf)
                m_new = np.maximum(m, s.max(-1, keepdims=True))
                m_safe = np.where(np.isfinite(m_new), m_new, 0)
                with np.errstate(invalid="ignore"):
                    p = np.where(np.isfinite(s), np.exp(s - m_safe), 0)
                    corr = np.where(np.isfinite(m), np.exp(m - m_safe), 0)
                p = p.astype(np.float32)
                l = l * corr + p.sum(-1, keepdims=True)
                acc = acc * corr + _tf32_product(p, vb.T, passes)
                m = m_new
            out[b, h] = acc / np.maximum(l, 1e-30)
    return out


def test_flash_attention_split_tf32_holds_the_float32_gate():
    """Why csrc/flash_attention_f32.cu splits both products. At (1, 4, 256,
    64) float32, GQA, causal, against the JAX kernel in interpret mode, the
    three-pass products keep every output within the card's float32 gate,
    |out - ref| <= 1e-4 |ref| + 1e-4 (the worst at 0.0056 of it); with one
    TF32 pass 5886 of the 65536 outputs fall outside it."""
    rng = np.random.default_rng(13)
    q = rng.normal(size=(1, 4, 256, 64)).astype(np.float32)
    k = rng.normal(size=(1, 2, 256, 64)).astype(np.float32)
    v = rng.normal(size=(1, 2, 256, 64)).astype(np.float32)
    want = np.asarray(rflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, block_q=64, block_k=64,
                             interpret=True))
    gate = 1e-4 * np.abs(want) + 1e-4
    split = _flash_split_tf32(q, k, v, passes=3)
    assert np.all(np.abs(split - want) <= gate)
    single = _flash_split_tf32(q, k, v, passes=1)
    assert np.sum(np.abs(single - want) > gate) > 0.05 * want.size



def _to_f32(x, toward_zero):
    """float64 values rounded to float32: to nearest, or toward zero."""
    y = x.astype(np.float32)
    if toward_zero:
        over = np.abs(y.astype(np.float64)) > np.abs(x)
        y = np.where(over, np.nextafter(y, np.float32(0)), y)
    return y


def _tensor_core_product(acc, a, b, toward_zero):
    """acc + a @ b.T as the split-TF32 kernels issue it: per step of 8 in
    k, the passes lo.hi, hi.lo and hi.hi, each one instruction that adds
    its 8 exact TF32 products to acc and rounds the sum once to float32."""
    a_hi, a_lo = (x.astype(np.float64) for x in _split(a))
    b_hi, b_lo = (x.astype(np.float64) for x in _split(b))
    for k0 in range(0, a.shape[1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            acc = _to_f32(acc + x[:, ks] @ y[:, ks].T, toward_zero)
    return acc


def _flash_on_tensor_cores(q, k, v, toward_zero, fresh, block_k=32):
    """One causal head [T, D] with both products on the tensor cores
    (``_tensor_core_product``). fresh: csrc/flash_attention_f32.cu's wgmma
    order, each two k8 steps of S and each key tile's P.V summed from zero
    and added on the CUDA cores (O = O corr + P.V, rounded once); else S of
    a key tile in one accumulator and O, scaled by corr, accumulated by
    every P.V instruction."""
    T, D = q.shape
    qs = q * np.float32(1.0 / math.sqrt(D))
    rows = np.arange(T)[:, None]
    m = np.full((T, 1), -np.inf, np.float32)
    l = np.zeros((T, 1), np.float32)
    acc = np.zeros((T, D), np.float32)
    for k0 in range(0, T, block_k):
        kb, vb = k[k0:k0 + block_k], v[k0:k0 + block_k]
        if fresh:
            s = np.zeros((T, len(kb)), np.float32)
            for d0 in range(0, D, 16):
                ds = slice(d0, d0 + 16)
                s = s + _tensor_core_product(np.zeros(s.shape), qs[:, ds],
                                             kb[:, ds], toward_zero)
        else:
            s = _tensor_core_product(np.zeros((T, len(kb))), qs, kb,
                                     toward_zero)
        s = np.where(rows >= np.arange(k0, k0 + len(kb))[None, :], s, -np.inf)
        m_new = np.maximum(m, s.max(-1, keepdims=True))
        m_safe = np.where(np.isfinite(m_new), m_new, 0)
        with np.errstate(invalid="ignore"):
            p = np.where(np.isfinite(s), np.exp(s - m_safe), 0)
            corr = np.where(np.isfinite(m), np.exp(m - m_safe), 0)
        p, corr = p.astype(np.float32), corr.astype(np.float32)
        l = l * corr + p.sum(-1, keepdims=True)
        if fresh:
            pv = _tensor_core_product(np.zeros(acc.shape), p, vb.T, toward_zero)
            acc = (acc.astype(np.float64) * corr + pv).astype(np.float32)
        else:
            acc = _tensor_core_product(acc * corr, p, vb.T, toward_zero)
        m = m_new
    return acc / np.maximum(l, 1e-30)


def test_flash_attention_split_tf32_truncating_accumulation():
    """Why csrc/flash_attention_f32.cu sums short runs of tensor-core
    instructions from zero. Numerical studies of NVIDIA's tensor cores
    find that an instruction rounds its float32 sum toward zero. Modelled
    so at (1, 4, 256, 64) float32 GQA causal, with each score's 3 D / 8
    and each output's 3 Tk / 8 instructions in one accumulator, every
    output holds the float32 gate against the JAX kernel in interpret
    mode, but against float64 the largest error is 3.8e-6, 7.3 times that
    of the same order rounding to nearest, and 0.87 of the error points
    toward zero (0.02 when rounding to nearest): truncation's bias adds up
    along the accumulator. In the kernel's order (two k8 steps of S and
    one key tile of P.V a fresh accumulator, added on the CUDA cores) it
    is 9.3e-7, 4.0 times smaller."""
    rng = np.random.default_rng(13)
    q = rng.normal(size=(1, 4, 256, 64)).astype(np.float32)
    k = rng.normal(size=(1, 2, 256, 64)).astype(np.float32)
    v = rng.normal(size=(1, 2, 256, 64)).astype(np.float32)
    want = np.asarray(rflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, block_q=64, block_k=64,
                             interpret=True))
    s = np.einsum("htd,hsd->hts", q[0].astype(np.float64),
                  np.repeat(k[0], 2, 0).astype(np.float64)) / 8.0
    s = np.where(np.tril(np.ones((256, 256), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    exact = (p / p.sum(-1, keepdims=True)) @ np.repeat(v[0], 2, 0)
    stats = {}
    for fresh in (False, True):
        for tz in (False, True):
            got = np.stack([_flash_on_tensor_cores(q[0, h], k[0, h // 2],
                                                   v[0, h // 2], tz, fresh)
                            for h in range(4)])
            assert np.all(np.abs(got - want[0])
                          <= 1e-4 * np.abs(want[0]) + 1e-4)
            err = got - exact
            stats[fresh, tz] = (np.abs(err).max(),
                                np.sum(-np.sign(exact) * err)
                                / np.abs(err).sum())
    assert stats[False, True][0] > 4 * stats[False, False][0]
    assert stats[False, True][1] > 0.7 and abs(stats[False, False][1]) < 0.2
    assert stats[True, True][0] < stats[False, True][0] / 3


def test_kernel_library_hash_covers_the_shared_headers(tmp_path,
                                                       monkeypatch):
    """A library is rebuilt when a header it may include changes, not only
    its own source (``_build._lib_path``)."""
    from repro_torch.kernels import _build
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._lib_path("k")
    assert _build._lib_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._lib_path("k") != first
    assert _build._lib_path("k").parent == _build.BUILD_DIR
