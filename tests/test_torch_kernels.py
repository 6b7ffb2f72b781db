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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,C,N,d", [(4, 8, 64, 16), (16, 32, 200, 64),
                                     (2, 5, 33, 100)])
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
