"""The kernels' plain PyTorch versions against the JAX reference, and the
CUDA kernels against their plain versions on the card.

On the CPU every ``repro_torch.kernels.ops`` wrapper runs its plain version
(``kernels/ref.py``); those are held against ``repro.kernels.ops`` run in
Pallas interpret mode and against ``repro.kernels.ref``. ``bitset_dist`` is
exact; distances are allclose at rtol 1e-5 (another float summation order).
The CUDA kernels are held against their plain versions in
``test_torch_cuda.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
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
    return np.concatenate([x, norm, words.view(np.float32)], axis=1)


@pytest.mark.parametrize("shape", [(64, 3, 7, 12, 1), (200, 5, 48, 100, 2)])
def test_fused_expand_plain_matches_reference(shape):
    N, B, C, d, A = shape
    rng = np.random.default_rng(0)
    packed = _packed(rng, N, d, A)
    ids = rng.integers(-3, N + 3, (B, C)).astype(np.int32)
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


@pytest.mark.parametrize("op", ["xor", "deficit"])
@pytest.mark.parametrize("W", [1, 3, 40])
def test_bitset_dist_plain_exact(op, W):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2 ** 32, (17, W), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (29, W), dtype=np.uint64).astype(np.uint32)
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


def test_wrappers_count_no_launch_on_the_cpu_and_reject_mixed_devices():
    ops.reset_launches()
    a = torch.zeros((2, 1), dtype=torch.int32)
    ops.subset_deficit(a, a)
    assert all(v == 0 for v in ops.LAUNCHES.values())
    with pytest.raises(ValueError):
        ops.bitset_dist(a, a, op="and")
