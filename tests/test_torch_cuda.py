"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu``: it needs an sm_90 card (H100) and skips
elsewhere. The module imports no JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

d2 agrees within 1e-5 of |x|^2 + |q|^2 (another float summation order);
attr words, the scan tile and popcounts are bit-exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.filters import pack_bits
from repro_torch.kernels import ops, ref


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _packed(rng, n, d, a):
    x = rng.normal(size=(n, d)).astype(np.float32)
    norm = (x * x).sum(-1, keepdims=True)
    words = rng.integers(0, 2 ** 32, (n, a), dtype=np.uint64).astype(
        np.uint32)
    words[0, 0] = 0x7FC00001                 # a NaN-looking payload
    return np.concatenate([x, norm, words.view(np.float32)], axis=1)


@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_fused_expand_matches_plain(sm90):
    rng = np.random.default_rng(4)
    packed = _t(_packed(rng, 5000, 100, 2)).to(sm90)
    ids = _t(rng.integers(0, 5000, (300, 48)).astype(np.int32)).to(sm90)
    q = _t(rng.normal(size=(300, 100)).astype(np.float32)).to(sm90)
    qn = (q * q).sum(-1)
    before = ops.LAUNCHES["fused_expand"]
    d2, words = ops.fused_expand(packed, ids, q, qn, d=100)
    assert ops.LAUNCHES["fused_expand"] == before + 1
    pd2, pwords = ref.fused_expand(packed, ids, q, qn, d=100)
    scale = packed[ids.long(), 100] + qn[:, None]
    assert bool(((d2 - pd2).abs() <= 1e-5 * scale).all())
    assert torch.equal(words.view(torch.int32),
                       pwords.contiguous().view(torch.int32))


@pytest.mark.gpu
def test_cuda_gather_dist_tile_bit_exact(sm90):
    rng = np.random.default_rng(5)
    xb = _t(rng.normal(size=(4096 * 3, 104)).astype(np.float32)).to(sm90)
    q = _t(rng.normal(size=(37, 104)).astype(np.float32)).to(sm90)
    for base in (torch.full((37,), 1, dtype=torch.int32),
                 _t(rng.integers(0, 3, 37).astype(np.int32))):
        base = base.to(sm90)
        assert torch.equal(ops.gather_dist_tile(xb, base, q, tile=4096),
                           ref.gather_dist_tile(xb, base, q, tile=4096))


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["xor", "deficit"])
def test_cuda_bitset_dist_exact(sm90, op):
    g = torch.Generator(device=sm90)
    g.manual_seed(0)
    sat = torch.rand((50, 1 << 12), generator=g, device=sm90) < 0.5
    a = pack_bits(sat)
    b = pack_bits(torch.rand((700, 1 << 12), generator=g, device=sm90) < 0.5)
    assert torch.equal(ops.bitset_dist(a, b, op=op),
                       ref.bitset_dist(a, b, op=op))
