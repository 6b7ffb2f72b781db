"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu``: it needs an sm_90 card (H100) and skips
elsewhere. The module imports no JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

d2 agrees within 1e-5 of |x|^2 + |q|^2 (another float summation order);
attr words, the scan tile and popcounts are bit-exact. gather_dist agrees
within 1e-5 of its value (a sum of squares). Attention in float32 agrees
within 1e-4 (another order of the float32 sums, amplified by exp); in bf16
both outputs are float32 values rounded once, so they may differ by one
bf16 step, 2^-7 of the value. The reduced LM's prefill with the kernel
agrees with the plain attention within 1e-4 (float32) and 2^-6 (bf16) of
its largest logit, as ``test_torch_lm.py`` states.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.filters import pack_bits
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as TT


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gather_dist_matches_plain(sm90, dtype):
    rng = np.random.default_rng(6)
    xb = _t(rng.normal(size=(5000, 100)).astype(np.float32)).to(sm90, dtype)
    ids = _t(rng.integers(-50, 5050, (300, 48)).astype(np.int32)).to(sm90)
    q = _t(rng.normal(size=(300, 100)).astype(np.float32)).to(sm90)
    before = ops.LAUNCHES["gather_dist"]
    got = ops.gather_dist(xb, ids, q)
    assert ops.LAUNCHES["gather_dist"] == before + 1
    want = ref.gather_dist(xb, ids, q)
    assert bool(((got - want).abs() <= 1e-5 * want + 1e-6).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,d", [(200, 1000, 100), (7, 129, 13),
                                   (256, 8192, 128)])
def test_cuda_l2dist_matches_plain(sm90, dtype, B, N, d):
    rng = np.random.default_rng(7)
    q = _t(rng.normal(size=(B, d)).astype(np.float32)).to(sm90, dtype)
    xb = _t(rng.normal(size=(N, d)).astype(np.float32)).to(sm90, dtype)
    got = ops.l2dist(q, xb)
    want = ref.l2dist(q, xb)
    qf, xf = q.float(), xb.float()
    scale = (qf * qf).sum(-1)[:, None] + (xf * xf).sum(-1)[None, :]
    assert bool(((got - want).abs() <= 1e-5 * scale).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("B,H,Hkv,Tq,Tk,causal", [
    (2, 4, 2, 300, 300, True),      # GQA, ragged T
    (1, 4, 1, 70, 200, False),      # MQA, cross-length, bidirectional
])
def test_cuda_flash_attention_matches_plain(sm90, dtype, D, B, H, Hkv, Tq,
                                            Tk, causal):
    g = torch.Generator(device=sm90)
    g.manual_seed(D)
    q = torch.randn((B, H, Tq, D), generator=g, device=sm90).to(dtype)
    k = torch.randn((B, Hkv, Tk, D), generator=g, device=sm90).to(dtype)
    v = torch.randn((B, Hkv, Tk, D), generator=g, device=sm90).to(dtype)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention(q, k, v, causal=causal).float()
    err = (got.float() - want).abs()
    if dtype == torch.float32:
        assert bool((err <= 1e-4 * want.abs() + 1e-4).all())
    else:
        assert bool((err <= 2.0 ** -7 * want.abs() + 1e-5).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_reduced_prefill_kernel_matches_plain(sm90, dtype):
    cfg = configs.get("qwen3-1.7b").REDUCED
    cfg = dataclasses.replace(cfg, dtype=dtype)
    params = TT.init_params(cfg, torch.Generator(device=sm90).manual_seed(0),
                            device=sm90)
    g = torch.Generator(device=sm90).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 100), generator=g, device=sm90)
    ops.reset_launches()
    got, _ = TT.prefill(cfg, params, toks, TT.init_cache(cfg, 2, 104, sm90))
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    want, _ = TT.prefill(cfg, params, toks, TT.init_cache(cfg, 2, 104, sm90),
                         impl=ref)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    assert float((got.float() - want.float()).abs().max()) <= \
        tol * float(want.float().abs().max())
