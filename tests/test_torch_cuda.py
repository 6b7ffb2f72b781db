"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu``: it needs an sm_90 card (H100) and skips
elsewhere. The module imports no JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

d2 agrees within 1e-5 of |x|^2 + |q|^2 (another float summation order;
l2dist's split-TF32 product loses about 2^-22 of |q||x| besides);
attr words, the scan tile and popcounts are bit-exact. The int8 fused
layout takes the same kernel and the same gate, and the streaming index's
delta route returns the plain scan's ids. gather_dist agrees
within 1e-5 of its value (a sum of squares). Attention in float32 agrees
within 1e-4 (another order of the float32 sums and the split-TF32
products, amplified by exp); in bf16
both outputs are float32 values rounded once, so they may differ by one
bf16 step, 2^-7 of the value, plus 1e-5: the tensor-core kernel rounds p
to bf16 as p_hi + p_lo, about 2^-17 of p (``test_torch_kernels.py``).
Its bf16-score variant rounds S and p where its plain version does, so
it is held element by element to one bf16 step, with room for the rare
rounding point that the two float32 sum orders put on either side
(``_bf16_variant_ok``).
The reduced LMs' prefill with the kernel (qwen3, and llama4 scout with its
chunked layers split into two launches) agrees with the plain attention
within 1e-4 (float32) and 2^-6 (bf16) of its largest logit, as
``test_torch_lm.py`` states; its training loss and gradients with the
kernel forward agree with the plain attention's within
``test_torch_train.py``'s tolerances (2e-5 float32, 2^-6 bf16). On two or
more cards, a launch on ``cuda:1`` must leave card 0 current (F10).
Reduced llama4 scout trains on the card (kernel forward, the chunk split
of T = 20 into two launches a chunked layer) within
``test_torch_llama4_train.py``'s tolerances (rtol 1e-4, atol 1e-5 of the
largest) of the CPU's plain path, the same tokens routed alike; the MoE
backward gives a dropped token exactly 0 from the routed experts; and the
recsys and GCN steps on the card stay within those tolerances of the CPU's
(``index_add`` sums with atomics on the card: allclose, not bitwise).
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.filters import (pack_bits, range_table, subset_filters,
                                      subset_table)
from repro_torch.serve.layout import build_layout
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
    words[1, 0] = 0xFFFFFFFF
    words[2, -1] = 0x80000000                # -0.0 as a float
    return np.concatenate([x, norm, words.view(np.float32)], axis=1)


def _words(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(
        np.uint32).view(np.int32)


@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda")


def _check_fused_expand(packed, ids, q, qn, d):
    before = ops.LAUNCHES["fused_expand"]
    d2, words = ops.fused_expand(packed, ids, q, qn, d=d)
    assert ops.LAUNCHES["fused_expand"] == before + 1
    pd2, pwords = ref.fused_expand(packed, ids, q, qn, d=d)
    rows = ids.long().clamp(0, packed.shape[0] - 1)
    scale = packed[rows, d] + qn[:, None]
    assert bool(torch.isfinite(d2).all())
    assert bool(((d2 - pd2).abs() <= 1e-5 * scale).all())
    assert torch.equal(words.view(torch.int32),
                       pwords.contiguous().view(torch.int32))


@pytest.mark.gpu
def test_cuda_fused_expand_matches_plain(sm90):
    rng = np.random.default_rng(4)
    packed = _t(_packed(rng, 5000, 100, 2)).to(sm90)
    ids = _t(rng.integers(0, 5000, (300, 48)).astype(np.int32)).to(sm90)
    q = _t(rng.normal(size=(300, 100)).astype(np.float32)).to(sm90)
    _check_fused_expand(packed, ids, q, (q * q).sum(-1), 100)


@pytest.mark.gpu
@pytest.mark.parametrize("d,A", [(100, 1), (100, 2), (100, 3), (200, 2),
                                 (255, 1), (32, 1), (64, 1)])
@pytest.mark.parametrize("C", [1, 7, 144, 145])
@pytest.mark.parametrize("B", [1, 315])
def test_cuda_fused_expand_shapes(sm90, d, A, C, B):
    """Row widths of 102, 103 and 104 words (the kernel reads them in
    pairs, singly and in fours), rows wider than one pass of 128 words (203
    and 257), the calibration grid's 34 and 66, C on both sides of the main path's 144, ids out of range
    (clamped) and attr words that are a NaN payload, all ones or the sign
    bit alone. Each case also runs on a copy of the table that starts one
    float past a 16-byte boundary, where only single-word loads are
    aligned."""
    rng = np.random.default_rng(d * 1000 + A * 100 + C)
    N, rw = 3000, d + 1 + A
    packed = _t(_packed(rng, N, d, A)).to(sm90)
    shifted = torch.empty(N * rw + 1, device=sm90)[1:].view(N, rw)
    shifted.copy_(packed)
    ids = rng.integers(-2, N + 2, (B, C)).astype(np.int32)
    ids[0, 0], ids[-1, -1] = -1, N
    ids = _t(ids).to(sm90)
    q = _t(rng.normal(size=(B, d)).astype(np.float32)).to(sm90)
    for table in (packed, shifted):
        _check_fused_expand(table, ids, q, (q * q).sum(-1), d)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["range", "subset"])
def test_cuda_fused_expand_int8_layout(sm90, kind):
    """The int8 lanes: codes widened to f32, the query folded by the
    scale, the dequantized norm in lane d."""
    rng = np.random.default_rng(6)
    N, d, B, C = 4000, 100, 300, 144
    x = _t(rng.normal(size=(N, d)).astype(np.float32)).to(sm90)
    tab = (range_table(rng.uniform(0, 1, N).astype(np.float32), device=sm90)
           if kind == "range" else
           subset_table(rng.random((N, 30)) < 0.5, 30, device=sm90))
    lay = build_layout(x, tab, vec_dtype="int8")
    ids = _t(rng.integers(-1, N + 1, (B, C)).astype(np.int32)).to(sm90)
    q_eff, qn = lay.fold_query(_t(rng.normal(size=(B, d)).astype(
        np.float32)).to(sm90))
    _check_fused_expand(lay.packed, ids, q_eff.contiguous(), qn, d)


@pytest.mark.gpu
def test_cuda_quantize_int8_equals_cpu(sm90):
    """Codes, scale and dequantized norms on the card equal the CPU's bit
    for bit, ties and a zero column included."""
    from repro_torch.core.quantized import dequant_sq_norms, quantize_int8
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(65536, 100))
         * 10.0 ** rng.integers(-3, 4, 100)).astype(np.float32)
    x[:, 0] = 0.0
    x[:6, 1] = [127.0, 0.5, 1.5, -2.5, -0.5, 126.5]
    x[6:, 1] = 0.0
    hc, hs = quantize_int8(_t(x))
    cc, cs = quantize_int8(_t(x).to(sm90))
    assert torch.equal(cc.cpu(), hc)
    assert torch.equal(cs.cpu().view(torch.int32), hs.view(torch.int32))
    assert torch.equal(dequant_sq_norms(cc, cs).cpu(),
                       dequant_sq_norms(hc, hs))


@pytest.mark.gpu
@pytest.mark.parametrize("n_delta", [60, 5000])
def test_cuda_delta_route_kernels_match_plain(sm90, n_delta):
    """A streaming index on the card: the delta route's kernel scan returns
    the plain versions' ids, and the merged exact search equals the exact
    scan over the concatenated rows."""
    from repro_torch.core.ground_truth import exact_filtered_knn
    from repro_torch.core.jag import JAGConfig, JAGIndex
    from repro_torch.serve.planner import PlannerConfig
    from repro_torch.stream import StreamingJAGIndex
    rng = np.random.default_rng(n_delta)
    N, d, B, L = 3000, 100, 64, 30
    x = rng.normal(size=(N + n_delta, d)).astype(np.float32)
    bits = rng.random((N + n_delta, L)) < 0.5
    idx = StreamingJAGIndex(JAGIndex.build(
        x[:N], subset_table(bits[:N], L, device=sm90),
        JAGConfig(degree=16, ls_build=32, batch_size=512, cand_pool=64),
        device=sm90), compact_frac=0.0)
    idx.insert(x[N:], subset_table(bits[N:], L, device=sm90))
    q = _t(rng.normal(size=(B, d)).astype(np.float32)).to(sm90)
    fb = np.zeros((B, L), bool)
    fb[:, :2] = True
    filt = subset_filters(fb, L, device=sm90)
    ops.reset_launches()
    got = idx.executor.delta(q, filt, k=10)
    assert ops.LAUNCHES["gather_dist_tile"] > 0
    assert ops.LAUNCHES["bitset_dist"] > 0
    xv, dattr, off = idx.delta_arrays()
    want = exact_filtered_knn(xv, dattr, q, filt, k=10,
                              block=min(4096, n_delta), use_kernel=True,
                              impl=ref)
    assert torch.equal(got.ids, torch.where(want.ids >= 0, want.ids + off,
                                            -1))
    assert torch.equal(got.secondary, want.d2)
    res = idx.search_auto(q, filt, k=10, planner=PlannerConfig(
        prefilter_max_sel=1.1, postfilter_min_sel=1.2))
    full = exact_filtered_knn(torch.cat([idx.xb, xv]), idx.attr, q, filt,
                              k=10, use_kernel=True)
    assert torch.equal(res.ids, full.ids)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["subset", "boolean"])
def test_cuda_sharded_prefilter_equals_union(sm90, kind):
    """Four shards of one index on the one card: the sharded exact route
    (each shard's scan through gather_dist_tile and bitset_dist, merged in
    shard order) equals the union index's scan on every field, bit for
    bit, in both dispatch modes."""
    from repro_torch.core.filters import (boolean_filters, boolean_table)
    from repro_torch.core.jag import JAGConfig, JAGIndex
    from repro_torch.serve import ShardedJAGIndex
    from repro_torch.serve import sharded as SH
    from repro_torch.serve.planner import PlannerConfig
    rng = np.random.default_rng(7)
    N, d, B, S = 2000, 24, 48, 4
    x = rng.normal(size=(N, d)).astype(np.float32)
    if kind == "subset":
        tab = subset_table(rng.random((N, 30)) < 0.5, 30, device=sm90)
        fb = np.zeros((B, 30), bool)
        fb[:, :3] = True
        filt = subset_filters(fb, 30, device=sm90)
    else:
        tab = boolean_table(rng.integers(0, 1 << 8, N).astype(np.uint32), 8,
                            device=sm90)
        filt = boolean_filters(rng.random((B, 1 << 8)) < 0.2, 8,
                               device=sm90)
    cfg = JAGConfig(degree=8, ls_build=16, batch_size=256, cand_pool=32)
    union = JAGIndex.build(x, tab, cfg, device=sm90)
    sh = ShardedJAGIndex.build(x, tab, cfg, mesh=[sm90] * S)
    q = _t(rng.normal(size=(B, d)).astype(np.float32)).to(sm90)
    force = PlannerConfig(prefilter_max_sel=1.1, postfilter_min_sel=1.2)
    for mode in ("per_query", "batch"):
        want = union.search_auto(q, filt, k=10, planner=force, mode=mode)
        ops.reset_launches()
        SH.reset_gathers()
        got = sh.search_auto(q, filt, k=10, planner=force, mode=mode)
        assert ops.LAUNCHES["gather_dist_tile"] >= S
        assert ops.LAUNCHES["bitset_dist"] >= S
        assert SH.GATHERS["transfers"] == S
        for f in got._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int((want.ids >= 0).sum()) > 0


@pytest.mark.gpu
def test_cuda_time_route_waits_for_the_card(sm90):
    """``cost.time_route`` times a call to the end of its work on the card:
    a kernel that spins for about 1e8 clocks reads tens of milliseconds,
    where its launch alone returns in microseconds."""
    import time
    from repro_torch.cost import time_route
    cycles = 100_000_000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(cycles)
    launch_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    _, dt = time_route(lambda: torch.cuda._sleep(cycles), warmup=1,
                       repeats=3)
    assert dt > 10 * launch_s and dt > 0.02, (dt, launch_s)


@pytest.mark.gpu
def test_cuda_introspection_fused_bitwise(sm90):
    """The introspective graph route on the card, fused layout: the same
    ids, keys and counts as the standard route bit for bit, hops equal to
    n_expanded, and fused_expand launched."""
    from repro_torch.core.jag import JAGConfig, JAGIndex
    rng = np.random.default_rng(5)
    N, d, B, L = 3000, 100, 64, 30
    bits = rng.random((N, L)) < 0.5
    idx = JAGIndex.build(rng.normal(size=(N, d)).astype(np.float32),
                         subset_table(bits, L, device=sm90),
                         JAGConfig(degree=16, ls_build=32, batch_size=512,
                                   cand_pool=64), device=sm90)
    q = _t(rng.normal(size=(B, d)).astype(np.float32)).to(sm90)
    fb = np.zeros((B, L), bool)
    fb[:, :2] = True
    filt = subset_filters(fb, L, device=sm90)
    ex = idx.executor
    std = ex.graph(q, filt, k=10, ls=64, max_iters=128, layout="fused")
    ops.reset_launches()
    res, st = ex.graph(q, filt, k=10, ls=64, max_iters=128, layout="fused",
                       introspect=True)
    assert ops.LAUNCHES["fused_expand"] > 0
    for f in std._fields:
        assert torch.equal(getattr(res, f), getattr(std, f)), f
    assert torch.equal(st.hops, std.n_expanded)
    assert bool((st.dead_ends <= st.hops).all())


@pytest.mark.gpu
@pytest.mark.parametrize("B,dp,tile", [
    (37, 104, 4096),      # B not a multiple of the 64-lane block
    (1, 104, 4096),
    (130, 8, 4096),
    (70, 136, 4096),
    (37, 104, 200),       # a tile that is no multiple of the 128-row block
    (37, 104, 60),        # tiles below one block: a small delta's scan
    (70, 8, 1),
    (1, 104, 1),
    (64, 32, 4096),       # the calibration grid's scans (d 32 and 64, b 64)
    (64, 64, 4096),
    (64, 32, 256),        # and its delta scans (256 and 1024 rows)
    (64, 64, 1024),
])
def test_cuda_gather_dist_tile_bit_exact(sm90, B, dp, tile):
    rng = np.random.default_rng(5)
    xb = _t(rng.normal(size=(tile * 3, dp)).astype(np.float32)).to(sm90)
    q = _t(rng.normal(size=(B, dp)).astype(np.float32)).to(sm90)
    for base in (torch.full((B,), 1, dtype=torch.int32),
                 _t(rng.integers(0, 3, B).astype(np.int32))):
        base = base.to(sm90)
        before = ops.LAUNCHES["gather_dist_tile"]
        got = ops.gather_dist_tile(xb, base, q, tile=tile)
        assert ops.LAUNCHES["gather_dist_tile"] == before + 1
        assert torch.equal(got, ref.gather_dist_tile(xb, base, q, tile=tile))


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
@pytest.mark.parametrize("op", ["xor", "deficit"])
@pytest.mark.parametrize("W", [1, 2, 3, 4, 5, 32, 33, 1024])
@pytest.mark.parametrize("N", [1, 3, 4095, 4096, 4097])
@pytest.mark.parametrize("B", [1, 568])
def test_cuda_bitset_dist_shapes(sm90, op, W, N, B):
    """Both kernels (runs of four outputs up to W = 2, tiles above), output
    rows that start off a 16-byte boundary (N % 4 != 0), and b taken one row
    past the start of its allocation, which a vector load may not read at
    odd W."""
    rng = np.random.default_rng(W * 10007 + N)
    a = _t(_words(rng, (B, W))).to(sm90)
    store = _t(_words(rng, (N + 1, W))).to(sm90)
    for b in (store[:N], store[1:]):
        before = ops.LAUNCHES["bitset_dist"]
        got = ops.bitset_dist(a, b, op=op)
        assert ops.LAUNCHES["bitset_dist"] == before + 1
        assert torch.equal(got, ref.bitset_dist(a, b, op=op))


def _check_gather_dist(xb, ids, q):
    before = ops.LAUNCHES["gather_dist"]
    got = ops.gather_dist(xb, ids, q)
    assert ops.LAUNCHES["gather_dist"] == before + 1
    want = ref.gather_dist(xb, ids, q)
    assert got.shape == ids.shape and bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= 1e-5 * want + 1e-6).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,N,d,shifted", [
    (300, 48, 5000, 100, False),
    (64, 1, 500, 100, False),        # ragged C: a block spans many lanes
    (64, 7, 500, 100, False),
    (64, 143, 500, 100, False),
    (37, 50, 700, 13, False),        # d % 4 != 0: single-value loads
    (37, 50, 700, 100, True),        # a table one element off 16 bytes
    (40, 33, 600, 128, False),       # bf16 rows of 16-byte loads
    (40, 33, 600, 136, False),       # a second, partial pass of the row
    (3, 2, 40, 12289, False),        # wider than the old shared query
    (1, 144, 5000, 100, False),      # one query lane
])
def test_cuda_gather_dist_matches_plain(sm90, dtype, B, C, N, d, shifted):
    """Ragged C, rows that start off a 16-byte boundary (odd d, d % 8 != 0
    in bf16, or a table that starts one element into its allocation), rows
    read in several passes, and ids of -1 and N (clamped to the first and
    last row)."""
    rng = np.random.default_rng(B * 1000 + C + d)
    xb = _t(rng.normal(size=(N, d)).astype(np.float32)).to(sm90, dtype)
    if shifted:
        table = torch.empty(N * d + 1, dtype=dtype, device=sm90)[1:]
        xb = table.view(N, d).copy_(xb)
    ids = rng.integers(-50, N + 50, (B, C)).astype(np.int32)
    ids[0, 0], ids[-1, -1] = -1, N
    q = _t(rng.normal(size=(B, d)).astype(np.float32)).to(sm90)
    _check_gather_dist(xb, _t(ids).to(sm90), q)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gather_dist_large_c(sm90, dtype):
    """C above 524,280, where a grid of (B, ceil(C / 8)) ran out of grid
    y."""
    g = torch.Generator(device=sm90)
    g.manual_seed(0)
    N, d, C = 1000, 4, 600_000
    xb = torch.randn((N, d), generator=g, device=sm90).to(dtype)
    ids = torch.randint(-1, N + 1, (2, C), generator=g, device=sm90,
                        dtype=torch.int32)
    q = torch.randn((2, d), generator=g, device=sm90)
    _check_gather_dist(xb, ids, q)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,d", [
    (200, 1000, 100), (7, 129, 13), (256, 8192, 128),
    (37, 4099, 100),      # B < 64, N % 4 == 3, several x tiles a block
    (300, 1030, 13),      # d % 4 != 0: single-value loads; N % 4 == 2
    (63, 2049, 130),      # d > 104: two chunks of d
    (129, 517, 256),      # three chunks; a second, nearly empty q tile
    (1, 3, 100),
])
def test_cuda_l2dist_matches_plain(sm90, dtype, B, N, d):
    """Query and x tiles with ragged edges, d past one 104-wide chunk, odd
    N (single-value stores) and, on a copy of xb that starts one element
    past its allocation, loads that cannot be vectors."""
    rng = np.random.default_rng(7)
    q = _t(rng.normal(size=(B, d)).astype(np.float32)).to(sm90, dtype)
    xb = _t(rng.normal(size=(N, d)).astype(np.float32)).to(sm90, dtype)
    shifted = torch.empty(N * d + 1, dtype=dtype, device=sm90)[1:].view(N, d)
    shifted.copy_(xb)
    want = ref.l2dist(q, xb)
    qf, xf = q.float(), xb.float()
    scale = (qf * qf).sum(-1)[:, None] + (xf * xf).sum(-1)[None, :]
    for table in (xb, shifted):
        before = ops.LAUNCHES["l2dist"]
        got = ops.l2dist(q, table)
        assert ops.LAUNCHES["l2dist"] == before + 1
        assert got.shape == (B, N) and bool(torch.isfinite(got).all())
        assert bool(((got - want).abs() <= 1e-5 * scale).all())


def _flash_kernel(dtype, D):
    """The launch counter that a call of ops.flash_attention moves."""
    if dtype == torch.bfloat16 and D % 8 == 0:
        return "flash_attention"          # bf16 wgmma
    return "flash_attention_f32"          # split-TF32 mma.sync


def _check_flash(q, k, v, causal):
    dtype, D = q.dtype, q.shape[-1]
    name = _flash_kernel(dtype, D)
    before = dict(ops.LAUNCHES)
    got = ops.flash_attention(q, k, v, causal=causal)
    moved = {n: ops.LAUNCHES[n] - before[n] for n in before}
    assert moved == {n: int(n == name) for n in before}
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention(q, k, v, causal=causal).float()
    err = (got.float() - want).abs()
    if dtype == torch.float32:
        assert bool((err <= 1e-4 * want.abs() + 1e-4).all())
    else:
        assert bool((err <= 2.0 ** -7 * want.abs() + 1e-5).all())
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [12, 13, 64, 100, 128, 256])
@pytest.mark.parametrize("B,H,Hkv,Tq,Tk,causal", [
    (2, 4, 2, 300, 300, True),      # GQA, ragged T
    (1, 4, 1, 70, 200, False),      # MQA, cross-length, bidirectional
    (1, 2, 1, 1, 1, True),          # one token
    (2, 2, 2, 17, 17, True),        # T shorter than one tile
    (1, 4, 4, 63, 63, True),
    (1, 2, 1, 256, 256, True),      # whole tiles
    (2, 40, 8, 300, 300, True),     # llama4's GQA group of 5
])
def test_cuda_flash_attention_matches_plain(sm90, dtype, D, B, H, Hkv, Tq,
                                            Tk, causal):
    g = torch.Generator(device=sm90)
    g.manual_seed(D)
    q = torch.randn((B, H, Tq, D), generator=g, device=sm90).to(dtype)
    k = torch.randn((B, Hkv, Tk, D), generator=g, device=sm90).to(dtype)
    v = torch.randn((B, Hkv, Tk, D), generator=g, device=sm90).to(dtype)
    _check_flash(q, k, v, causal)


def _bf16_variant_ok(got, want) -> bool:
    """chip_smoke.py's gate of the bf16-score variant against its plain
    version (``bf16_variant_gate``): every output within one bf16 step
    (2^-7 of the value) plus 2^-6, where a score or p that the two float32
    sum orders round to either side of a bf16 rounding point moves its row;
    at most 2^-9 of the outputs past one step plus 1e-5."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    step = 2.0 ** -7 * want.abs()
    return (bool(torch.isfinite(got).all())
            and float((err - step).max()) <= 2.0 ** -6
            and float((err > step + 1e-5).float().mean()) <= 2.0 ** -9)


@pytest.mark.gpu
@pytest.mark.parametrize("knob", ["p_bf16", "scores_bf16"])
@pytest.mark.parametrize("D,B,H,Hkv,Tq,Tk,causal", [
    (64, 1, 2, 1, 40, 40, True), (128, 2, 4, 2, 300, 300, True),
    (256, 1, 2, 2, 200, 200, True), (32, 1, 3, 1, 129, 129, True),
    (128, 1, 2, 1, 70, 200, False), (128, 2, 16, 8, 1024, 1024, True)])
def test_cuda_flash_attention_bf16_variant_matches_plain(
        sm90, knob, D, B, H, Hkv, Tq, Tk, causal):
    """The bf16-score variant (``flash_attention_bf16``, the LM's
    attn_p_bf16 / attn_scores_bf16) against its plain version with the
    same rounding points: one launch of the variant and nothing else,
    within ``_bf16_variant_ok``, which the split kernel (knobs ignored,
    p kept to 2^-17) fails on the same inputs; float32 inputs are cast to
    bf16 first, so they give the same values."""
    g = torch.Generator(device=sm90)
    g.manual_seed(D + Tq)
    q = torch.randn((B, H, Tq, D), generator=g, device=sm90).bfloat16()
    k = torch.randn((B, Hkv, Tk, D), generator=g, device=sm90).bfloat16()
    v = torch.randn((B, Hkv, Tk, D), generator=g, device=sm90).bfloat16()
    flags = {knob: True}
    before = dict(ops.LAUNCHES)
    got = ops.flash_attention(q, k, v, causal=causal, **flags)
    moved = {n: ops.LAUNCHES[n] - before[n] for n in before}
    assert moved == {n: int(n == "flash_attention_bf16") for n in before}
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = ref.flash_attention(q, k, v, causal=causal, **flags)
    assert _bf16_variant_ok(got, want)
    assert not _bf16_variant_ok(ops.flash_attention(q, k, v, causal=causal),
                                want)
    got32 = ops.flash_attention(q.float(), k.float(), v.float(),
                                causal=causal, **flags)
    assert got32.dtype == torch.float32 and torch.equal(got32, got.float())
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.flash_attention(q[..., :12].contiguous(), k[..., :12].contiguous(),
                            v[..., :12].contiguous(), causal=causal, **flags)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [16, 256])
@pytest.mark.parametrize("B,H,Hkv", [(1, 65537, 65537), (3, 21846, 10923)])
def test_cuda_flash_attention_f32_many_heads(sm90, D, B, H, Hkv):
    """B * H above 65535, which a grid of (q tiles, B * H) could not
    launch: the wgmma kernel and its pre-pass over B * Hkv heads (D = 16)
    and the mma.sync kernel (D = 256)."""
    g = torch.Generator(device=sm90)
    g.manual_seed(2)
    q = torch.randn((B, H, 3, D), generator=g, device=sm90)
    k = torch.randn((B, Hkv, 3, D), generator=g, device=sm90)
    v = torch.randn((B, Hkv, 3, D), generator=g, device=sm90)
    _check_flash(q, k, v, True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_cuda_flash_attention_non_finite_row_is_zero(sm90, dtype, D):
    """A query row whose every score is not finite (q = inf): the guards
    give it p = 0 everywhere, l = 0 and an output of 0, as in the plain
    version, and leave the other rows alone."""
    g = torch.Generator(device=sm90)
    g.manual_seed(1)
    q = torch.randn((1, 2, 150, D), generator=g, device=sm90).to(dtype)
    k = torch.randn((1, 1, 150, D), generator=g, device=sm90).to(dtype)
    v = torch.randn((1, 1, 150, D), generator=g, device=sm90).to(dtype)
    q[0, 1, 77] = float("inf")
    got = _check_flash(q, k, v, True)
    assert bool((got[0, 1, 77] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_reduced_prefill_kernel_matches_plain(sm90, dtype):
    cfg = configs.get("qwen3-1.7b").make_reduced()
    cfg = dataclasses.replace(cfg, dtype=dtype)
    params = TT.init_params(cfg, torch.Generator(device=sm90).manual_seed(0),
                            device=sm90)
    g = torch.Generator(device=sm90).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 100), generator=g, device=sm90)
    ops.reset_launches()
    got, _ = TT.prefill(cfg, params, toks, TT.init_cache(cfg, 2, 104, sm90))
    assert ops.LAUNCHES[_flash_kernel(dtype, cfg.hd)] == cfg.n_layers
    want, _ = TT.prefill(cfg, params, toks, TT.init_cache(cfg, 2, 104, sm90),
                         impl=ref)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    assert float((got.float() - want.float()).abs().max()) <= \
        tol * float(want.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_reduced_llama4_prefill_kernel_matches_plain(sm90, dtype):
    """Scout's reduced config (chunks of 8, layers 1 and 3 global without
    RoPE, head_dim 8, a GQA group of 4, four experts a layer): a prompt of
    100 tokens launches the kernel twice a chunked layer (the 12 whole
    chunks, then the tail of 4) and once a global one, and agrees with the
    plain attention within ``test_torch_lm.py``'s tolerances."""
    cfg = configs.get("llama4-scout-17b-a16e").make_reduced()
    cfg = dataclasses.replace(cfg, dtype=dtype)
    params = TT.init_params(cfg, torch.Generator(device=sm90).manual_seed(0),
                            device=sm90)
    g = torch.Generator(device=sm90).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 100), generator=g, device=sm90)
    ops.reset_launches()
    got, _ = TT.prefill(cfg, params, toks, TT.init_cache(cfg, 2, 104, sm90))
    torch.cuda.synchronize()
    chunked = sum(1 for i in range(cfg.n_layers)
                  if (i + 1) % cfg.global_every)
    assert dict(ops.LAUNCHES)[_flash_kernel(dtype, cfg.hd)] == \
        2 * chunked + (cfg.n_layers - chunked) == 6
    assert sum(ops.LAUNCHES.values()) == 6
    want, _ = TT.prefill(cfg, params, toks, TT.init_cache(cfg, 2, 104, sm90),
                         impl=ref)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - want.float()).abs().max()) <= \
        tol * float(want.float().abs().max())


@pytest.mark.gpu
def test_cuda_audit_holds_every_contract(sm90):
    """The route audit on the card: the 13 single-device routes and the 4
    sharded ones over [cuda:0] * 8, zero violations; the fused routes'
    one gather per expansion is one fused_expand launch per iteration
    (plus the seed fetch), the scans launch the tile kernel per block."""
    from repro_torch.analysis.audit import run_audit
    report = run_audit("cuda")
    assert report["violations"] == []
    assert len(report["routes"]) == 13
    assert report["meta"]["device"] == "cuda:0"
    assert report["sharded"]["meta"]["mesh"] == ["cuda:0"] * 8
    assert len(report["sharded"]["routes"]) == 4
    for name, r in report["routes"].items():
        if name.startswith("graph:fused"):
            assert r["gathers_per_expansion"] == 1, name
            assert r["kernel_launches"]["fused_expand"] == \
                r["iterations"][0] + 1, name
        if name in ("prefilter", "delta"):
            assert r["kernel_launches"] == {"gather_dist_tile": 1}, name


@pytest.mark.gpu
def test_cuda_fused_route_one_launch_per_expansion(sm90):
    """The fused graph route at 2,048 rows: exactly one fused_expand
    launch per expansion (plus the seeds), no aten gather of N-row data,
    and the host syncs of the traversal's early-stop reads only."""
    from repro_torch.analysis.audit import analyze_record, loop_checks
    from repro_torch.core.jag import JAGConfig, JAGIndex
    from repro_torch.launch.trace_stats import GATHER_OPS, record, spec
    rng = np.random.default_rng(3)
    n, d, B = 2048, 16, 64
    xb = _t(rng.normal(size=(n, d)).astype(np.float32)).to(sm90)
    bits = rng.random((n, 12)) < 0.5
    idx = JAGIndex.build(xb, subset_table(bits, 12, device=sm90),
                         JAGConfig(degree=16, ls_build=32, batch_size=256,
                                   cand_pool=64, ov_max=512), device=sm90)
    fb = np.zeros((B, 12), bool)
    fb[:, :2] = True
    filt = subset_filters(fb, 12, device=sm90)
    q = _t(rng.normal(size=(B, d)).astype(np.float32)).to(sm90)
    ex = idx.executor
    ex.graph(q, filt, k=10, ls=32, max_iters=64, layout="fused")
    ops.reset_launches()
    res, recs = record(lambda: ex.graph(q, filt, k=10, ls=32, max_iters=64,
                                        layout="fused"))
    torch.cuda.synchronize()
    st = analyze_record(recs, n_rows=n, adj=spec(idx.graph).key)
    it = st["adjacency_gathers"]
    assert it > 0 and st["gathers_per_expansion"] == 1
    assert ops.LAUNCHES["fused_expand"] == it + 1
    assert st["kernel_launches"] == {"fused_expand": it + 1}
    assert not [r for r in recs if r.name in GATHER_OPS
                and r.inputs[0].shape[:1] == (n,)
                and r.inputs[0].key != spec(idx.graph).key]
    assert st["host_syncs"] == loop_checks(it, 64)
    assert st["f64_ops"] == 0
    assert bool((res.ids >= 0).any())


@pytest.mark.gpu
def test_cuda_sharded_transfers_on_distinct_cards(sm90):
    """Shards on distinct cards (every card of the machine, two or more):
    each sharded route call records one broadcast and one packed gather
    of B * (3k + 2) * 4 bytes per shard and no other cross-device copy,
    as the audit counts them on a repeated card, and the exact route
    equals the union index's scan."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    from repro_torch.core.jag import JAGConfig, JAGIndex
    from repro_torch.distributed.sharding import serve_mesh
    from repro_torch.launch.trace_stats import (collective_bytes,
                                                collective_counts, record)
    from repro_torch.serve import ShardedJAGIndex
    S = torch.cuda.device_count()
    rng = np.random.default_rng(11)
    N, d, B, k = 500 * S, 24, 32, 10
    x = rng.normal(size=(N, d)).astype(np.float32)
    tab = subset_table(rng.random((N, 30)) < 0.5, 30, device=sm90)
    fb = np.zeros((B, 30), bool)
    fb[:, :3] = True
    filt = subset_filters(fb, 30, device=sm90)
    cfg = JAGConfig(degree=8, ls_build=16, batch_size=256, cand_pool=32)
    mesh = serve_mesh(S)
    sh = ShardedJAGIndex.build(x, tab, cfg, mesh=mesh)
    union = JAGIndex.build(x, tab, cfg, device=sm90)
    q = _t(rng.normal(size=(B, d)).astype(np.float32)).to(sm90)
    ex = sh.executor
    calls = {
        "prefilter": lambda: ex.prefilter(q, filt, k=k),
        "graph": lambda: ex.graph(q, filt, k=k, ls=32, max_iters=32),
    }
    for name, call in calls.items():
        call()
        res, recs = record(call)
        torch.cuda.synchronize()
        assert collective_counts(recs) == {"broadcast": S,
                                           "packed_gather": S}, name
        assert collective_bytes(recs)["packed_gather"] == \
            S * B * (3 * k + 2) * 4, name
        assert res.ids.device == mesh[0]
    want = union.executor.prefilter(q, filt, k=k)
    got = ex.prefilter(q, filt, k=k)
    assert torch.equal(got.ids, want.ids)
    assert int((want.ids >= 0).sum()) > 0


def _seven_launches(dev, gen):
    """One tiny call of each C entry on ``dev`` (the seven kernels and the
    bf16-score variant), as (kernel name, kernel call, check of the two
    outputs)."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    d = 16
    x = rnd(64, d)
    packed = torch.cat([x, (x * x).sum(-1, keepdim=True),
                        ints(1 << 20, 64, 2).float()], 1).contiguous()
    q = rnd(3, d)
    qn = (q * q).sum(-1)
    ids = ints(64, 3, 5)
    base = ints(4, 3)
    xbt = rnd(4 * 32, d)
    wa, wb = ints(1 << 30, 3, 2), ints(1 << 30, 9, 2)
    fq, fk, fv = rnd(1, 2, 40, 64), rnd(1, 1, 40, 64), rnd(1, 1, 40, 64)

    def close(rel):
        return lambda got, want: bool(
            ((got - want).abs() <= rel * (want.abs() + 1)).all())

    def fused(got, want):
        return close(1e-5)(got[0], want[0]) and torch.equal(
            got[1].view(torch.int32), want[1].contiguous().view(torch.int32))

    def flash_bf16(got, want):
        return bool(((got.float() - want.float()).abs()
                     <= 2.0 ** -7 * want.float().abs() + 1e-5).all())
    fb = [t.to(torch.bfloat16) for t in (fq, fk, fv)]
    return [
        ("fused_expand", lambda m: m.fused_expand(packed, ids, q, qn, d=d),
         fused),
        ("gather_dist_tile",
         lambda m: m.gather_dist_tile(xbt, base, q, tile=32), torch.equal),
        ("bitset_dist", lambda m: m.bitset_dist(wa, wb, op="deficit"),
         torch.equal),
        ("gather_dist", lambda m: m.gather_dist(x, ids, q), close(1e-5)),
        ("l2dist", lambda m: m.l2dist(q, x), close(1e-5)),
        ("flash_attention", lambda m: m.flash_attention(*fb), flash_bf16),
        ("flash_attention_bf16",
         lambda m: m.flash_attention(*fb, scores_bf16=True),
         _bf16_variant_ok),
        ("flash_attention_f32", lambda m: m.flash_attention(fq, fk, fv),
         close(1e-4)),
    ]


@pytest.mark.gpu
def test_cuda_launch_on_another_card_keeps_the_current_device(sm90):
    """F10: with card 0 current, each of the eight C entries (the seven
    kernels and the bf16-score variant) launched on cuda:1 leaves card 0
    current (so the next ``device="cuda"`` allocation stays on card 0) and
    agrees with its plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 1)
    gen = torch.Generator(device=dev).manual_seed(0)
    calls = _seven_launches(dev, gen)
    assert sorted(n for n, _, _ in calls) == sorted(ops.LAUNCHES)
    for name, call, same in calls:
        before = ops.LAUNCHES[name]
        got = call(ops)
        assert ops.LAUNCHES[name] == before + 1, name
        assert torch.cuda.current_device() == 0, name
        assert torch.empty(1, device="cuda").device.index == 0, name
        torch.cuda.synchronize(dev)
        assert same(got, call(ref)), name


def _train_pair(sm90, dtype, accum=1):
    """The reduced qwen3's loss and gradients on the card through the
    Function (kernel forward) and through the plain attention."""
    from repro_torch.data.pipelines import lm_batch
    from repro_torch.kernels import autograd
    from repro_torch.train import accumulate_grads
    cfg = dataclasses.replace(configs.get("qwen3-1.7b").make_reduced(), dtype=dtype)
    params = TT.init_params(cfg, torch.Generator(device=sm90).manual_seed(0),
                            device=sm90).requires_grad_(True)
    batch = lm_batch(0, 2 * accum, 100, cfg.vocab, seed=1)
    out = {}
    for name, impl in (("kernel", autograd), ("plain", ref)):
        ops.reset_launches()
        loss, _, grads = accumulate_grads(
            lambda p, b: TT.loss_fn(cfg, p, b, impl=impl), params, batch,
            accum)
        torch.cuda.synchronize()
        out[name] = (loss, {n: g.clone() for n, g in grads.items()},
                     dict(ops.LAUNCHES))
    return cfg, out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_reduced_training_kernel_matches_plain(sm90, dtype):
    """The training loss and every gradient with the kernel's forward
    against the plain attention under autograd, at the CPU tests'
    tolerances (test_torch_train.py: 2e-5 in float32, 2^-6 in bf16, of
    the largest); the kernel of the dtype launches once per layer in the
    forward and once in the remat recompute, and the backward none."""
    cfg, out = _train_pair(sm90, dtype)
    tol = 2e-5 if dtype == torch.float32 else 2.0 ** -6
    name = _flash_kernel(dtype, cfg.hd)
    (lk, gk, nk), (lp, gp, np_) = out["kernel"], out["plain"]
    assert nk[name] == 2 * cfg.n_layers
    assert sum(nk.values()) == nk[name] and sum(np_.values()) == 0
    assert abs(float(lk) - float(lp)) <= tol * abs(float(lp))
    for n, g in gp.items():
        assert bool(torch.isfinite(gk[n]).all()) and bool((gk[n] != 0).any())
        err = float((gk[n] - g).abs().max())
        assert err <= tol * float(g.abs().max()), (n, err)


@pytest.mark.gpu
def test_cuda_train_steps_and_checkpoint_round_trip(sm90, tmp_path):
    """Two bf16 steps at accum=2 on the card (the kernel launched 2 x
    layers x microbatches times a step), then a checkpoint of the
    parameters and the AdamW state restored onto the card and onto the
    CPU, bit for bit."""
    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.data.pipelines import lm_batch
    from repro_torch.train import OptConfig, init_state, make_train_step
    cfg = configs.get("qwen3-1.7b").make_reduced()
    params = TT.init_params(cfg, torch.Generator(device=sm90).manual_seed(0),
                            device=sm90).requires_grad_(True)
    state = init_state(params)
    step = make_train_step(lambda p, b: TT.loss_fn(cfg, p, b),
                           OptConfig(warmup_steps=1, total_steps=4), accum=2)
    for s in range(2):
        ops.reset_launches()
        params, state, m = step(params, state, lm_batch(s, 4, 64, cfg.vocab))
        torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_attention"] == 2 * cfg.n_layers * 2
        assert all(bool(torch.isfinite(v)) for v in m.values())
    live = {"params": params, "opt": state,
            "bf16": params.embed.detach().to(torch.bfloat16)}
    save_pytree(live, str(tmp_path), 2)
    from repro_torch.checkpoint.checkpoint import _flatten
    want = _flatten(live)
    for dev in (sm90, torch.device("cpu")):
        fresh = TT.LM(cfg, torch.device("meta"))
        tmpl = {"params": fresh, "opt": init_state(params),
                "bf16": live["bf16"]}
        got, _ = load_pytree(tmpl, str(tmp_path), 2, device=dev)
        flat = _flatten(got)
        assert set(flat) == set(want)
        for k, w in want.items():
            assert flat[k].device.type == dev.type, k
            assert flat[k].dtype == w.dtype, k
            assert torch.equal(flat[k].cpu().reshape(-1).view(torch.uint8),
                               w.detach().cpu().reshape(-1).view(
                                   torch.uint8)), k


# -- llama4 training and the recsys and GNN families --------------------------

FAMILY_RTOL = 1e-4


def _step_pair(sm90, params, loss_fn, batches, accum=1):
    """The same steps from the same weights on the card and then on the
    CPU (``make_train_step``, AdamW): for each, the metrics, launches and
    MoE routings (``transformer.route``'s eidx and keep, in call order) a
    step, and the parameters after the last."""
    from repro_torch.train import OptConfig, init_state, make_train_step
    real = TT.route
    runs = []
    for dev in (sm90, torch.device("cpu")):
        p = copy.deepcopy(params).to(dev).requires_grad_(True)
        state = init_state(p)
        step = make_train_step(loss_fn, OptConfig(warmup_steps=1,
                                                  total_steps=10), accum)
        ms, launches, routes = [], [], []
        for b in batches:
            calls = []

            def rec(*a, **kw):
                calls.append(real(*a, **kw))
                return calls[-1]
            ops.reset_launches()
            TT.route = rec
            try:
                p, state, m = step(p, state, b)
            finally:
                TT.route = real
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms.append({k: float(v) for k, v in m.items()})
            launches.append(dict(ops.LAUNCHES))
            routes.append([(r.eidx.cpu(), r.keep.cpu()) for r in calls])
        runs.append(dict(metrics=ms, launches=launches, routes=routes,
                         params={n: t.detach().cpu()
                                 for n, t in p.named_parameters()}))
    return runs


def _params_within_lr(got, want, metrics, bound=0.05):
    lr_sum = sum(m["lr"] for m in metrics)
    for n, w in want.items():
        err = float((got[n].float() - w.float()).abs().max())
        assert err <= bound * lr_sum, (n, err / lr_sum)


@pytest.mark.gpu
def test_cuda_reduced_llama4_training_step_matches_cpu(sm90):
    """Reduced scout in float32 (four MoE layers, layers 0 and 2 chunked
    with chunks of 8, 1 and 3 global), T = 20: a forward launches
    ``flash_attention_f32`` twice on a chunked layer (two whole chunks,
    the tail of 4) and once on a global one, 6 in all, and the remat
    recompute as many again; the backward none. Two steps at accum 2
    against the CPU's plain path: every routing equal, metrics within the
    tolerance, parameters within 0.05 of the summed lr."""
    from repro_torch.data.pipelines import lm_batch
    cfg = dataclasses.replace(configs.get("llama4-scout-17b-a16e").make_reduced(),
                              dtype=torch.float32)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batches = [lm_batch(s, 4, 20, cfg.vocab, seed=1) for s in range(2)]
    fwd_calls = []

    def loss_fn(p, b):
        n0 = sum(ops.LAUNCHES.values())
        out = TT.loss_fn(cfg, p, b)
        fwd_calls.append(sum(ops.LAUNCHES.values()) - n0)
        return out
    card, cpu = _step_pair(sm90, params, loss_fn, batches, accum=2)
    chunked = sum(1 for i in range(cfg.n_layers)
                  if not TT._layer_flags(cfg, i)[0])
    per_fwd = 2 * chunked + (cfg.n_layers - chunked)
    assert per_fwd == 6 and fwd_calls[:4] == [per_fwd] * 4
    for n in card["launches"]:
        assert n["flash_attention_f32"] == 2 * per_fwd * 2
        assert sum(n.values()) == n["flash_attention_f32"]
    for a, b in zip(card["routes"], cpu["routes"]):
        assert len(a) == len(b) == 4 * 2 * 2   # layers, fwd + remat, mbs
        for (ea, ka), (eb, kb) in zip(a, b):
            assert torch.equal(ea, eb) and torch.equal(ka, kb)
    for got, want in zip(card["metrics"], cpu["metrics"]):
        for k in ("loss", "grad_norm"):
            assert got[k] == pytest.approx(want[k], rel=FAMILY_RTOL), k
    _params_within_lr(card["params"], cpu["params"], cpu["metrics"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_moe_backward_gives_dropped_tokens_zero(sm90, dtype):
    """4,096 tokens over four experts at capacity factor 0.5: a quarter
    and more of the tokens land on the dropped row, written in an order
    the card does not fix; their routed output and their gradient from it
    are exactly 0, and every kept token gets a gradient."""
    cfg = dataclasses.replace(configs.get("llama4-scout-17b-a16e").make_reduced(),
                              dtype=dtype, capacity_factor=0.5)
    params = TT.init_params(cfg, torch.Generator(device=sm90).manual_seed(0),
                            sm90).requires_grad_(True)
    g = torch.Generator(device=sm90).manual_seed(1)
    x = torch.randn((4096, cfg.d_model), generator=g, device=sm90,
                    dtype=dtype).requires_grad_(True)
    lw = params.layers[0]
    y, _ = TT._moe_ffn(cfg, lw, x)
    y.backward(torch.randn(y.shape, generator=g, device=sm90, dtype=dtype))
    r = TT.route(cfg, lw.router, x.detach())
    kept = torch.zeros(4096, dtype=torch.bool, device=sm90)
    kept[r.order] = r.keep
    assert 0 < int(kept.sum()) <= 4 * r.cap < 4096
    assert bool((y[~kept] == 0).all())
    assert bool((x.grad[~kept] == 0).all())
    assert bool((x.grad[kept].abs().sum(-1) > 0).all())
    assert bool((lw.e_gate.grad != 0).any())


def _family_case(name):
    """(params on the CPU, loss_fn, two batches) of one family at its
    REDUCED config, from fixed seeds."""
    from repro_torch.data import graph_sampler as GS
    from repro_torch.data.pipelines import recsys_batch
    from repro_torch.models import gnn as N
    from repro_torch.models import recsys as R
    gen = torch.Generator().manual_seed(0)
    if name.startswith("gcn"):
        cfg = configs.get("gcn-cora").make_reduced()
        kind = name.split("-")[1]
        if kind == "molecule":
            def batch(s):
                b = GS.batched_molecules(16, 30, 64, cfg.d_feat,
                                         cfg.n_classes, seed=s)
                b["labels"] = b["labels"][::30]          # one a graph
                return b
            fn = N.graph_loss_fn
        else:
            g = GS.random_graph(2000, 12000, cfg.d_feat, cfg.n_classes,
                                seed=3)
            if kind == "sampled":
                sampler = GS.NeighborSampler(g, (5, 3), seed=4)
                batch = lambda s: sampler.sample(np.arange(64) + 64 * s)
                fn = N.sampled_loss_fn
            else:
                batch = lambda s: {"feats": g.feats, "edges": g.edges,
                                   "labels": g.labels,
                                   "label_mask": np.ones(g.n, np.float32)}
                fn = N.loss_fn
        return (N.init_params(cfg, gen, "cpu"),
                lambda p, b: fn(cfg, p, b), [batch(0), batch(1)])
    cfg = configs.get(name).make_reduced()
    batches = [recsys_batch(s, 256, cfg.n_sparse, cfg.vocabs(), cfg.n_dense,
                            seed=2, kind=cfg.kind, seq_len=cfg.seq_len)
               for s in range(2)]
    return (R.init_params(cfg, gen, "cpu"),
            lambda p, b: R.loss_fn(cfg, p, b), batches)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fm", "deepfm", "wide-deep", "din",
                                  "gcn-full", "gcn-molecule", "gcn-sampled"])
def test_cuda_family_steps_match_cpu(sm90, name):
    """Two AdamW steps of each recsys config and of the GCN's three losses
    on the card against the same steps on the CPU: metrics within
    rtol 1e-4, parameters within 0.05 of the summed lr."""
    params, loss_fn, batches = _family_case(name)
    card, cpu = _step_pair(sm90, params, loss_fn, batches)
    for got, want in zip(card["metrics"], cpu["metrics"]):
        assert set(got) == set(want)
        for k in ("loss", "grad_norm"):
            assert got[k] == pytest.approx(want[k], rel=FAMILY_RTOL), k
    _params_within_lr(card["params"], cpu["params"], cpu["metrics"])
    assert all(sum(n.values()) == 0 for n in card["launches"])
