"""On an NVIDIA card: each hand-written CUDA kernel of rsq_tpu_torch
against its plain PyTorch version on the same inputs (the plain versions
are themselves held against rsq_tpu by test_torch_kernels.py).  Imports
neither JAX nor rsq_tpu, so it runs on a machine with the card alone:

    python -m pytest tests/test_torch_cuda.py -q

Without a card every test skips."""

import numpy as np
import pytest
import torch

from rsq_tpu_torch.core.numerics import recip_f32
from rsq_tpu_torch.kernels import kv_cache as TKV
from rsq_tpu_torch.kernels import matmul_w4 as TMW
from rsq_tpu_torch.kernels import paged_kv as TPKV
from rsq_tpu_torch.kernels.poison import pages_live, poisoned, slots_live

BF16_EPS = 2.0 ** -8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def f32(t):
    return t.float().cpu().numpy()


def _bits(t):
    """t's bits as integers, so NaNs compare equal to themselves."""
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _launches(fn):
    """Kernel launches the host makes in fn(), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                            "cudaLaunchKernelExC", "cuLaunchKernelEx"))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [3, 8, 130])
@pytest.mark.parametrize("K,Nh", [(256, 160), (112, 32)])
def test_w4a4_matches_plain(dev, M, K, Nh):
    """Integer accumulation, same epilogue order: bit-equal."""
    rng = np.random.default_rng(M)
    wp = torch.from_numpy(rng.integers(0, 256, (2, K, Nh), dtype=np.uint8))
    s2 = torch.from_numpy((rng.uniform(0.5, 1.5, (2, Nh)) / (7 * np.sqrt(K))
                           ).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(torch.bfloat16)
    want = TMW.w4a4_matmul_paired_stacked(x, wp, s2, 1)
    got = TMW.w4a4_matmul_paired_stacked(x.to(dev), wp.to(dev), s2.to(dev), 1)
    np.testing.assert_array_equal(f32(got), f32(want))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8])     # prefill lm_head row, decode batch
def test_w8_matches_plain(dev, M):
    """f32 sums in another order, one bf16 rounding."""
    rng = np.random.default_rng(M)
    x = torch.from_numpy(rng.standard_normal((M, 256)).astype(np.float32)
                         ).to(torch.bfloat16)
    w8 = torch.from_numpy(rng.integers(-127, 128, (256, 512), dtype=np.int8))
    sc = torch.from_numpy(rng.uniform(0.001, 0.01, 512).astype(np.float32))
    want = TMW.w8_matmul(x, w8, sc)
    got = TMW.w8_matmul(x.to(dev), w8.to(dev), sc.to(dev))
    np.testing.assert_allclose(f32(got), f32(want), rtol=2 * BF16_EPS,
                               atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_had", [True, False])
def test_decode_prep_matches_plain(dev, kv_had):
    """Same rounding points, no FMA contraction on either side: bit-equal."""
    rng = np.random.default_rng(1)
    B, Hq, Hkv, D = 8, 32, 8, 128
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                ).to(torch.bfloat16)
               for s in ((B, Hq, D), (B, Hkv, D), (B, Hkv, D)))
    ang = torch.from_numpy(rng.uniform(0, 100, (B, D)).astype(np.float32))
    cos, sin = torch.cos(ang), torch.sin(ang)
    want = TKV.decode_prep(q, k, v, cos, sin, kv_had=kv_had)
    got = TKV.decode_prep(*(t.to(dev) for t in (q, k, v, cos, sin)),
                          kv_had=kv_had)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy() if g.dtype != torch.bfloat16
                                      else f32(g), w.numpy() if w.dtype !=
                                      torch.bfloat16 else f32(w))


def _same_bits(a, b):
    """Bit-equal, a NaN matching a NaN (payloads may differ)."""
    a, b = a.cpu(), b.cpu()
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = a.isnan(), b.isnan()
    return torch.equal(na, nb) and torch.equal(_bits(a.masked_fill(na, 0)),
                                               _bits(b.masked_fill(nb, 0)))


def _prep_case(rng, B, Hq, Hkv, D, planes):
    """(operands(device), cos, sin): q, k, v as (B, H, D) tensors, or as the
    plane-major segment views of one fused (B, 2, N) output (what the INT4
    decode branches hand decode_prep), made on `device` from the same
    values; cos/sin of random angles."""
    def bf(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(torch.bfloat16)
    if planes:
        w = (Hq * D // 2, Hkv * D // 2, Hkv * D // 2)
        y3 = bf((B, 2, sum(w)))

        def operands(device):
            y = y3.to(device)
            return [y[:, :, :w[0]], y[:, :, w[0]:w[0] + w[1]],
                    y[:, :, w[0] + w[1]:]]
    else:
        qkv = [bf((B, H, D)) for H in (Hq, Hkv, Hkv)]

        def operands(device):
            return [t.to(device) for t in qkv]
    ang = torch.from_numpy(rng.uniform(0, 100, (B, D)).astype(np.float32))
    return operands, torch.cos(ang), torch.sin(ang)


def _set_logical(t, b, cols, value):
    """Set row b's logical elements `cols` (head * D + d) of a (B, X, Y)
    operand, whichever its layout."""
    cols = torch.as_tensor(cols)
    t[b, cols // t.shape[2], cols % t.shape[2]] = value


# (Hkv, G): G = 1, 4, 8, and MQA (Hkv = 1), also with more jobs (G + 2 =
# 34) than a block's 16 warps, so that a warp takes several heads
PREP_HEADS = ((2, 1), (2, 4), (2, 8), (1, 8), (1, 32))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 64, 128, 256])
@pytest.mark.parametrize("B", [1, 8, 64])
def test_decode_prep_bit_equal_across_shapes(dev, B, D):
    """Row 1 bit-equal to the plain version (same rounding points, no FMA
    contraction on either side) for G in (1, 4, 8) and Hkv = 1 (G = 8 and
    32), kv_had on and off, on (B, H, D) operands and on plane-major
    segment views read in place."""
    rng = np.random.default_rng(1000 * B + D)
    for Hkv, G in PREP_HEADS:
        for planes in (False, True):
            operands, cos, sin = _prep_case(rng, B, Hkv * G, Hkv, D, planes)
            for kv_had in (True, False):
                want = TKV.decode_prep(*operands("cpu"), cos, sin,
                                       kv_had=kv_had)
                got = TKV.decode_prep(*operands(dev), cos.to(dev),
                                      sin.to(dev), kv_had=kv_had)
                for i, (g, w) in enumerate(zip(got, want)):
                    assert _same_bits(g, w), (Hkv, G, planes, kv_had, i)


@pytest.mark.cuda
@pytest.mark.parametrize("planes", [False, True])
def test_decode_prep_constant_and_nan_rows(dev, planes):
    """A constant v row takes the 1e-5 floor on its scale, bit-equal.  A NaN
    in one k row and one v row gives NaN scale, zero and self values in
    those rows, as in the plain version and the reference (jnp.max keeps a
    NaN; fmaxf would drop it).  Those rows' codes are undefined in the
    reference too (a NaN cast to an integer), so every output is compared
    bit for bit but those two rows' codes."""
    rng = np.random.default_rng(7)
    B, Hkv, G, D = 8, 2, 4, 128
    operands, cos, sin = _prep_case(rng, B, Hkv * G, Hkv, D, planes)
    q, k, v = operands("cpu")          # views of the values operands() copies
    _set_logical(v, 2, range(D, 2 * D), 0.75)               # v row (2, 1)
    _set_logical(k, 3, [D + 5], float("nan"))               # k row (3, 1)
    _set_logical(v, 5, [7], float("nan"))                   # v row (5, 0)
    want = TKV.decode_prep(q, k, v, cos, sin)
    got = [t.cpu() for t in TKV.decode_prep(*operands(dev), cos.to(dev),
                                            sin.to(dev))]
    floor = torch.tensor(1e-5, dtype=torch.float32) * recip_f32(15.0)
    assert got[6][2, 1, 0] == floor and got[6][2, 1, 1] == -0.75
    assert got[2][2, 1].eq(0.75).all()
    for i, row in ((4, (3, 1)), (1, (3, 1)), (6, (5, 0)), (2, (5, 0))):
        assert got[i][row].isnan().all(), (i, row)
    keep = torch.ones((B, Hkv), dtype=torch.bool)
    for i, row in ((3, (3, 1)), (5, (5, 0))):
        mask = keep.clone()
        mask[row] = False
        assert _same_bits(got[i][mask], want[i][mask]), i
    for i in (0, 1, 2, 4, 6):
        assert _same_bits(got[i], want[i]), i


@pytest.mark.cuda
def test_decode_prep_one_launch_same_bits(dev):
    """On the plane-major views at Llama-3-8B heads: one launch a call (no
    copy of q, k or v), and two calls give the same bits."""
    rng = np.random.default_rng(8)
    operands, cos, sin = _prep_case(rng, 8, 32, 8, 128, planes=True)
    args = (*operands(dev), cos.to(dev), sin.to(dev))
    a = TKV.decode_prep(*args)
    b = TKV.decode_prep(*args)
    assert all(_same_bits(x, y) for x, y in zip(a, b))
    assert _launches(lambda: TKV.decode_prep(*args)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("int8_qk", [False, True])
def test_paged_attention_matches_plain(dev, int8_qk):
    """Output within 2 bf16 roundings (f32 sums in another order, tiled
    online softmax); pools bit-equal after the in-place append."""
    rng = np.random.default_rng(2)
    L, P, B, Hkv, G, D, page = 2, 10, 3, 8, 4, 128, 256
    pools = [torch.from_numpy(rng.integers(0, 256, (L, P, Hkv, D // 2, page),
                                           dtype=np.uint8)),
             torch.from_numpy(np.stack(
                 [rng.uniform(0.01, 0.2, (L, P, Hkv, page)),
                  rng.uniform(-0.5, 0.5, (L, P, Hkv, page))], 3
             ).astype(np.float32))]
    pools = [pools[0], pools[1], pools[0].flip(0).contiguous(),
             pools[1].flip(0).contiguous()]
    ptab = torch.tensor([[0, 2, 5], [3, 1, 6], [4, 7, 8]], dtype=torch.int32)
    lengths = torch.tensor([page + 7, page, 0], dtype=torch.int32)
    q = torch.from_numpy((rng.standard_normal((B, Hkv * G, D)) * 2
                          ).astype(np.float32)).to(torch.bfloat16)
    nkq, nkp = TKV.asym_quant_pack_head(torch.from_numpy(
        rng.standard_normal((B, Hkv, D)).astype(np.float32)))
    nvq, nvp = TKV.asym_quant_pack_head(torch.from_numpy(
        rng.standard_normal((B, Hkv, D)).astype(np.float32)))
    rest = [ptab, lengths, TKV.unpack_dequant_head(nkq, nkp),
            TKV.unpack_dequant_head(nvq, nvp), nkq, nkp, nvq, nvp]
    cpu_pool = [t.clone() for t in pools]
    gpu_pool = [t.to(dev) for t in pools]
    want = TPKV.int4_paged_decode_attention_self_append(
        q, *cpu_pool, 1, *rest, int8_qk=int8_qk)
    got = TPKV.int4_paged_decode_attention_self_append(
        q.to(dev), *gpu_pool, 1, *(t.to(dev) for t in rest), int8_qk=int8_qk)
    np.testing.assert_allclose(f32(got), f32(want), rtol=4 * BF16_EPS,
                               atol=2e-3)
    for g, w in zip(gpu_pool, cpu_pool):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def _int4_cache(rng, L, B, H, D, S):
    def params():
        return torch.from_numpy(np.stack(
            [rng.uniform(0.01, 0.2, (L, B, H, S)),
             rng.uniform(-0.5, 0.5, (L, B, H, S))], 3).astype(np.float32))
    return [torch.from_numpy(rng.integers(0, 256, (L, B, H, D // 2, S),
                                          dtype=np.uint8)), params(),
            torch.from_numpy(rng.integers(0, 256, (L, B, H, D // 2, S),
                                          dtype=np.uint8)), params()]


@pytest.mark.cuda
@pytest.mark.parametrize("S", [512, 320])
@pytest.mark.parametrize("int8_qk", [False, True])
def test_contiguous_attention_matches_plain(dev, int8_qk, S):
    """As the paged kernel (same device body): output within 2 bf16
    roundings, caches bit-equal after the in-place append.  S = 320 ends
    in a partial 128-token tile."""
    rng = np.random.default_rng(3)
    L, B, Hkv, G, D = 2, 4, 8, 4, 128
    cache = _int4_cache(rng, L, B, Hkv, D, S)
    lengths = torch.tensor([300, 128, 0, S - 1], dtype=torch.int32)
    q = torch.from_numpy((rng.standard_normal((B, Hkv * G, D)) * 2
                          ).astype(np.float32)).to(torch.bfloat16)
    nkq, nkp = TKV.asym_quant_pack_head(torch.from_numpy(
        rng.standard_normal((B, Hkv, D)).astype(np.float32)))
    nvq, nvp = TKV.asym_quant_pack_head(torch.from_numpy(
        rng.standard_normal((B, Hkv, D)).astype(np.float32)))
    rest = [lengths, TKV.unpack_dequant_head(nkq, nkp),
            TKV.unpack_dequant_head(nvq, nvp), nkq, nkp, nvq, nvp]
    cpu = [t.clone() for t in cache]
    gpu = [t.to(dev) for t in cache]
    want = TKV.int4_decode_attention_self_append(q, *cpu, 1, *rest,
                                                 int8_qk=int8_qk)
    got = TKV.int4_decode_attention_self_append(
        q.to(dev), *gpu, 1, *(t.to(dev) for t in rest), int8_qk=int8_qk)
    np.testing.assert_allclose(f32(got), f32(want), rtol=4 * BF16_EPS,
                               atol=2e-3)
    for g, w in zip(gpu, cpu):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def _bf16_case(rng, B, Hkv, G, D, S, L=2):
    q = torch.from_numpy((rng.standard_normal((B, Hkv * G, D)) * 2)
                         .astype(np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((L, B, Hkv, S, D))
                             .astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    return q, k, v


def _bf16_attn_close(got, want, lengths):
    """out within 2 bf16 roundings where l > 0 (bf16(p) against another
    running maximum, one rounding of out); m, l within 1e-5 relative (f32
    sums in another order); a row of length 0: out 0/0, m -inf, l 0."""
    live = (lengths > 0).cpu().numpy()
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = f32(g), f32(w)
        if i == 0:
            np.testing.assert_allclose(g[live], w[live], rtol=4 * BF16_EPS,
                                       atol=2e-3)
            assert np.isnan(g[~live]).all()
        else:
            np.testing.assert_allclose(g[live], w[live], rtol=1e-5)
            np.testing.assert_array_equal(g[~live], w[~live])


# every length a tile and a cluster block can end on, in one batch, on a
# cache whose S (528) is a multiple of 16 but not of the 64-token tile
BF16_EDGE_S = 528
BF16_EDGE_LENGTHS = [0, 1, 63, 64, 65, 500, BF16_EDGE_S - 1, BF16_EDGE_S]
# (Hkv, G, D, S, lengths): the first case, then the edges with G in 1, 4,
# 8 (rows past G padded in the mma's n side) and D in 64, 128 and 72 (a
# half k16 step)
BF16_ATTN_CASES = [(8, 4, 128, 512, [200, 64, 0, 511])] + [
    (2, G, D, BF16_EDGE_S, BF16_EDGE_LENGTHS)
    for G in (1, 4, 8) for D in (64, 128, 72)]


@pytest.mark.cuda
@pytest.mark.parametrize("Hkv,G,D,S,lengths", BF16_ATTN_CASES)
def test_bf16_attention_matches_plain(dev, Hkv, G, D, S, lengths):
    """m and l within 1e-5 relative (f32 sums in another order); out within
    2 bf16 roundings where l > 0; the empty row gives -inf, 0 and 0/0."""
    rng = np.random.default_rng(4)
    lengths = torch.tensor(lengths, dtype=torch.int32)
    q, k, v = _bf16_case(rng, len(lengths), Hkv, G, D, S)
    want = TKV.bf16_decode_attention_stacked(q, k, v, 1, lengths)
    got = TKV.bf16_decode_attention_stacked(q.to(dev), k.to(dev), v.to(dev),
                                            1, lengths.to(dev))
    _bf16_attn_close(got, want, lengths)


@pytest.mark.cuda
def test_bf16_attention_ignores_poisoned_bytes(dev):
    """Every cache value at or past a row's length NaN: out, m and l equal
    the kernel's on the clean cache, bit for bit (nothing there is read),
    and the plain version on the clean cache within its tolerances."""
    rng = np.random.default_rng(41)
    S = BF16_EDGE_S
    lengths = torch.tensor(BF16_EDGE_LENGTHS, dtype=torch.int32).to(dev)
    q, k, v = (t.to(dev) for t in _bf16_case(rng, len(BF16_EDGE_LENGTHS), 8,
                                             4, 128, S))
    clean = TKV.bf16_decode_attention_stacked(q, k, v, 1, lengths)
    live = slots_live(lengths, S).transpose(-1, -2)        # (1, B, 1, S, 1)
    kb, vb = poisoned([k, v], live)
    assert torch.isnan(kb.float()).any()
    bad = TKV.bf16_decode_attention_stacked(q, kb, vb, 1, lengths)
    for c, b in zip(clean, bad):
        assert torch.equal(_bits(c), _bits(b))
    want = TKV.bf16_decode_attention_stacked(q.cpu(), k.cpu(), v.cpu(), 1,
                                             lengths.cpu())
    _bf16_attn_close(bad, want, lengths)


@pytest.mark.cuda
def test_bf16_attention_one_launch_same_bits(dev):
    """One launch a call (the cluster merges its blocks' states itself) and
    the same bits run to run (the merge order is fixed)."""
    rng = np.random.default_rng(42)
    lengths = torch.tensor([300, 450, 600, 700, 0, 511, 512, 1023],
                           dtype=torch.int32).to(dev)
    q, k, v = (t.to(dev) for t in _bf16_case(rng, 8, 8, 4, 128, 1024))
    a = TKV.bf16_decode_attention_stacked(q, k, v, 1, lengths)
    b = TKV.bf16_decode_attention_stacked(q, k, v, 1, lengths)
    for x, y in zip(a, b):
        assert torch.equal(_bits(x), _bits(y))
    assert _launches(lambda: TKV.bf16_decode_attention_stacked(
        q, k, v, 1, lengths)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("G", [4, 8])
def test_bf16_attention_nan_query_row(dev, G):
    """q[0, 5, 17] = NaN: that query row's out (all D values), m and l are
    NaN and nothing else is, as in the plain version (whose running
    maximum and sums keep the NaN; tests/test_torch_contiguous.py::
    test_bf16_decode_attention_nan_query_row holds it against rsq_tpu);
    the other rows within _bf16_attn_close's tolerances, the other query
    rows of the same (b, kv head) row included.  Row 0 spans several
    blocks of the cluster, row 1 one tile, row 2 is empty."""
    rng = np.random.default_rng(43 + G)
    Hkv, D, S = 2, 128, 1024
    lengths = torch.tensor([1000, 40, 0], dtype=torch.int32)
    q, k, v = _bf16_case(rng, len(lengths), Hkv, G, D, S)
    q[0, 5, 17] = float("nan")
    want = TKV.bf16_decode_attention_stacked(q, k, v, 1, lengths)
    got = TKV.bf16_decode_attention_stacked(q.to(dev), k.to(dev), v.to(dev),
                                            1, lengths.to(dev))
    B = len(lengths)
    row = np.zeros((B, Hkv, G), bool)
    row[0, 5 // G, 5 % G] = True
    empty = np.zeros((B, Hkv * G, D), bool)
    empty[(lengths == 0).numpy()] = True            # out = 0/0 there
    rows = [row.reshape(B, Hkv * G)[..., None].repeat(D, -1), row, row]
    for i, (g, w, nan) in enumerate(zip(got, want, rows)):
        np.testing.assert_array_equal(np.isnan(f32(w)),
                                      nan | empty if i == 0 else nan)
        np.testing.assert_array_equal(np.isnan(f32(g)), np.isnan(f32(w)))
    clean = [torch.where(torch.from_numpy(nan), 0.0, t.float().cpu())
             for t, nan in zip(got, rows)]
    ref = [torch.where(torch.from_numpy(nan), 0.0, t.float())
           for t, nan in zip(want, rows)]
    _bf16_attn_close(clean, ref, lengths)


@pytest.mark.cuda
def test_bf16_append_matches_plain(dev):
    rng = np.random.default_rng(5)
    L, B, H, S, D = 2, 4, 8, 64, 128
    k, v = (torch.from_numpy(rng.standard_normal((L, B, H, S, D))
                             .astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    nk, nv = (torch.from_numpy(rng.standard_normal((B, H, 1, D))
                               .astype(np.float32)).to(torch.bfloat16)
              for _ in range(2))
    pos = torch.tensor([0, 7, 16, S - 1], dtype=torch.int32)
    kg, vg = k.to(dev), v.to(dev)
    TKV.kv_append_stacked_bf16(k, v, 1, pos, nk, nv)
    TKV.kv_append_stacked_bf16(kg, vg, 1, pos.to(dev), nk.to(dev), nv.to(dev))
    assert torch.equal(kg.cpu(), k) and torch.equal(vg.cpu(), v)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_bf16_append_strided_new_values(dev, offset):
    """nk/nv read through their strides: the (B) decode step's transposed
    roped key, qk[:, :, Hq:].transpose(1, 2) of (B, 1, Hq + H, D), and a
    transposed v, each at an element offset of 0, 1 or 2 (16-, 2- and
    4-byte copies).  Positions 0, S - 1 and S (the last writes nothing);
    every other byte of both caches is unchanged; one launch a call."""
    rng = np.random.default_rng(11 + offset)
    L, B, H, Hq, S, D = 2, 4, 8, 32, 64, 128

    def bf(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(torch.bfloat16)
    k, v = bf((L, B, H, S, D)), bf((L, B, H, S, D))
    qk, vv = bf((B, 1, Hq + H, D + 2)), bf((B, 1, H, D + 2))

    def new_values(qk, vv):
        return (qk[:, :, Hq:, offset:offset + D].transpose(1, 2),
                vv[..., offset:offset + D].transpose(1, 2))
    nk, nv = new_values(qk, vv)
    pos = torch.tensor([0, S - 1, S, 17], dtype=torch.int32)
    want_k, want_v = k.clone(), v.clone()
    for b in range(B):
        if pos[b] < S:
            want_k[1, b, :, pos[b]] = nk[b, :, 0]
            want_v[1, b, :, pos[b]] = nv[b, :, 0]
    kg, vg, posg = k.to(dev), v.to(dev), pos.to(dev)
    nkg, nvg = new_values(qk.to(dev), vv.to(dev))
    assert not nkg.is_contiguous()
    TKV.kv_append_stacked_bf16(kg, vg, 1, posg, nkg, nvg)
    assert torch.equal(_bits(kg.cpu()), _bits(want_k))
    assert torch.equal(_bits(vg.cpu()), _bits(want_v))
    assert _launches(lambda: TKV.kv_append_stacked_bf16(
        kg, vg, 1, posg, nkg, nvg)) == 1


def _w16_inputs(rng, M, K, N, L=2):
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((L, K, N)) / np.sqrt(K))
                         .astype(np.float32)).to(torch.bfloat16)
    return x, w


def _w16_close(got, want):
    """f32 sums in another order, one rounding: within 2^-7 relative plus
    1e-5 of the largest output (cancelling sums)."""
    got, want = f32(got), f32(want)
    np.testing.assert_allclose(got, want, rtol=2 * BF16_EPS,
                               atol=1e-5 * np.abs(want).max())


# M: decode rows (1, 8, 16; the weight stream), one past it (17) and the
# TMA/wgmma path's tiles (64, 128, 130 ragged, 1024)
@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 3, 8, 16, 17, 64, 128, 130, 1024])
@pytest.mark.parametrize("K,N", [(512, 256), (1024, 1024)])
def test_w16_matches_plain(dev, M, K, N):
    """f32 sums in another order, one bf16 rounding: within 2^-7 relative
    plus 1e-5 of the largest output (cancelling sums)."""
    rng = np.random.default_rng(M + K)
    x, w = _w16_inputs(rng, M, K, N)
    want = TMW.w16_matmul_stacked(x, w, 1)
    got = TMW.w16_matmul_stacked(x.to(dev), w.to(dev), 1)
    _w16_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 130])
@pytest.mark.parametrize("K,N", [(14336, 4096), (4096, 1024), (136, 520)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_w16_projection_shapes(dev, M, K, N, out_dtype):
    """The down projection (K = 14336: the decode stream's K split over a
    cluster), k|v (N = 1024), and K, N that are multiples of 8 but not of
    the tiles (ragged edges), in both output types, on layer 2 of 3."""
    rng = np.random.default_rng(K + N + M)
    x, w = _w16_inputs(rng, M, K, N, L=3)
    want = TMW.w16_matmul_stacked(x, w, 2, out_dtype=out_dtype)
    got = TMW.w16_matmul_stacked(x.to(dev), w.to(dev), 2,
                                 out_dtype=out_dtype)
    assert got.dtype == out_dtype
    _w16_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 130, 1024])
def test_w16_one_launch_same_bits(dev, M):
    """One kernel launch a call (a K split, at M = 8 and 130, reduces in
    the cluster; no second pass, no scratch) and the same bits run to
    run."""
    rng = np.random.default_rng(M)
    x, w = (t.to(dev) for t in _w16_inputs(rng, M, 4096, 4096))
    before = TMW.LAUNCHES["w16_matmul_stacked"]
    a = TMW.w16_matmul_stacked(x, w, 1)
    b = TMW.w16_matmul_stacked(x, w, 1)
    assert TMW.LAUNCHES["w16_matmul_stacked"] == before + 2
    assert torch.equal(_bits(a), _bits(b))
    assert _launches(lambda: TMW.w16_matmul_stacked(x, w, 1)) == 1


def _w4_close(got, want):
    """f32 sums in another order, one bf16 rounding each: within 2^-7 of
    the largest output plus 1e-5."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max() + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("M", [3, 8, 130])
@pytest.mark.parametrize("K,Nh", [(256, 160), (4096, 3072)])
def test_w4_paired_stacked_matches_plain(dev, M, K, Nh):
    """Row 13; (4096, 3072) is the fused Llama-3-8B qkv, split K at M <= 16;
    Nh = 160 ends in a partial 128-column tile."""
    rng = np.random.default_rng(M + K)
    wp = torch.from_numpy(rng.integers(0, 256, (2, K, Nh), dtype=np.uint8))
    s2 = torch.from_numpy((rng.uniform(0.5, 1.5, (2, Nh)) / (7 * np.sqrt(K))
                           ).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(torch.bfloat16)
    want = TMW.w4_matmul_paired_stacked(x, wp, s2, 1)
    got = TMW.w4_matmul_paired_stacked(x.to(dev), wp.to(dev), s2.to(dev), 1)
    _w4_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [3, 130])
@pytest.mark.parametrize("plane_major", [False, True])
def test_w4_affine_stacked_matches_plain(dev, M, plane_major):
    """Row 14: the per-layer sh read on the card, the rank-1 +0.5 term."""
    rng = np.random.default_rng(M + 7 * plane_major)
    L, K, Nh = 3, 512, 96
    wp = torch.from_numpy(rng.integers(0, 256, (L, K, Nh), dtype=np.uint8))
    sh = torch.from_numpy(rng.uniform(0.01, 0.05, L).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(torch.bfloat16)
    want = TMW.w4_affine_matmul_stacked(x, wp, sh, 2, plane_major=plane_major)
    got = TMW.w4_affine_matmul_stacked(x.to(dev), wp.to(dev), sh.to(dev), 2,
                                       plane_major=plane_major)
    _w4_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8])     # prefill lm_head row, decode batch
def test_w4_matmul_matches_plain(dev, M):
    """Row 8, the int4 lm_head, at N = 1000 (Nh = 500: not a multiple of
    the kernel's tiles, no padding)."""
    rng = np.random.default_rng(M)
    K, N = 256, 1000
    wp = torch.from_numpy(rng.integers(0, 256, (K, N // 2), dtype=np.uint8))
    sc = torch.from_numpy(rng.uniform(0.001, 0.01, N).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(torch.bfloat16)
    want = TMW.w4_matmul(x, wp, sc)
    got = TMW.w4_matmul(x.to(dev), wp.to(dev), sc.to(dev))
    _w4_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [3, 8, 130])
def test_w4a4_paired_matches_plain(dev, M):
    """Row 11, the unstacked W4A4 matmul on the L = 1 view: bit-equal, with
    the absmax scale and with an explicit token_scale; w4a4_matmul's
    un-paired output too."""
    rng = np.random.default_rng(M + 1)
    K, Nh = 256, 164
    wp = torch.from_numpy(rng.integers(0, 256, (K, Nh), dtype=np.uint8))
    s2 = torch.from_numpy((rng.uniform(0.5, 1.5, (2, Nh)) / (7 * np.sqrt(K))
                           ).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(torch.bfloat16)
    ts = torch.from_numpy(rng.uniform(0.2, 0.6, (M, 1)).astype(np.float32))
    for tok in (None, ts):
        want = TMW.w4a4_matmul_paired(x, wp, s2, tok)
        got = TMW.w4a4_matmul_paired(x.to(dev), wp.to(dev), s2.to(dev),
                                     None if tok is None else tok.to(dev))
        np.testing.assert_array_equal(f32(got), f32(want))
    sc = torch.from_numpy(rng.uniform(0.01, 0.1, 2 * Nh).astype(np.float32))
    np.testing.assert_array_equal(
        f32(TMW.w4a4_matmul(x.to(dev), wp.to(dev), sc.to(dev))),
        f32(TMW.w4a4_matmul(x, wp, sc)))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [3, 130])
@pytest.mark.parametrize("Nh", [500, 1024])
def test_w4_paired_and_affine_match_plain(dev, M, Nh):
    """Rows 9 and 10 on the L = 1 view; Nh = 500 is ragged (byte loads and
    a masked last tile, no padding)."""
    rng = np.random.default_rng(M + Nh)
    K = 512
    wp = torch.from_numpy(rng.integers(0, 256, (K, Nh), dtype=np.uint8))
    s2 = torch.from_numpy((rng.uniform(0.5, 1.5, (2, Nh)) / (7 * np.sqrt(K))
                           ).astype(np.float32))
    sh = torch.tensor(0.0131)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(torch.bfloat16)
    _w4_close(TMW.w4_matmul_paired(x.to(dev), wp.to(dev), s2.to(dev)),
              TMW.w4_matmul_paired(x, wp, s2))
    for pm in (False, True):
        _w4_close(TMW.w4_affine_matmul(x.to(dev), wp.to(dev), sh.to(dev),
                                       plane_major=pm),
                  TMW.w4_affine_matmul(x, wp, sh, plane_major=pm))


@pytest.mark.cuda
@pytest.mark.parametrize("int8_qk", [False, True])
def test_decode_attention_stacked_matches_plain(dev, int8_qk):
    """Row 2, read-only, with its softmax state: out within 2 bf16
    roundings, m and l within 1e-5 relative + 1e-5 (a logit is the
    difference of two f32 products, raw * ks - qsum * kz, whose sums run in
    another order: near 0 its error is absolute); the row of length 0
    gives NaN, -inf and 0; the cache is not written."""
    rng = np.random.default_rng(6)
    L, B, Hkv, G, D, S = 2, 4, 8, 4, 128, 320
    cache = _int4_cache(rng, L, B, Hkv, D, S)
    lengths = torch.tensor([300, 128, 0, 1], dtype=torch.int32)
    q = torch.from_numpy((rng.standard_normal((B, Hkv * G, D)) * 2
                          ).astype(np.float32)).to(torch.bfloat16)
    want = TKV.int4_decode_attention_stacked(q, *cache, 1, lengths,
                                             int8_qk=int8_qk)
    gpu = [t.to(dev) for t in cache]
    got = TKV.int4_decode_attention_stacked(q.to(dev), *gpu, 1,
                                            lengths.to(dev), int8_qk=int8_qk)
    live = (lengths > 0).numpy()
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = f32(g), f32(w)
        if i == 0:
            np.testing.assert_allclose(g[live], w[live], rtol=4 * BF16_EPS,
                                       atol=2e-3)
            assert np.isnan(g[~live]).all()
        else:
            np.testing.assert_allclose(g[live], w[live], rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(g[~live], w[~live])
    for g, c in zip(gpu, cache):
        assert torch.equal(g.cpu(), c)


def _paged_pool(rng, L, P, H, D, page):
    return [torch.from_numpy(rng.integers(0, 256, (L, P, H, D // 2, page),
                                          dtype=np.uint8)),
            torch.from_numpy(np.stack(
                [rng.uniform(0.01, 0.2, (L, P, H, page)),
                 rng.uniform(-0.5, 0.5, (L, P, H, page))], 3
            ).astype(np.float32))]


@pytest.mark.cuda
@pytest.mark.parametrize("page", [6, 8, 16, 64, 512])
@pytest.mark.parametrize("int8_qk", [False, True])
def test_paged_read_only_matches_plain(dev, page, int8_qk):
    """Row 17 at any page size: a 64-token tile straddles up to 64 / page
    pages of a table in no pool order (page 6 is copied token by token, 8
    in 4-token runs, the rest in 16-token runs); rows end mid-page, on a
    page boundary and after one token.  Out within 2 bf16 roundings; pools
    not written."""
    rng = np.random.default_rng(page + int8_qk)
    L, B, Hkv, G, D = 2, 3, 8, 4, 128
    NP = -(-700 // page)
    P = B * NP + 1
    kq, kp = _paged_pool(rng, L, P, Hkv, D, page)
    vq, vp = _paged_pool(rng, L, P, Hkv, D, page)
    pools = [kq, kp, vq, vp]
    ptab = torch.from_numpy(rng.permutation(P)[:B * NP].reshape(B, NP)
                            .astype(np.int32))
    lengths = torch.tensor([NP * page - page // 2 - 1, (NP // 2) * page, 1],
                           dtype=torch.int32)
    q = torch.from_numpy((rng.standard_normal((B, Hkv * G, D)) * 2
                          ).astype(np.float32)).to(torch.bfloat16)
    want = TPKV.int4_paged_decode_attention_stacked(q, *pools, 1, ptab,
                                                    lengths, int8_qk=int8_qk)
    gpu = [t.to(dev) for t in pools]
    got = TPKV.int4_paged_decode_attention_stacked(
        q.to(dev), *gpu, 1, ptab.to(dev), lengths.to(dev), int8_qk=int8_qk)
    np.testing.assert_allclose(f32(got), f32(want), rtol=4 * BF16_EPS,
                               atol=2e-3)
    for g, c in zip(gpu, pools):
        assert torch.equal(g.cpu(), c)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [36, 64, 128, 256])
@pytest.mark.parametrize("page", [8, 16, 24, 512])
def test_paged_append_matches_plain(dev, page, D):
    """Row 21: pools bit-equal to the plain version's, with two live rows
    appending into one shared page at different lanes, a row on its
    second page, an idle row on the null page 0, and a position past the
    table (the clamped slot: its last page), over 5 x 3 (b, h) rows;
    D/2 = 18 is no multiple of 4.  One launch a call."""
    rng = np.random.default_rng(page + D)
    L, P, H, B = 2, 8, 3, 5
    kq, kp = _paged_pool(rng, L, P, H, D, page)
    vq, vp = _paged_pool(rng, L, P, H, D, page)
    ptab = torch.tensor([[3, 5], [5, 6], [1, 2], [0, 0], [4, 7]],
                        dtype=torch.int32)
    pos = torch.tensor([page + 2, 7 % page, page - 1, 0, 2 * page + 3],
                       dtype=torch.int32)
    nkq, nkp = TKV.asym_quant_pack_head(torch.from_numpy(
        rng.standard_normal((B, H, D)).astype(np.float32)))
    nvq, nvp = TKV.asym_quant_pack_head(torch.from_numpy(
        rng.standard_normal((B, H, D)).astype(np.float32)))
    new = (nkq, nkp, nvq, nvp)
    cpu = [t.clone() for t in (kq, kp, vq, vp)]
    gpu = [t.to(dev) for t in (kq, kp, vq, vp)]
    args = (1, ptab.to(dev), pos.to(dev), *(t.to(dev) for t in new))
    TPKV.paged_append_pool(*cpu, 1, ptab, pos, *new)
    TPKV.paged_append_pool(*gpu, *args)
    for g, c in zip(gpu, cpu):
        assert torch.equal(g.cpu(), c)
    assert torch.equal(cpu[0][1, 5, :, :, 2], nkq[0])
    assert torch.equal(cpu[0][1, 5, :, :, 7 % page], nkq[1])
    assert torch.equal(cpu[0][1, 7, :, :, 3], nkq[4])
    assert _launches(lambda: TPKV.paged_append_pool(*gpu, *args)) == 1


# ---------------------------------------------------------------------------
# Rows 3, 7, 18, and every INT4 attention kernel on a poisoned cache
# ---------------------------------------------------------------------------

def _new_token(rng, B, H, D):
    """(k_self, v_self) and (nkq, nkp, nvq, nvp) of one new token."""
    selfs, new = [], []
    for _ in range(2):
        c, p = TKV.asym_quant_pack_head(torch.from_numpy(
            rng.standard_normal((B, H, D)).astype(np.float32)))
        selfs.append(TKV.unpack_dequant_head(c, p))
        new += [c, p]
    return selfs, new


@pytest.mark.cuda
@pytest.mark.parametrize("int8_qk", [False, True])
def test_decode_attention_self_matches_plain(dev, int8_qk):
    """Row 3: lengths 0, 1, mid-tile and S - 1; out within 2 bf16
    roundings (the length-0 row: v_self), the same on a poisoned cache;
    the cache is not written."""
    rng = np.random.default_rng(7 + int8_qk)
    L, B, Hkv, G, D, S = 2, 4, 8, 4, 128, 320
    cache = _int4_cache(rng, L, B, Hkv, D, S)
    lengths = torch.tensor([0, 1, 200, S - 1], dtype=torch.int32)
    q = torch.from_numpy((rng.standard_normal((B, Hkv * G, D)) * 2)
                         .astype(np.float32)).to(torch.bfloat16)
    selfs, _ = _new_token(rng, B, Hkv, D)
    want = TKV.int4_decode_attention_stacked_self(q, *cache, 1, lengths,
                                                  *selfs, int8_qk=int8_qk)
    gpu = [t.to(dev) for t in cache]
    args = (lengths.to(dev), *(t.to(dev) for t in selfs))
    got = TKV.int4_decode_attention_stacked_self(q.to(dev), *gpu, 1, *args,
                                                 int8_qk=int8_qk)
    bad = TKV.int4_decode_attention_stacked_self(
        q.to(dev), *poisoned(gpu, slots_live(lengths.to(dev), S)), 1,
        *args, int8_qk=int8_qk)
    for g in (got, bad):
        np.testing.assert_allclose(f32(g), f32(want), rtol=4 * BF16_EPS,
                                   atol=2e-3)
    for g, c in zip(gpu, cache):
        assert torch.equal(g.cpu(), c)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [36, 64, 128, 256])
def test_kv_append_matches_plain(dev, D):
    """Row 7: positions 0, 127, 128, S - 1 and 200 over 5 x 3 (b, h) rows;
    whole caches bit-equal; D/2 = 18 is no multiple of 4.  One launch a
    call."""
    rng = np.random.default_rng(8 + D)
    L, B, H, S = 2, 5, 3, 384
    cache = _int4_cache(rng, L, B, H, D, S)
    pos = torch.tensor([0, 127, 128, S - 1, 200], dtype=torch.int32)
    _, new = _new_token(rng, B, H, D)
    new = [t[..., None] for t in new]
    gpu = [t.to(dev) for t in cache]
    args = (1, pos.to(dev), *(t.to(dev) for t in new))
    TKV.kv_append_stacked(*cache, 1, pos, *new)
    TKV.kv_append_stacked(*gpu, *args)
    for g, c in zip(gpu, cache):
        assert torch.equal(g.cpu(), c)
    assert torch.equal(cache[0][1, 3, :, :, S - 1], new[0][3, :, :, 0])
    assert _launches(lambda: TKV.kv_append_stacked(*gpu, *args)) == 1


@pytest.mark.cuda
def test_kv_append_skips_positions_outside_the_cache(dev):
    """Row 7 on the card with positions S and -1 (which the CPU refuses):
    those rows write nothing, the others their one column; every other
    byte of all four caches, layer 0 and the last row's neighbours
    included, is unchanged."""
    rng = np.random.default_rng(9)
    L, B, H, D, S = 2, 5, 8, 128, 384
    cache = _int4_cache(rng, L, B, H, D, S)
    pos = torch.tensor([0, S, S - 1, 5, -1], dtype=torch.int32)
    _, new = _new_token(rng, B, H, D)
    want = [t.clone() for t in cache]
    for b in (0, 2, 3):
        for arr, val in zip(want, new):
            arr[1, b, :, :, int(pos[b])] = val[b]
    gpu = [t.to(dev) for t in cache]
    TKV.kv_append_stacked(*gpu, 1, pos.to(dev),
                          *(t[..., None].to(dev) for t in new))
    for g, w in zip(gpu, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("page", [8, 16, 64, 512])
@pytest.mark.parametrize("int8_qk", [False, True])
def test_paged_read_self_matches_plain(dev, page, int8_qk):
    """Row 18 at any page size, a table in no pool order: lengths 0, 1,
    mid-page and the last position; out within 2 bf16 roundings, the same
    on a poisoned pool; the pool is not written."""
    rng = np.random.default_rng(3 * page + int8_qk)
    L, B, Hkv, G, D = 2, 4, 8, 4, 128
    NP = -(-700 // page)
    P = B * NP + 1
    kq, kp = _paged_pool(rng, L, P, Hkv, D, page)
    vq, vp = _paged_pool(rng, L, P, Hkv, D, page)
    pools = [kq, kp, vq, vp]
    ptab = torch.from_numpy(rng.permutation(P)[:B * NP].reshape(B, NP)
                            .astype(np.int32))
    lengths = torch.tensor([0, 1, (NP // 2) * page + page // 2 + 1,
                            NP * page - 1], dtype=torch.int32)
    q = torch.from_numpy((rng.standard_normal((B, Hkv * G, D)) * 2)
                         .astype(np.float32)).to(torch.bfloat16)
    selfs, _ = _new_token(rng, B, Hkv, D)
    want = TPKV.int4_paged_decode_attention_stacked_self(
        q, *pools, 1, ptab, lengths, *selfs, int8_qk=int8_qk)
    gpu = [t.to(dev) for t in pools]
    args = (ptab.to(dev), lengths.to(dev), *(t.to(dev) for t in selfs))
    got = TPKV.int4_paged_decode_attention_stacked_self(
        q.to(dev), *gpu, 1, *args, int8_qk=int8_qk)
    bad = TPKV.int4_paged_decode_attention_stacked_self(
        q.to(dev), *poisoned(gpu, pages_live(args[0], args[1], P, page)),
        1, *args, int8_qk=int8_qk)
    for g in (got, bad):
        np.testing.assert_allclose(f32(g), f32(want), rtol=4 * BF16_EPS,
                                   atol=2e-3)
    for g, c in zip(gpu, pools):
        assert torch.equal(g.cpu(), c)


@pytest.mark.cuda
@pytest.mark.parametrize("row", [2, 4, 17, 19])
def test_attention_ignores_poisoned_bytes(dev, row):
    """Rows 2, 4 (contiguous) and 17, 19 (paged, page 16 and 128): on a copy
    of the cache whose unreachable bytes are poisoned (every page no table
    names, every column at or past a row's length but the one an append
    writes), the output equals the plain version on the clean cache, and
    the appended column is written as on the clean cache."""
    rng = np.random.default_rng(40 + row)
    L, B, Hkv, G, D = 2, 4, 8, 4, 128
    q = torch.from_numpy((rng.standard_normal((B, Hkv * G, D)) * 2)
                         .astype(np.float32)).to(torch.bfloat16)
    selfs, new = _new_token(rng, B, Hkv, D)
    appends = row in (4, 19)
    if row in (2, 4):
        S = 320
        cache = _int4_cache(rng, L, B, Hkv, D, S)
        lengths = torch.tensor([300, 1, 0, S - 1], dtype=torch.int32)
        table = ()
        live = slots_live(lengths.to(dev), S, keep=int(appends))
    else:
        page = 16 if row == 17 else 128
        NP = -(-320 // page)
        P = B * NP + 1
        cache = [*_paged_pool(rng, L, P, Hkv, D, page),
                 *_paged_pool(rng, L, P, Hkv, D, page)]
        table = (torch.from_numpy(rng.permutation(P)[:B * NP]
                                  .reshape(B, NP).astype(np.int32)),)
        lengths = torch.tensor([NP * page - page // 2, 1, 0, 2 * page + 3],
                               dtype=torch.int32)
        live = pages_live(table[0].to(dev), lengths.to(dev), P, page,
                           keep=int(appends))
    fn = {2: TKV.int4_decode_attention_stacked, 4:
          TKV.int4_decode_attention_self_append,
          17: TPKV.int4_paged_decode_attention_stacked,
          19: TPKV.int4_paged_decode_attention_self_append}[row]
    rest = (*table, lengths) + ((*selfs, *new) if appends else ())
    clean = [t.clone() for t in cache]
    want = fn(q, *clean, 1, *rest)
    want = want[0] if row == 2 else want
    bad_cache = poisoned([t.to(dev) for t in cache], live)
    got = fn(q.to(dev), *bad_cache, 1, *(t.to(dev) for t in rest))
    got = got[0] if row == 2 else got
    live_rows = (lengths > 0).numpy() if row in (2, 17) else slice(None)
    np.testing.assert_allclose(f32(got)[live_rows], f32(want)[live_rows],
                               rtol=4 * BF16_EPS, atol=2e-3)
    if appends:                      # the written column, as on the clean run
        for g, c in zip(bad_cache, poisoned([t.to(dev) for t in clean],
                                             live)):
            g, c = g.cpu(), c.cpu()
            if g.dtype == torch.float32:
                g, c = g.view(torch.int32), c.view(torch.int32)
            assert torch.equal(g, c)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_self_append_kernel_equals_fold_then_append(dev, paged):
    """On the card: row 4 == row 3 then row 7, row 19 == row 18 then row 21
    (the same device fold, so out bit-equal; caches bit-equal)."""
    rng = np.random.default_rng(50 + paged)
    L, B, Hkv, G, D = 2, 4, 8, 4, 128
    q = torch.from_numpy((rng.standard_normal((B, Hkv * G, D)) * 2)
                         .astype(np.float32)).to(torch.bfloat16).to(dev)
    selfs, new = _new_token(rng, B, Hkv, D)
    selfs, new = [t.to(dev) for t in selfs], [t.to(dev) for t in new]
    if paged:
        page = 128
        cache = [*_paged_pool(rng, L, 9, Hkv, D, page),
                 *_paged_pool(rng, L, 9, Hkv, D, page)]
        ptab = torch.tensor([[1, 2], [3, 4], [5, 6], [7, 8]],
                            dtype=torch.int32, device=dev)
        lengths = torch.tensor([200, 0, 127, 128], dtype=torch.int32,
                               device=dev)
    else:
        cache = _int4_cache(rng, L, B, Hkv, D, 320)
        lengths = torch.tensor([200, 0, 127, 319], dtype=torch.int32,
                               device=dev)
    fused = [t.to(dev) for t in cache]
    pair = [t.to(dev) for t in cache]
    if paged:
        out_f = TPKV.int4_paged_decode_attention_self_append(
            q, *fused, 1, ptab, lengths, *selfs, *new)
        out_s = TPKV.int4_paged_decode_attention_stacked_self(
            q, *pair, 1, ptab, lengths, *selfs)
        TPKV.paged_append_pool(*pair, 1, ptab, lengths, *new)
    else:
        out_f = TKV.int4_decode_attention_self_append(q, *fused, 1, lengths,
                                                      *selfs, *new)
        out_s = TKV.int4_decode_attention_stacked_self(q, *pair, 1, lengths,
                                                       *selfs)
        TKV.kv_append_stacked(*pair, 1, lengths, *(t[..., None] for t in new))
    assert torch.equal(out_f, out_s)
    for a, b in zip(fused, pair):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("int8_qk", [True, False])
@pytest.mark.parametrize("row", [2, 3, 4, 17, 18, 19])
def test_nan_query_head(dev, row, int8_qk):
    """q[0, 5, 17] = NaN (batch row 0, kv head 1, query row 1): that query
    head's output is NaN and no other, as in the plain version, whose
    int8_qk scale (amax) and running max (maximum) keep the NaN; the
    other heads within 2 bf16 roundings, the other query rows of the same
    (b, kv head) row included.  Row 2 also m and l: NaN at (0, 1, 1) alone,
    the rest within 1e-5 relative + 1e-5.  Appending rows write their
    column as the plain version does."""
    rng = np.random.default_rng(70 + row + 100 * int8_qk)
    L, B, Hkv, G, D = 2, 3, 4, 4, 128
    q = torch.from_numpy((rng.standard_normal((B, Hkv * G, D)) * 2)
                         .astype(np.float32)).to(torch.bfloat16)
    q[0, 5, 17] = float("nan")
    selfs, new = _new_token(rng, B, Hkv, D)
    if row in (2, 3, 4):
        cache = _int4_cache(rng, L, B, Hkv, D, 320)
        lengths = torch.tensor([300, 1, 129], dtype=torch.int32)
        table = ()
    else:
        page = 128 if row == 19 else 16
        NP = -(-320 // page)
        P = B * NP + 1
        cache = [*_paged_pool(rng, L, P, Hkv, D, page),
                 *_paged_pool(rng, L, P, Hkv, D, page)]
        table = (torch.from_numpy(rng.permutation(P)[:B * NP]
                                  .reshape(B, NP).astype(np.int32)),)
        lengths = torch.tensor([300, 1, 2 * page + 3], dtype=torch.int32)
    fn = {2: TKV.int4_decode_attention_stacked,
          3: TKV.int4_decode_attention_stacked_self,
          4: TKV.int4_decode_attention_self_append,
          17: TPKV.int4_paged_decode_attention_stacked,
          18: TPKV.int4_paged_decode_attention_stacked_self,
          19: TPKV.int4_paged_decode_attention_self_append}[row]
    rest = (*table, lengths) + (() if row in (2, 17) else tuple(selfs)) \
        + (tuple(new) if row in (4, 19) else ())
    cpu = [t.clone() for t in cache]
    gpu = [t.to(dev) for t in cache]
    want = fn(q, *cpu, 1, *rest, int8_qk=int8_qk)
    got = fn(q.to(dev), *gpu, 1, *(t.to(dev) for t in rest), int8_qk=int8_qk)
    want, got = ([w] if row != 2 else list(w) for w in (want, got))
    head = np.zeros((B, Hkv * G, D), bool)
    head[0, 5] = True
    g, w = f32(got[0]), f32(want[0])
    np.testing.assert_array_equal(np.isnan(w), head)
    np.testing.assert_array_equal(np.isnan(g), head)
    np.testing.assert_allclose(g[~head], w[~head], rtol=4 * BF16_EPS,
                               atol=2e-3)
    if row == 2:
        state = np.zeros((B, Hkv, G), bool)
        state[0, 1, 1] = True
        for a, b in zip(got[1:], want[1:]):
            a, b = f32(a), f32(b)
            np.testing.assert_array_equal(np.isnan(b), state)
            np.testing.assert_array_equal(np.isnan(a), state)
            np.testing.assert_allclose(a[~state], b[~state], rtol=1e-5,
                                       atol=1e-5)
    for a, c in zip(gpu, cpu):
        assert torch.equal(a.cpu(), c)


# ---------------------------------------------------------------------------
# The tensor-core matmuls (rows 16, 12, 11): ragged shapes, M tiles, K split
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 9, 40])
@pytest.mark.parametrize("N", [1000, 1168])
def test_w8_ragged_matches_plain(dev, M, N):
    """Row 16 off its main shape: N = 1000 takes 4-byte weight copies,
    N = 1168 16-byte ones with a ragged last 128-column tile; M = 9 and 40
    keep 2 and 4 row tiles per block."""
    rng = np.random.default_rng(M + N)
    K = 512
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(torch.bfloat16)
    w8 = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8))
    sc = torch.from_numpy(rng.uniform(0.001, 0.01, N).astype(np.float32))
    want = f32(TMW.w8_matmul(x, w8, sc))
    got = f32(TMW.w8_matmul(x.to(dev), w8.to(dev), sc.to(dev)))
    np.testing.assert_allclose(got, want, rtol=2 * BF16_EPS,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 9, 40, 1024])
@pytest.mark.parametrize("Nh", [164, 500, 1168])
def test_w4a4_tiles_match_plain(dev, M, Nh):
    """Rows 12/11 bit-equal at every row-tile size (1, 2, 4, 8 tiles of 8
    rows), with 4-byte (Nh = 164, 500) and 16-byte (1168) weight copies and
    a ragged last tile; K = 1024 is split at small M."""
    rng = np.random.default_rng(M + Nh)
    K = 1024
    wp = torch.from_numpy(rng.integers(0, 256, (2, K, Nh), dtype=np.uint8))
    s2 = torch.from_numpy((rng.uniform(0.5, 1.5, (2, Nh)) / (7 * np.sqrt(K))
                           ).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(torch.bfloat16)
    want = TMW.w4a4_matmul_paired_stacked(x, wp, s2, 1)
    got = TMW.w4a4_matmul_paired_stacked(x.to(dev), wp.to(dev), s2.to(dev), 1)
    np.testing.assert_array_equal(f32(got), f32(want))


@pytest.mark.cuda
def test_w4a4_split_back_to_back(dev):
    """Two K-split calls queued back to back on one stream with different
    inputs, then a call on another shape: each call reduces its split in
    its own clusters and leaves no state behind, so each is bit-equal to
    its plain version."""
    rng = np.random.default_rng(77)
    cases = []
    for M, K, Nh in ((8, 4096, 256), (8, 4096, 256), (5, 2048, 512)):
        wp = torch.from_numpy(rng.integers(0, 256, (1, K, Nh), dtype=np.uint8))
        s2 = torch.from_numpy((rng.uniform(0.5, 1.5, (2, Nh))
                               / (7 * np.sqrt(K))).astype(np.float32))
        x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                             ).to(torch.bfloat16)
        cases.append((x, wp, s2))
    on_dev = [[t.to(dev) for t in c] for c in cases]
    torch.cuda.synchronize()
    got = [TMW.w4a4_matmul_paired_stacked(x, wp, s2, 0) for x, wp, s2 in on_dev]
    for g, (x, wp, s2) in zip(got, cases):
        np.testing.assert_array_equal(
            f32(g), f32(TMW.w4a4_matmul_paired_stacked(x, wp, s2, 0)))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8, 16, 17])
def test_w4a4_token_scale_in_kernel(dev, M):
    """At M <= 16 the kernel finds the per-token scale itself (absmax over
    the cluster's K slices, times the folded clip constant); beyond, the
    wrapper passes it.  Bit-equal either way, at clip 0.9, with a row of
    zeros (scale 1) and with a caller-given token_scale.  A NaN in one row
    (M > 1) makes that row's output NaN, and only it, as in the plain
    version, whether the kernel or the wrapper finds the scale."""
    rng = np.random.default_rng(90 + M)
    K, Nh = 4096, 2048
    wp = torch.from_numpy(rng.integers(0, 256, (K, Nh), dtype=np.uint8))
    s2 = torch.from_numpy((rng.uniform(0.5, 1.5, (2, Nh)) / (7 * np.sqrt(K))
                           ).astype(np.float32))
    xn = rng.standard_normal((M, K)).astype(np.float32)
    xn[0] = 0.0
    x = torch.from_numpy(xn).to(torch.bfloat16)
    ts = torch.from_numpy(rng.uniform(0.2, 0.6, (M, 1)).astype(np.float32))
    for tok in (None, ts):
        want = TMW.w4a4_matmul_paired(x, wp, s2, tok, clip_ratio=0.9)
        got = TMW.w4a4_matmul_paired(x.to(dev), wp.to(dev), s2.to(dev),
                                     None if tok is None else tok.to(dev),
                                     clip_ratio=0.9)
        np.testing.assert_array_equal(f32(got), f32(want))
    if M > 1:
        xn[M - 1, 3000] = np.nan
        x = torch.from_numpy(xn).to(torch.bfloat16)
        want = f32(TMW.w4a4_matmul_paired(x, wp, s2, clip_ratio=0.9))
        got = f32(TMW.w4a4_matmul_paired(x.to(dev), wp.to(dev), s2.to(dev),
                                         clip_ratio=0.9))
        assert np.isnan(want[M - 1]).all() and np.isfinite(want[:M - 1]).all()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        f32(TMW.w4a4_matmul_paired_stacked(x.to(dev), wp[None].to(dev),
                                           s2.to(dev), 0, clip_ratio=0.9)),
        f32(TMW.w4a4_matmul_paired_stacked(x, wp[None], s2, 0,
                                           clip_ratio=0.9)))


# ---------------------------------------------------------------------------
# The weight-only kernel (rows 8-10, 13, 14): the TMA path, the shape rule,
# the cluster K split, the in-kernel row sums
# ---------------------------------------------------------------------------

def _w4_inputs(rng, M, K, Nh, L=2):
    wp = torch.from_numpy(rng.integers(0, 256, (L, K, Nh), dtype=np.uint8))
    s2 = torch.from_numpy((rng.uniform(0.5, 1.5, (2, Nh)) / (7 * np.sqrt(K))
                           ).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(torch.bfloat16)
    return x, wp, s2


@pytest.mark.cuda
@pytest.mark.parametrize("M", [17, 64, 130, 1024, 4096])
@pytest.mark.parametrize("K,Nh", [(4096, 3072), (1024, 1040), (512, 500)])
def test_w4_prefill_paths_match_plain(dev, M, K, Nh):
    """Rows 13 and 14 beyond M = 16: TMA and wgmma where the maps can
    address the weights (Nh = 3072, and Nh = 1040, whose last 128-column
    tile is ragged), the mma.sync stream where they cannot (Nh = 500, not a
    multiple of 16), by the shape rule; K = 1024 at M = 17 is split over a
    cluster."""
    rng = np.random.default_rng(M + K + Nh)
    x, wp, s2 = (t.to(dev) for t in _w4_inputs(rng, M, K, Nh))
    assert TMW.w4_uses_tma(M, Nh, wp.data_ptr()) == (Nh % 16 == 0)
    # the plain versions on the card: the same f32 arithmetic, faster
    _w4_close(TMW.w4_matmul_paired_stacked(x, wp, s2, 1),
              TMW.w4_matmul_paired_stacked_plain(x, wp, s2, 1))
    sh = torch.tensor([0.011, 0.017], device=dev)
    want = TMW.w4_affine_matmul_stacked_plain(x, wp, sh, 1)
    for pm in (False, True):
        _w4_close(TMW.w4_affine_matmul_stacked(x, wp, sh, 1, plane_major=pm),
                  want.reshape(M, 2 * Nh) if pm else TMW.unpair_outputs(want))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 130])
def test_w4_unaligned_layer_takes_the_stream(dev, M):
    """Weights whose stacked base is not 16-byte aligned (a view one byte
    into its storage) cannot be addressed by a tensor map: the shape rule
    sends them to the stream's byte loads, which hold against the plain
    version as the aligned path does."""
    rng = np.random.default_rng(5 + M)
    K, Nh = 512, 256
    x, wp, s2 = _w4_inputs(rng, M, K, Nh)
    raw = torch.empty(wp.numel() + 1, dtype=torch.uint8, device=dev)
    wd = raw[1:].view(wp.shape)
    wd.copy_(wp.to(dev))
    assert wd.data_ptr() % 16 != 0 and not TMW.w4_uses_tma(M, Nh,
                                                           wd.data_ptr())
    _w4_close(TMW.w4_matmul_paired_stacked(x.to(dev), wd, s2.to(dev), 1),
              TMW.w4_matmul_paired_stacked(x, wp, s2, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,Nh", [(8, 4096, 3072), (16, 14336, 2048),
                                    (1024, 4096, 512), (130, 4096, 1024)])
def test_w4_one_launch_same_bits(dev, M, K, Nh):
    """Each call is one launch (the K split reduced inside a cluster, no
    w4_reduce, no scratch), and two calls give the same bits (the slices
    summed in rank order), for rows 13 and 14 (the affine decode path takes
    no row-sum launch either)."""
    rng = np.random.default_rng(M + Nh)
    x, wp, s2 = _w4_inputs(rng, M, K, Nh)
    x, wp, s2 = x.to(dev), wp.to(dev), s2.to(dev)
    sh = torch.tensor([0.011, 0.017], device=dev)
    calls = (lambda: TMW.w4_matmul_paired_stacked(x, wp, s2, 1),
             lambda: TMW.w4_affine_matmul_stacked(x, wp, sh, 1,
                                                  plane_major=True))
    for call in calls:
        assert torch.equal(_bits(call()), _bits(call()))
    assert _launches(calls[0]) == 1
    assert _launches(calls[1]) == (1 if M <= 16 else 2)   # + row_sums


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8, 16])
def test_w4_affine_row_sums_in_kernel(dev, M):
    """At M <= 16 the affine kernel takes the row sums of x itself (each
    cluster block its K slice, summed in rank order): within the matmul
    tolerance of the plain version's torch.sum, stacked and unstacked,
    paired and adjacent; a NaN in one row makes that row NaN, and only it;
    the int4 lm_head (row 8) is one launch too."""
    rng = np.random.default_rng(300 + M)
    K, Nh = 4096, 1024
    x, wp, _ = _w4_inputs(rng, M, K, Nh, L=1)
    sh = torch.tensor([0.013])
    _w4_close(TMW.w4_affine_matmul_stacked(x.to(dev), wp.to(dev),
                                           sh.to(dev), 0),
              TMW.w4_affine_matmul_stacked(x, wp, sh, 0))
    _w4_close(TMW.w4_affine_matmul(x.to(dev), wp[0].to(dev), sh[0].to(dev),
                                   plane_major=True),
              TMW.w4_affine_matmul(x, wp[0], sh[0], plane_major=True))
    if M > 1:
        xn = x.float().numpy()
        xn[M - 1, 1234] = np.nan
        xb = torch.from_numpy(xn).to(torch.bfloat16)
        want = TMW.w4_affine_matmul_stacked(xb, wp, sh, 0)
        got = TMW.w4_affine_matmul_stacked(xb.to(dev), wp.to(dev),
                                           sh.to(dev), 0)
        assert np.isnan(f32(want[M - 1])).all()
        assert np.isfinite(f32(want[:M - 1])).all()
        assert np.isnan(f32(got[M - 1])).all()
        _w4_close(got[:M - 1], want[:M - 1])
    sc = torch.from_numpy(rng.uniform(0.001, 0.01, 2 * Nh).astype(np.float32))
    xd, wd, scd = x.to(dev), wp[0].to(dev), sc.to(dev)
    _w4_close(TMW.w4_matmul(xd, wd, scd), TMW.w4_matmul(x, wp[0], sc))
    assert _launches(lambda: TMW.w4_matmul(xd, wd, scd)) == 1


# ---------------------------------------------------------------------------
# The INT4 tile loop (rows 2-4, 17-19): the cluster split over the sequence
# ---------------------------------------------------------------------------

# lengths at the split's edges for rows of 1024 tokens (4 blocks of up to 4
# 64-token tiles): empty, one token, a tile's and a block's boundary +- 1,
# and the last position
SPLIT_LENGTHS = [0, 1, 63, 64, 65, 255, 256, 257, 1023]


def _int4_row_case(rng, row, S=1024):
    """Inputs of row `row` of the table over rows of S tokens: the cache (a
    pool at page 16 for rows 17 and 18, 128 for row 19, in no pool order),
    the table, lengths SPLIT_LENGTHS, q and the new token."""
    B, Hkv, G, D, L = len(SPLIT_LENGTHS), 8, 4, 128, 2
    lengths = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32)
    if row in (2, 3, 4):
        cache, table = _int4_cache(rng, L, B, Hkv, D, S), ()
        live = lambda keep: slots_live(lengths, S, keep)   # noqa: E731
    else:
        page = {17: 16, 18: 16, 19: 128}[row]
        NP = S // page
        P = B * NP + 1
        cache = [*_paged_pool(rng, L, P, Hkv, D, page),
                 *_paged_pool(rng, L, P, Hkv, D, page)]
        table = (torch.from_numpy(rng.permutation(P)[:B * NP]
                                  .reshape(B, NP).astype(np.int32)),)
        live = lambda keep: pages_live(table[0], lengths, P, page,  # noqa
                                       keep)
    q = torch.from_numpy((rng.standard_normal((B, Hkv * G, D)) * 2)
                         .astype(np.float32)).to(torch.bfloat16)
    selfs, new = _new_token(rng, B, Hkv, D)
    return cache, table, lengths, live, q, selfs, new


_INT4_FNS = {2: TKV.int4_decode_attention_stacked,
             3: TKV.int4_decode_attention_stacked_self,
             4: TKV.int4_decode_attention_self_append,
             17: TPKV.int4_paged_decode_attention_stacked,
             18: TPKV.int4_paged_decode_attention_stacked_self,
             19: TPKV.int4_paged_decode_attention_self_append}


def _int4_rest(row, table, lengths, selfs, new):
    extra = {2: (), 17: (), 3: selfs, 18: selfs}.get(row, (*selfs, *new))
    return (*table, lengths, *extra)


@pytest.mark.cuda
@pytest.mark.parametrize("row", [2, 3, 4, 17, 18, 19])
@pytest.mark.parametrize("int8_qk", [False, True])
def test_int4_split_lengths_match_plain(dev, row, int8_qk):
    """Every INT4 form at lengths on the split's edges (SPLIT_LENGTHS, rows
    of 1024 tokens: 4 blocks a row), page 16 with 64-token tiles straddling
    4 pages, int8 and bf16 QK: out within 4 bf16 roundings + 2e-3 of the
    plain version (row 2 also m and l within 1e-5 rel + 1e-5; read-only
    rows of length 0 NaN, -inf, 0); on a copy whose unreachable bytes are
    poisoned, out bit-equal and the appended column as on the clean run."""
    rng = np.random.default_rng(600 + row + 50 * int8_qk)
    cache, table, lengths, live, q, selfs, new = _int4_row_case(rng, row)
    fn = _INT4_FNS[row]
    rest = _int4_rest(row, table, lengths, selfs, new)
    cpu = [t.clone() for t in cache]
    want = fn(q, *cpu, 1, *rest, int8_qk=int8_qk)
    gpu = [t.to(dev) for t in cache]
    drest = [t.to(dev) for t in rest]
    got = fn(q.to(dev), *gpu, 1, *drest, int8_qk=int8_qk)
    appends = row in (4, 19)
    mask = live(int(appends))
    bad_cache = poisoned([t.to(dev) for t in cache], mask.to(dev))
    bad = fn(q.to(dev), *bad_cache, 1, *drest, int8_qk=int8_qk)
    outs = (lambda r: r) if row == 2 else (lambda r: (r,))
    got, want, bad = outs(got), outs(want), outs(bad)
    for a, b in zip(got, bad):
        assert torch.equal(_bits(a), _bits(b))
    rows = ((lengths > 0).numpy() if row in (2, 17) else slice(None))
    np.testing.assert_allclose(f32(got[0])[rows], f32(want[0])[rows],
                               rtol=4 * BF16_EPS, atol=2e-3)
    if row in (2, 17):
        assert np.isnan(f32(got[0])[~rows]).all()
    if row == 2:
        for g_, w_ in zip(got[1:], want[1:]):
            g_, w_ = f32(g_), f32(w_)
            np.testing.assert_allclose(g_[rows], w_[rows], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_array_equal(g_[~rows], w_[~rows])
    for g_, c in zip(gpu, cpu):
        assert torch.equal(g_.cpu(), c)
    if appends:                      # the written column, as on the clean run
        for g_, c in zip(bad_cache, poisoned(gpu, mask.to(dev))):
            if g_.is_floating_point():
                g_, c = _bits(g_), _bits(c)
            assert torch.equal(g_, c)


@pytest.mark.cuda
@pytest.mark.parametrize("row", [2, 3, 4, 17, 18, 19])
def test_int4_attention_one_launch_same_bits(dev, row):
    """One launch a call (the cluster merges in shared memory: no second
    pass, no workspace), and two calls give the same bits (the states merge
    in rank order)."""
    rng = np.random.default_rng(700 + row)
    cache, table, lengths, _, q, selfs, new = _int4_row_case(rng, row)
    fn = _INT4_FNS[row]
    gpu = [t.to(dev) for t in cache]
    drest = [t.to(dev) for t in _int4_rest(row, table, lengths, selfs, new)]
    qd = q.to(dev)
    first = fn(qd, *gpu, 1, *drest, int8_qk=True)
    again = fn(qd, *gpu, 1, *drest, int8_qk=True)
    for a, b in zip(*((first, again) if row == 2 else ((first,), (again,)))):
        assert torch.equal(_bits(a), _bits(b))
    assert _launches(lambda: fn(qd, *gpu, 1, *drest, int8_qk=True)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("int8_qk", [False, True])
def test_paged_self_append_on_shared_pages(dev, int8_qk):
    """Row 19 == row 18 then row 21 when rows share their prefix pages (a
    two-page prefix read by three rows, each appending into a page of its
    own, one of them at a page's first lane): out and pools bit-equal, and
    within tolerance of the plain version."""
    rng = np.random.default_rng(800 + int8_qk)
    L, Hkv, G, D, page, P = 2, 8, 4, 128, 128, 9
    cache = [*_paged_pool(rng, L, P, Hkv, D, page),
             *_paged_pool(rng, L, P, Hkv, D, page)]
    ptab = torch.tensor([[1, 2, 3, 0], [1, 2, 4, 5], [1, 2, 6, 0]],
                        dtype=torch.int32)
    lengths = torch.tensor([300, 384, 257], dtype=torch.int32)
    B = 3
    q = torch.from_numpy((rng.standard_normal((B, Hkv * G, D)) * 2)
                         .astype(np.float32)).to(torch.bfloat16)
    selfs, new = _new_token(rng, B, Hkv, D)
    cpu = [t.clone() for t in cache]
    want = TPKV.int4_paged_decode_attention_self_append(
        q, *cpu, 1, ptab, lengths, *selfs, *new, int8_qk=int8_qk)
    args = [t.to(dev) for t in (ptab, lengths)]
    dsel, dnew = [t.to(dev) for t in selfs], [t.to(dev) for t in new]
    fused = [t.to(dev) for t in cache]
    pair = [t.to(dev) for t in cache]
    out_f = TPKV.int4_paged_decode_attention_self_append(
        q.to(dev), *fused, 1, *args, *dsel, *dnew, int8_qk=int8_qk)
    out_s = TPKV.int4_paged_decode_attention_stacked_self(
        q.to(dev), *pair, 1, *args, *dsel, int8_qk=int8_qk)
    TPKV.paged_append_pool(*pair, 1, *args, *dnew)
    assert torch.equal(out_f, out_s)
    for a, b, c in zip(fused, pair, cpu):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)
    np.testing.assert_allclose(f32(out_f), f32(want), rtol=4 * BF16_EPS,
                               atol=2e-3)


# ---------------------------------------------------------------------------
# The RSQ pipeline on the card against the CPU (no kernel of its own: the
# products are torch.matmul and torch.linalg, as the reference's are XLA's)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("actorder", [False, True])
def test_gptq_on_card_matches_cpu(dev, actorder):
    """gptq_quantize on the same W and H (W4 sym, MSE clip, 256 x 1024, a
    correlated H): scales within 1e-5 relative; weights within rtol 1e-4,
    atol 1e-5 at >= 99.9% of entries, every other entry exactly one step
    off (a rounding tie the card's sums decide the other way)."""
    import chip_smoke as CS
    from rsq_tpu_torch.core.quant import WeightQuantConfig
    from rsq_tpu_torch.quantize import gptq as TG
    rng = np.random.default_rng(90 + actorder)
    W = torch.from_numpy((rng.standard_normal((256, 1024)) * 0.02)
                         .astype(np.float32))
    X = torch.from_numpy(rng.standard_normal((4096, 1024)).astype(np.float32))
    X = X @ torch.from_numpy(rng.standard_normal((1024, 1024))
                             .astype(np.float32) / 32)
    H = (X.T @ X) * (2.0 / 4096)
    wq = WeightQuantConfig(bits=4, sym=True, mse=True)
    cfg = TG.GPTQConfig(actorder=actorder, add_until_fail=True)
    want, winfo = TG.gptq_quantize(W, H, wq, cfg, device="cpu")
    got, ginfo = TG.gptq_quantize(W, H, wq, cfg, device=dev)
    assert got.device.type == "cuda"
    torch.testing.assert_close(ginfo["scale"].cpu(), winfo["scale"],
                               rtol=1e-5, atol=0)
    assert CS.one_step_off(got.cpu(), want, winfo["scale"]) <= 1e-3 * W.numel()


@pytest.mark.cuda
def test_quantize_model_on_card_matches_cpu(dev):
    """The tiny model (2 layers, hidden 64) under the run_rsq.sh config,
    every GPTQ call held against the CPU's on the same state
    (chip_smoke.quantize_vs_cpu: W, Hessian, weights, scales)."""
    import chip_smoke as CS
    from rsq_tpu_torch.models.config import ModelConfig
    from rsq_tpu_torch.models.llama import init_params
    from rsq_tpu_torch.quantize.data import get_loaders
    cfg = ModelConfig.tiny(num_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(1), scale=0.05)
    calib = get_loaders("synthetic", nsamples=8, seqlen=64, seed=1,
                        vocab_size=cfg.vocab_size)
    n = CS.quantize_vs_cpu(dev, cfg, params, calib, CS.run_rsq_config(8))
    assert n["calls"] == 14 and n["share_one_step_off"] <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["opt", "gemma2", "falcon",
                                  "falcon_two_norms"])
def test_family_quantize_model_on_card_matches_cpu(dev, name):
    """The OPT, Gemma-2 and Falcon tiny models under the run_rsq.sh config
    (no rotation on Gemma-2), every GPTQ call held against the CPU's, GPTQ
    on the CPU's W and H (chip_smoke.quantize_vs_cpu on_cpu_state)."""
    import dataclasses

    import chip_smoke as CS
    from rsq_tpu_torch.models import family
    from rsq_tpu_torch.models.config import ModelConfig
    from rsq_tpu_torch.quantize.data import get_loaders
    cfg = {"opt": ModelConfig.tiny_opt(), "gemma2": ModelConfig.tiny_gemma2(),
           "falcon": ModelConfig.tiny_falcon(),
           "falcon_two_norms": ModelConfig.tiny_falcon(
               falcon_two_norms=True, num_key_value_heads=2)}[name]
    params = family.init_params(cfg, torch.Generator().manual_seed(1),
                                scale=0.05)
    calib = get_loaders("synthetic", nsamples=8, seqlen=64, seed=1,
                        vocab_size=cfg.vocab_size)
    rsq = dataclasses.replace(CS.run_rsq_config(8),
                              rotate=cfg.family != "gemma2")
    n = CS.quantize_vs_cpu(dev, cfg, params, calib, rsq, on_cpu_state=True)
    assert n["calls"] == 2 * len(family.linear_names(cfg))
    assert n["share_one_step_off"] <= 1e-3


@pytest.mark.cuda
def test_prepare_hinv_at_llama3_intermediate(dev):
    """n = 14336 (Llama-3-8B's down projection), a rank-4096 H as 4096
    calibration tokens give it: the damped chain returns a finite upper
    factor U on the card with (H + damp I) U^T U e_j within 1e-2 of e_j."""
    from rsq_tpu_torch.quantize.gptq import prepare_hinv
    n = 14336
    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn((4096, n), generator=g, device=dev)
    H = X.T @ X
    del X
    U, dead = prepare_hinv(H, 0.01, add_until_fail=True)
    assert U.shape == (n, n) and U.device.type == "cuda"
    assert bool(torch.isfinite(U).all()) and not bool(dead.any())
    assert bool((torch.tril(U, -1) == 0).all()) and bool((U.diagonal() > 0).all())
    cols = torch.tensor([0, 777, 9000, n - 1], device=dev)
    e = torch.zeros((n, len(cols)), device=dev)
    e[cols, torch.arange(len(cols), device=dev)] = 1.0
    Hd = H + 0.01 * H.diagonal().mean() * torch.eye(n, device=dev)
    r = Hd @ (U.T @ (U @ e)) - e
    assert float(r.abs().max()) < 1e-2


# ---------------------------------------------------------------------------
# LDLQ + E8P on the card against the CPU (plain tensor code on
# torch.matmul / torch.linalg, as the reference's is XLA's)
# ---------------------------------------------------------------------------

def _ldlq_problem(rows, cols, seed):
    """W at 0.05 and H = (2/n) A^T A of a correlated A (f32), as
    tests/test_torch_ldlq.py builds them."""
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((rows, cols)) * 0.05).astype(np.float32)
    A = (rng.standard_normal((4 * cols, cols))
         @ (np.eye(cols) + 0.3 * rng.standard_normal((cols, cols)) / np.sqrt(
             cols / 64))).astype(np.float32)
    return (torch.from_numpy(W),
            torch.from_numpy(((2.0 / (4 * cols)) * A.T @ A).astype(np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_e8p_on_card_bit_equal(dev, seed):
    """The two-coset search on 4096 rows: values and codes bit-equal."""
    from rsq_tpu_torch.quantize import ldlq as TL
    X = torch.from_numpy((np.random.default_rng(seed).standard_normal(
        (4096, 8)) * (1 + seed)).astype(np.float32))
    want_v, want_c = TL.quantize_e8p(X)
    got_v, got_c = TL.quantize_e8p(X.to(dev))
    assert got_v.device.type == "cuda"
    assert torch.equal(got_c.cpu(), want_c)
    assert torch.equal(_bits(got_v.cpu()), _bits(want_v))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,seed,iters", [(64, 256, 0, 10),
                                                  (256, 1024, 1, 10),
                                                  (128, 512, 2, 0),
                                                  (128, 512, 3, 2)])
def test_ldlq_on_card_matches_cpu(dev, rows, cols, seed, iters):
    """ldlq_quantize on the same W and H on both devices: codes equal, Q
    within 1e-6 relative (the scale's norm sums in another order), and Q
    the codes' grid values times the scale, bit for bit, on the card."""
    from rsq_tpu_torch.quantize import ldlq as TL
    W, H = _ldlq_problem(rows, cols, seed)
    want, winfo = TL.ldlq_quantize(W, H, quip_tune_iters=iters, device="cpu")
    got, ginfo = TL.ldlq_quantize(W, H, quip_tune_iters=iters, device=dev)
    assert got.device.type == "cuda" and ginfo["codes"].device.type == "cuda"
    assert float(ginfo["scale"]) == pytest.approx(float(winfo["scale"]),
                                                  rel=1e-6)
    assert torch.equal(ginfo["codes"].cpu(), winfo["codes"])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0)
    assert torch.equal(TL.e8p_dequantize(ginfo["codes"], ginfo["scale"]), got)


@pytest.mark.cuda
def test_e8p_pipeline_on_card_matches_cpu(dev):
    """The tiny model under the rsq_e8p config, every ldlq_quantize call
    held against the CPU's on the same W and H (chip_smoke.e8p_vs_cpu)."""
    import chip_smoke as CS
    from rsq_tpu_torch.models.config import ModelConfig
    from rsq_tpu_torch.models.llama import init_params
    from rsq_tpu_torch.quantize.data import get_loaders
    cfg = ModelConfig.tiny(num_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(1), scale=0.05)
    calib = get_loaders("synthetic", nsamples=8, seqlen=64, seed=1,
                        vocab_size=cfg.vocab_size)
    n = CS.e8p_vs_cpu(dev, cfg, params, calib, CS.run_e8p_config(8))
    assert n["calls"] == 14 and n["rows_off"] <= CS.E8P_ROWS_OFF * n["rows"]
