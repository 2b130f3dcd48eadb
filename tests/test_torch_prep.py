"""decode_prep (row 1) and the bf16 append (row 6) reading their operands
in place, against rsq_tpu at tiny size on the CPU (the reference in Pallas
interpret mode; explicit f32/bf16 dtypes, since conftest turns on x64).

- The warp butterfly of csrc/decode_prep.cu (in-lane stages, then one
  shuffle a stage) mirrored in numpy gives the bits of the reference's qh.
- The port's decode_prep on the plane-major segment views of a fused
  (M, 2, N) qkv output equals the reference on the same values, and the
  kernel's addressing of those views reaches every element.
- The bf16 append takes the decode step's transposed roped key as it is.
- Neither INT4 decode branch copies q, k or v before decode_prep."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsq_tpu.kernels import kv_cache as JKV
from rsq_tpu_torch.kernels import kv_cache as TKV
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.serving import model as TS
from rsq_tpu_torch.serving import paged as TPG
from rsq_tpu_torch.serving.params import random_serving_params


def bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def bits(t):
    """A tensor's bits, so that floats compare bit for bit."""
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def jax_bf16(t):
    """A bf16 torch tensor as a JAX bf16 array (the same values)."""
    return jnp.asarray(t.float().numpy(), jnp.float32).astype(jnp.bfloat16)


def torch_of(a):
    """A JAX output as a torch tensor of its own dtype."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return bf16(a.astype(np.float32))
    return torch.from_numpy(a.copy())


# ---------------------------------------------------------------------------
# The warp butterfly's order
# ---------------------------------------------------------------------------

def warp_butterfly(x):
    """numpy f32 mirror of decode_prep.cu's butterfly over the last axis
    (D): a lane holds max(1, D/32) consecutive elements; the stages whose
    partner is in the same lane run first, in registers, then one
    __shfl_xor_sync a stage, lane distance 1, 2, ...: the lower partner
    keeps a + b, the upper takes a - b."""
    D = x.shape[-1]
    epl = max(1, D // 32)
    lanes = D // epl
    y = np.array(x, np.float32).reshape(*x.shape[:-1], lanes, epl)
    s = 1
    while s < epl:
        for j in range(epl):
            if j & s == 0:
                a, e = y[..., j].copy(), y[..., j + s].copy()
                y[..., j], y[..., j + s] = a + e, a - e
        s *= 2
    lane = np.arange(lanes)
    m = 1
    while m < lanes:
        o = y[..., lane ^ m, :]
        upper = ((lane & m) != 0)[:, None]
        y = np.where(upper, o - y, y + o)
        m *= 2
    return y.reshape(x.shape)


@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
def test_warp_butterfly_gives_reference_bits(D):
    """qh bit for bit at every head size the kernel takes an EPL for.
    cos = 1, sin = 0 makes RoPE exact in both (XLA on the CPU contracts
    x*cos + rot*sin into an FMA, which changes nothing then), so qh is
    bf16(butterfly(q) * f32(1/sqrt(D))) and its bits are the butterfly's
    add order's."""
    rng = np.random.default_rng(D)
    B, Hq, Hkv = 2, 4, 1
    q, k, v = (rng.standard_normal((B, H, D)).astype(np.float32)
               for H in (Hq, Hkv, Hkv))
    q = bf16(q).float().numpy()                   # bf16 values, as fed in
    cos, sin = np.ones((B, D), np.float32), np.zeros((B, D), np.float32)
    jqh = JKV.decode_prep(*(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                            for a in (q, k, v)),
                          jnp.asarray(cos, jnp.float32),
                          jnp.asarray(sin, jnp.float32), kv_had=True)[0]
    mirror = bf16(warp_butterfly(q) * np.float32(1.0 / np.sqrt(D)))
    assert torch.equal(bits(mirror), bits(torch_of(jqh)))
    tqh = TKV.decode_prep(*(bf16(a) for a in (q, k, v)),
                          torch.from_numpy(cos), torch.from_numpy(sin))[0]
    assert torch.equal(bits(tqh), bits(mirror))


# ---------------------------------------------------------------------------
# Plane-major operands
# ---------------------------------------------------------------------------

def _fused_qkv(rng, B, Hq, Hkv, D):
    """A fused qkv output (B, 2, N) and its three plane-major segment views,
    as _segments(planes=True) cuts them."""
    widths = (Hq * D // 2, Hkv * D // 2, Hkv * D // 2)
    y3 = bf16(rng.standard_normal((B, 2, sum(widths))))
    offs = (0, widths[0], widths[0] + widths[1])
    return y3, [y3[:, :, o:o + w] for o, w in zip(offs, widths)]


def _quadrant_tables(rng, B, D):
    """cos/sin of whole quarter turns, so that RoPE is exact in the
    reference and in the port alike (see the test below)."""
    turns = rng.integers(0, 4, (B, D))
    return (np.choose(turns, [1, 0, -1, 0]).astype(np.float32),
            np.choose(turns, [0, 1, 0, -1]).astype(np.float32))


@pytest.mark.parametrize("kv_had", [True, False])
@pytest.mark.parametrize("Hq,Hkv,D", [(4, 2, 16), (4, 1, 16), (8, 2, 32),
                                      (2, 1, 64)])
def test_plane_major_views_match_reference(Hq, Hkv, D, kv_had):
    """The port's decode_prep on the plane-major views of a fused (M, 2, N)
    output against rsq_tpu's decode_prep on the same values as (B, H, D),
    including MQA (Hkv = 1: one head spans both planes).  qh, the codes
    and the (scale, zero) params are bit-equal.  XLA on the CPU contracts
    the reference's x*cos + rot*sin and u*scale - zero into FMAs (one
    rounding fewer; test_torch_kernels.py), which the port does not: the
    tables are whole quarter turns, which make RoPE exact either way, and
    k_self / v_self are held bit for bit to the reference's own codes and
    params dequantized with two roundings, u*scale then - zero."""
    rng = np.random.default_rng(Hq * 100 + Hkv * 10 + D)
    B = 3
    _, segs = _fused_qkv(rng, B, Hq, Hkv, D)
    cos, sin = _quadrant_tables(rng, B, D)
    got = TKV.decode_prep(*segs, torch.from_numpy(cos), torch.from_numpy(sin),
                          kv_had=kv_had)
    heads = [t.reshape(B, -1, D) for t in segs]
    jout = JKV.decode_prep(*(jax_bf16(t) for t in heads),
                           jnp.asarray(cos, jnp.float32),
                           jnp.asarray(sin, jnp.float32), kv_had=kv_had)
    qh, _, _, nkq, nkp, nvq, nvp = (torch_of(a) for a in jout)
    # the reference broadcasts codes/params over 128 lanes; lane 0 suffices
    nkq, nkp, nvq, nvp = (a[..., 0] for a in (nkq, nkp, nvq, nvp))
    for i, want in ((0, qh), (3, nkq), (4, nkp), (5, nvq), (6, nvp)):
        assert torch.equal(bits(got[i]), bits(want)), i
    for i, (codes, params) in ((1, (nkq, nkp)), (2, (nvq, nvp))):
        u = torch.cat([codes & 15, codes >> 4], -1).float().numpy()
        sc, zp = params[..., 0:1].numpy(), params[..., 1:2].numpy()
        want = (u * sc).astype(np.float32) - zp
        assert torch.equal(bits(got[i]), bits(torch.from_numpy(want))), i
    # and the same bits as on copies of the views
    for a, b in zip(got, TKV.decode_prep(*(t.contiguous() for t in heads),
                                         torch.from_numpy(cos),
                                         torch.from_numpy(sin),
                                         kv_had=kv_had)):
        assert torch.equal(bits(a), bits(b))


def _addressed(t, D, per_lane):
    """The values the kernel reads for t (B, ., .): element c of row b at
    base + b*sb + (c // w)*sw + c % w over t's storage."""
    rows, sb, w, sw = TKV._prep_rows(t, D, per_lane)
    store = torch.empty(0, dtype=rows.dtype).set_(rows.untyped_storage())
    B, n = rows.shape[0], rows[0].numel()
    b = torch.arange(B)[:, None]
    c = torch.arange(n)[None, :]
    return store[rows.storage_offset() + b * sb + (c // w) * sw + c % w], rows


@pytest.mark.parametrize("form", ["planes", "heads", "flat", "strided"])
def test_prep_rows_reach_every_element(form):
    """The kernel's addressing (struct Rows in csrc/decode_prep.cu) of each
    operand form reaches the logical row-major heads: plane-major views,
    (B, H, D) and (B, H*D) tensors in place, and a copy only for a strided
    last axis."""
    rng = np.random.default_rng(3)
    B, Hq, Hkv, D = 3, 4, 2, 64
    y3, segs = _fused_qkv(rng, B, Hq, Hkv, D)
    t = {"planes": segs[1], "heads": segs[0].reshape(B, Hq, D),
         "flat": segs[0].reshape(B, Hq * D),
         "strided": bf16(rng.standard_normal((B, Hq, 2 * D)))[:, :, ::2]}[form]
    got, rows = _addressed(t, D, per_lane=D // 32)
    assert torch.equal(bits(got), bits(t.reshape(B, -1)))
    same_storage = (rows.untyped_storage().data_ptr()
                    == t.untyped_storage().data_ptr())
    assert same_storage == (form != "strided")
    if form == "planes":
        assert same_storage and rows.untyped_storage().data_ptr() \
            == y3.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# The bf16 append on the decode step's strided key
# ---------------------------------------------------------------------------

def test_bf16_append_strided_key_matches_reference():
    """nk = qk[:, :, Hq:].transpose(1, 2) of the roped (B, 1, Hq + H, D)
    (not contiguous) and nv the (B, H, 1, D) view of v, as the (B) decode
    step passes them, against rsq_tpu's kv_append_stacked_bf16 on their
    values; positions 0, 7, 16 and S - 1."""
    rng = np.random.default_rng(9)
    L, B, H, Hq, S, D = 2, 4, 2, 4, 32, 16
    k, v = (bf16(rng.standard_normal((L, B, H, S, D))) for _ in range(2))
    qk = bf16(rng.standard_normal((B, 1, Hq + H, D)))
    nk = qk[:, :, Hq:].transpose(1, 2)
    nv = bf16(rng.standard_normal((B, H * D))).reshape(B, 1, H, D) \
        .transpose(1, 2)
    assert not nk.is_contiguous()
    pos = np.array([0, 7, 16, S - 1], np.int32)
    jk, jv = JKV.kv_append_stacked_bf16(
        jax_bf16(k), jax_bf16(v), 1, jnp.asarray(pos, jnp.int32),
        jax_bf16(nk.contiguous()), jax_bf16(nv.contiguous()))
    TKV.kv_append_stacked_bf16(k, v, 1, torch.from_numpy(pos), nk, nv)
    assert torch.equal(bits(k), bits(torch_of(jk)))
    assert torch.equal(bits(v), bits(torch_of(jv)))


@pytest.mark.parametrize("offset,chunk", [(0, 8), (1, 1), (2, 2)])
def test_bf16_append_copy_width(offset, chunk):
    """The append kernel's copy width: 16 bytes (8 values) where D, the base
    pointers and the strides allow, else 4 bytes, else 2."""
    B, H, D = 2, 2, 128
    base = torch.zeros((B, H, 1, D + 8), dtype=torch.bfloat16)
    cache = torch.zeros((1, B, H, 16, D), dtype=torch.bfloat16)
    nk = base[..., offset:offset + D]
    strides = (nk.stride(0), nk.stride(1)) * 2
    assert TKV._bf16_chunk(D, (cache, cache, nk, nk), strides) == chunk


# ---------------------------------------------------------------------------
# No copy before decode_prep on the INT4 decode branches
# ---------------------------------------------------------------------------

def _spy(monkeypatch, module, name, record):
    fn = getattr(module, name)

    def spy(*args, **kw):
        out = fn(*args, **kw)
        record.append((args, out))
        return out

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("engine", ["paged", "contiguous"])
def test_decode_branches_pass_views_of_the_fused_output(monkeypatch, engine):
    """A tiny decode step on the CPU: q, k and v reach decode_prep as views
    of the fused qkv kernel's (M, 2, N) output (the same storage), not as
    copies, on the paged branch and on the contiguous one."""
    cfg = ModelConfig.tiny()
    params = random_serving_params(cfg, seed=0, device="cpu")
    sc = TS.ServingConfig(model=cfg, a4=True, kv_int4=True, kv_hadamard=True,
                          online_had=True, max_seq=256)
    fused, prep = [], []
    _spy(monkeypatch, TS, "w4a4_matmul_paired_stacked", fused)
    _spy(monkeypatch, TPG if engine == "paged" else TS.KVK, "decode_prep",
         prep)
    B = 2
    tokens = torch.tensor([3, 5])
    if engine == "paged":
        from rsq_tpu_torch.kernels.paged_kv import init_pool
        pool = init_pool(cfg.num_layers, 4, cfg.num_key_value_heads,
                         cfg.head_dim_, 128, device="cpu")
        TPG.decode_step_paged_fast(
            params, pool, torch.tensor([[0], [1]], dtype=torch.int32),
            torch.tensor([5, 9], dtype=torch.int32), tokens, sc)
    else:
        cache = TS.init_cache(sc, B, device="cpu")
        cache["length"] = torch.tensor([5, 9], dtype=torch.int32)
        TS.decode_step_stacked(params, cache, tokens, sc)
    assert len(prep) == cfg.num_layers
    outputs = {out.untyped_storage().data_ptr() for _, out in fused}
    for args, _ in prep:
        for t in args[:3]:
            assert t.shape == (B, 2, t.shape[2])
            assert t.untyped_storage().data_ptr() in outputs
