"""Paged INT4 KV-cache attention (the port of the parts of
rsq_tpu.kernels.paged_kv on the paged serving path).

The cache is a global page pool shared by all sequences, layout
(L, P, Hkv, D/2, page) uint8 codes and (L, P, Hkv, 2, page) f32 params; a
sequence owns a row of page ids (the page table).

Kernels (csrc/paged_attention.cu, on the device bodies it shares with the
contiguous kernels in csrc/int4_attention.cuh), each with its plain
version here:
- int4_paged_decode_attention_self_append: attention with the new token
  folded in, then its in-place append; it replaces both the reference's
  grid and flat Pallas kernels.  Pages hold a multiple of 128 tokens, as
  in the reference.
- int4_paged_decode_attention_stacked (and its L = 1 view
  int4_paged_decode_attention): read-only attention, any page size.
- int4_paged_decode_attention_stacked_self: the same, with the new token
  folded in; the first kernel equals it followed by paged_append_pool.
- paged_append_pool: the in-place append of one token per row.  With pages
  under 128 tokens the serving step runs these two instead of the first,
  as the reference does.
"""

from __future__ import annotations

import ctypes

import torch

from rsq_tpu_torch import resolve_device
from rsq_tpu_torch.core.hadamard import hadamard_transform_last
from rsq_tpu_torch.core.numerics import recip_f32
from rsq_tpu_torch.kernels import (LAUNCHES, cuda_build, on_cuda, ptr,
                                   require, stream)
from rsq_tpu_torch.kernels.kv_cache import (asym_quant_pack_head,
                                            attend_tile,
                                            check_int4_attention,
                                            empty_state, finalize_read,
                                            int4_split,
                                            kernel_operands, q_groups,
                                            self_fold_finalize,
                                            to_lane_major)


def init_pool(num_layers: int, num_pages: int, num_kv_heads: int,
              head_dim: int, page_size: int, device="cuda"):
    """Global page pool shared by every sequence (zero codes, unit params)."""
    dev = resolve_device(device)
    L, P, H, D, pg = num_layers, num_pages, num_kv_heads, head_dim, page_size
    return {
        "kq": torch.zeros((L, P, H, D // 2, pg), dtype=torch.uint8, device=dev),
        "kp": torch.ones((L, P, H, 2, pg), dtype=torch.float32, device=dev),
        "vq": torch.zeros((L, P, H, D // 2, pg), dtype=torch.uint8, device=dev),
        "vp": torch.ones((L, P, H, 2, pg), dtype=torch.float32, device=dev),
    }


def quantize_prompt(k_bhsd, hadamard: bool):
    """(B, H, S, D) post-rope K or V -> lane-major quantized pair; set
    hadamard=True for K (the cache holds per-head rotated keys)."""
    if hadamard:
        k_bhsd = hadamard_transform_last(k_bhsd)
    return to_lane_major(*asym_quant_pack_head(k_bhsd))


def _gather(pool_layer, page_table):
    """(P, H, x, page) pages of each row -> (B, H, x, NP*page)."""
    g = pool_layer[page_table]                    # (B, NP, H, x, page)
    g = g.movedim(1, -2)                          # (B, H, x, NP, page)
    return g.reshape(*g.shape[:-2], -1)


def _check_table(page_table, lengths, B):
    require(page_table.dim() == 2 and page_table.shape[0] == B
            and lengths.shape == (B,), "page_table (B, NP), lengths (B,)")



def paged_self_append_plain(q, kq_all, kp_all, vq_all, vp_all, layer,
                            page_table, lengths, k_self, v_self, nkq, nkp,
                            nvq, nvp, sm_scale=None, int8_qk=False):
    """Plain PyTorch version: the self-folding read over each row's pages,
    then the in-place append (the reference aliases the pools)."""
    out = paged_read_self_plain(q, kq_all, kp_all, vq_all, vp_all, layer,
                                page_table, lengths, k_self, v_self,
                                sm_scale, int8_qk)
    paged_append_plain(kq_all, kp_all, vq_all, vp_all, layer, page_table,
                       lengths, nkq, nkp, nvq, nvp)
    return out


def int4_paged_decode_attention_self_append(q, kq_all, kp_all, vq_all,
                                            vp_all, layer: int, page_table,
                                            lengths, k_self, v_self, nkq,
                                            nkp, nvq, nvp, sm_scale=None,
                                            int8_qk: bool = False):
    """Self-folding paged decode attention + in-place pool append.

    q: (B, Hq, D) bf16, already per-head Hadamard-rotated like the keys;
    pools: (L, P, Hkv, D/2, page) u8 and (L, P, Hkv, 2, page) f32, updated
    in place; page_table (B, NP) int32; lengths (B,) int32 cached tokens
    (the new token lands at position lengths[b]); k_self/v_self (B, Hkv, D)
    f32 dequantized new token; nkq/nvq (B, Hkv, D/2) u8 and nkp/nvp
    (B, Hkv, 2) f32 its cache contents.  Returns out (B, Hq, D) bf16.
    Rows of an idle engine slot (length 0) must point at a page nobody
    reads: they append into its column 0."""
    B, Hq, D, (L, P, Hkv, D2, page) = check_int4_attention(
        q, kq_all, kp_all, vq_all, vp_all, layer)
    require(page % 128 == 0,
            f"page {page}: the self-append kernel takes pages that are a "
            "multiple of 128 tokens, as the reference's does; smaller pages go "
            "through paged_append_pool and int4_paged_decode_attention_stacked")
    _check_table(page_table, lengths, B)
    require(nkq.shape == (B, Hkv, D2) and nkp.shape == (B, Hkv, 2)
            and k_self.shape == (B, Hkv, D), "new-token shapes")
    tensors = (q, kq_all, kp_all, vq_all, vp_all, page_table, lengths,
               k_self, v_self, nkq, nkp, nvq, nvp)
    if not on_cuda(tensors):
        return paged_self_append_plain(q, kq_all, kp_all, vq_all, vp_all,
                                       layer, page_table, lengths, k_self,
                                       v_self, nkq, nkp, nvq, nvp,
                                       sm_scale=sm_scale, int8_qk=int8_qk)
    q, G, sm_scale = kernel_operands(q, (kq_all, kp_all, vq_all, vp_all),
                                     sm_scale)
    ptab = page_table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    k_self, v_self = k_self.float().contiguous(), v_self.float().contiguous()
    nkq, nvq = nkq.contiguous(), nvq.contiguous()
    nkp, nvp = nkp.float().contiguous(), nvp.float().contiguous()
    out = torch.empty_like(q)
    fn = cuda_build.function(
        "paged_attention", "paged_attention_self_append_launch",
        [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 2
        + [ctypes.c_void_p])
    rc = fn(ptr(q), ptr(kq_all), ptr(kp_all), ptr(vq_all), ptr(vp_all),
            ptr(ptab), ptr(lens), ptr(k_self), ptr(v_self), ptr(nkq),
            ptr(nkp), ptr(nvq), ptr(nvp), ptr(out), B, layer, P, Hkv, G, D,
            page, ptab.shape[1], sm_scale, int(int8_qk), recip_f32(127.0),
            *int4_split(ptab.shape[1] * page, page,
                       (kq_all, kp_all, vq_all, vp_all)), stream(q))
    cuda_build.check(rc, "int4_paged_decode_attention_self_append")
    LAUNCHES["int4_paged_decode_attention_self_append"] += 1
    return out


# ---------------------------------------------------------------------------
# Read-only paged attention (any page size) and the in-place pool append
# ---------------------------------------------------------------------------

def _paged_state(q, kq_all, kp_all, vq_all, vp_all, layer, page_table,
                 lengths, sm_scale, int8_qk):
    """Gather each row's pages, one attend_tile over them: (f32 q groups,
    online-softmax state)."""
    B, _, D = q.shape
    Hkv = kq_all.shape[2]
    qg = q_groups(q, Hkv, sm_scale)
    ptab = page_table.to(torch.int64)
    state = attend_tile(qg, _gather(kq_all[layer], ptab),
                        _gather(kp_all[layer], ptab),
                        _gather(vq_all[layer], ptab),
                        _gather(vp_all[layer], ptab), 0,
                        lengths.to(torch.int64),
                        empty_state(B, Hkv, qg.shape[2], D, q.device),
                        int8_qk=int8_qk)
    return qg, state


def paged_read_plain(q, kq_all, kp_all, vq_all, vp_all, layer, page_table,
                     lengths, sm_scale=None, int8_qk=False):
    """Plain PyTorch version of int4_paged_decode_attention_stacked: the
    tile over each row's pages, out = acc / l."""
    _, state = _paged_state(q, kq_all, kp_all, vq_all, vp_all, layer,
                            page_table, lengths, sm_scale, int8_qk)
    return finalize_read(q, state)[0]


def paged_read_self_plain(q, kq_all, kp_all, vq_all, vp_all, layer,
                          page_table, lengths, k_self, v_self, sm_scale=None,
                          int8_qk=False):
    """Plain PyTorch version of int4_paged_decode_attention_stacked_self:
    the tile over each row's pages, then the self fold."""
    qg, state = _paged_state(q, kq_all, kp_all, vq_all, vp_all, layer,
                             page_table, lengths, sm_scale, int8_qk)
    out = self_fold_finalize(qg, k_self.float(), v_self.float(), state)
    return out.reshape(q.shape).to(q.dtype)


def int4_paged_decode_attention_stacked(q, kq_all, kp_all, vq_all, vp_all,
                                        layer: int, page_table, lengths,
                                        sm_scale=None, int8_qk: bool = False):
    """Decode attention against layer `layer` of the stacked page pool
    (L, P, Hkv, D/2, page) u8 + (L, P, Hkv, 2, page) f32, read in place and
    never written, through page_table (B, NP) over the lengths[b] cached
    tokens.  Any page size.  q: (B, Hq, D) bf16, already per-head
    Hadamard-rotated like the keys.  Returns out (B, Hq, D) bf16; a row of
    length 0 gives NaN."""
    B, Hq, D, (L, P, Hkv, D2, page) = check_int4_attention(
        q, kq_all, kp_all, vq_all, vp_all, layer)
    _check_table(page_table, lengths, B)
    if not on_cuda((q, kq_all, kp_all, vq_all, vp_all, page_table, lengths)):
        return paged_read_plain(q, kq_all, kp_all, vq_all, vp_all, layer,
                                page_table, lengths, sm_scale, int8_qk)
    q, G, sm_scale = kernel_operands(q, (kq_all, kp_all, vq_all, vp_all),
                                     sm_scale)
    ptab = page_table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    fn = cuda_build.function(
        "paged_attention", "paged_attention_read_only_launch",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 2
        + [ctypes.c_void_p])
    rc = fn(ptr(q), ptr(kq_all), ptr(kp_all), ptr(vq_all), ptr(vp_all),
            ptr(ptab), ptr(lens), ptr(out), B, layer, P, Hkv, G, D, page,
            ptab.shape[1], sm_scale, int(int8_qk), recip_f32(127.0),
            *int4_split(ptab.shape[1] * page, page,
                       (kq_all, kp_all, vq_all, vp_all)), stream(q))
    cuda_build.check(rc, "int4_paged_decode_attention_stacked")
    LAUNCHES["int4_paged_decode_attention_stacked"] += 1
    return out


def int4_paged_decode_attention(q, kq, kp, vq, vp, page_table, lengths,
                                sm_scale=None):
    """One layer's pool (P, Hkv, D/2, page) + (P, Hkv, 2, page): the stacked
    function on the L = 1 view (no copy), default QK (bf16 q, f32 sums)."""
    return int4_paged_decode_attention_stacked(
        q, kq[None], kp[None], vq[None], vp[None], 0, page_table, lengths,
        sm_scale=sm_scale)


def int4_paged_decode_attention_stacked_self(q, kq_all, kp_all, vq_all,
                                             vp_all, layer: int, page_table,
                                             lengths, k_self, v_self, *,
                                             sm_scale=None,
                                             int8_qk: bool = False):
    """int4_paged_decode_attention_stacked with the new token's dequantized
    (k_self, v_self) (B, Hkv, D) f32 folded in as one more online-softmax
    step; the pool is only read (lengths counts cached tokens: the new one
    is not in the pool yet).  Any page size.  Returns out (B, Hq, D) bf16,
    normalized; a row of length 0 gives v_self."""
    B, Hq, D, (L, P, Hkv, D2, page) = check_int4_attention(
        q, kq_all, kp_all, vq_all, vp_all, layer)
    _check_table(page_table, lengths, B)
    require(k_self.shape == (B, Hkv, D) and v_self.shape == (B, Hkv, D),
            "k_self/v_self (B, Hkv, D)")
    tensors = (q, kq_all, kp_all, vq_all, vp_all, page_table, lengths,
               k_self, v_self)
    if not on_cuda(tensors):
        return paged_read_self_plain(q, kq_all, kp_all, vq_all, vp_all, layer,
                                     page_table, lengths, k_self, v_self,
                                     sm_scale, int8_qk)
    q, G, sm_scale = kernel_operands(q, (kq_all, kp_all, vq_all, vp_all),
                                     sm_scale)
    ptab = page_table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    k_self, v_self = k_self.float().contiguous(), v_self.float().contiguous()
    out = torch.empty_like(q)
    fn = cuda_build.function(
        "paged_attention", "paged_attention_read_only_self_launch",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 2
        + [ctypes.c_void_p])
    rc = fn(ptr(q), ptr(kq_all), ptr(kp_all), ptr(vq_all), ptr(vp_all),
            ptr(ptab), ptr(lens), ptr(k_self), ptr(v_self), ptr(out), B,
            layer, P, Hkv, G, D, page, ptab.shape[1], sm_scale, int(int8_qk),
            recip_f32(127.0), *int4_split(ptab.shape[1] * page, page,
                                          (kq_all, kp_all, vq_all, vp_all)),
            stream(q))
    cuda_build.check(rc, "int4_paged_decode_attention_stacked_self")
    LAUNCHES["int4_paged_decode_attention_stacked_self"] += 1
    return out


def paged_append_plain(kq, kp, vq, vp, layer, page_table, positions, nkq, nkp,
                       nvq, nvp):
    """Plain PyTorch version of paged_append_pool: one indexed assignment
    per pool, at page page_table[b, pos // page] (the last entry past the
    table, as a clamped gather), lane pos % page."""
    page = kq.shape[-1]
    pos = positions.to(torch.int64)
    rows = torch.arange(pos.shape[0], device=kq.device)
    slot = torch.clamp(pos // page, max=page_table.shape[1] - 1)
    pid, col = page_table.to(torch.int64)[rows, slot], pos % page
    kq[layer, pid, :, :, col] = nkq
    kp[layer, pid, :, :, col] = nkp.to(kp.dtype)
    vq[layer, pid, :, :, col] = nvq
    vp[layer, pid, :, :, col] = nvp.to(vp.dtype)


def paged_append_pool(kq, kp, vq, vp, layer: int, page_table, positions, nkq,
                      nkp, nvq, nvp):
    """Append one token per row b into layer `layer` of the page pools, in
    place (the reference aliases them): page page_table[b, pos // page],
    lane pos % page, for pos = positions[b].  kq/vq (L, P, H, D/2, page)
    u8, kp/vp (L, P, H, 2, page) f32; nkq/nvq (B, H, D/2) u8 and nkp/nvp
    (B, H, 2) f32, the layout decode_prep emits.  Exactly the new column
    is written, so two rows appending into one page never lose a write.
    Idle rows must point at a page nobody reads (they write it
    concurrently).  As in the reference, a page of 128 tokens or more must
    be a multiple of 128."""
    require(kq.dim() == 5 and vq.shape == kq.shape, "pools (L, P, H, D/2, page)")
    L, P, H, D2, page = kq.shape
    require(page < 128 or page % 128 == 0,
            f"page {page}: pages of 128 tokens or more must be multiples of "
            "128 (as in the reference)")
    require(kp.shape == (L, P, H, 2, page) and vp.shape == kp.shape,
            "param pools (L, P, H, 2, page)")
    require(0 <= layer < L, f"layer {layer} out of range {L}")
    B = positions.shape[0]
    require(positions.dim() == 1 and page_table.dim() == 2
            and page_table.shape[0] == B, "positions (B,), page_table (B, NP)")
    require(nkq.shape == (B, H, D2) and nvq.shape == nkq.shape
            and nkp.shape == (B, H, 2) and nvp.shape == nkp.shape,
            "nkq/nvq (B, H, D/2), nkp/nvp (B, H, 2)")
    tensors = (kq, kp, vq, vp, page_table, positions, nkq, nkp, nvq, nvp)
    if not on_cuda(tensors):
        paged_append_plain(kq, kp, vq, vp, layer, page_table, positions, nkq,
                           nkp, nvq, nvp)
        return
    require(kq.dtype == torch.uint8 and vq.dtype == torch.uint8
            and kp.dtype == torch.float32 and vp.dtype == torch.float32,
            "pool dtypes: u8 codes, f32 params")
    require(all(t.is_contiguous() for t in (kq, kp, vq, vp)),
            "pools must be contiguous (they are updated in place)")
    ptab = page_table.to(torch.int32).contiguous()
    pos = positions.to(torch.int32).contiguous()
    nkq, nvq = nkq.to(torch.uint8).contiguous(), nvq.to(torch.uint8).contiguous()
    nkp, nvp = nkp.float().contiguous(), nvp.float().contiguous()
    fn = cuda_build.function(
        "paged_attention", "paged_append_pool_launch",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    rc = fn(ptr(kq), ptr(kp), ptr(vq), ptr(vp), ptr(ptab), ptr(pos), ptr(nkq),
            ptr(nkp), ptr(nvq), ptr(nvp), B, layer, P, H, D2, page,
            ptab.shape[1], stream(kq))
    cuda_build.check(rc, "paged_append_pool")
    LAUNCHES["paged_append_pool"] += 1
