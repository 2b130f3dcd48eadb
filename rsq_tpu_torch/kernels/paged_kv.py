"""Paged INT4 KV-cache attention (the port of the parts of
rsq_tpu.kernels.paged_kv on the paged serving path).

The cache is a global page pool shared by all sequences, layout
(L, P, Hkv, D/2, page) uint8 codes and (L, P, Hkv, 2, page) f32 params; a
sequence owns a row of page ids (the page table).

Kernel: int4_paged_decode_attention_self_append (csrc/paged_attention.cu,
on the device body it shares with the contiguous kernel in
csrc/int4_attention.cuh), with its plain version here.  It replaces both
the reference's grid and flat Pallas kernels.  Pages must hold a multiple
of 128 tokens.
"""

from __future__ import annotations

import ctypes
import math

import torch

from rsq_tpu_torch import resolve_device
from rsq_tpu_torch.core.hadamard import hadamard_transform_last
from rsq_tpu_torch.core.numerics import recip_f32
from rsq_tpu_torch.kernels import (LAUNCHES, cuda_build, on_cuda, ptr,
                                   require, stream)
from rsq_tpu_torch.kernels.kv_cache import (asym_quant_pack_head,
                                            attend_tile, empty_state,
                                            q_groups, self_fold_finalize,
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


def paged_self_append_plain(q, kq_all, kp_all, vq_all, vp_all, layer,
                            page_table, lengths, k_self, v_self, nkq, nkp,
                            nvq, nvp, sm_scale=None, int8_qk=False):
    """Plain PyTorch version: gather each row's pages, one attend_tile over
    them, the self fold, then the in-place append."""
    B, Hq, D = q.shape
    Hkv = kq_all.shape[2]
    page = kq_all.shape[-1]
    qg = q_groups(q, Hkv, sm_scale)
    dev = q.device
    state = empty_state(B, Hkv, qg.shape[2], D, dev)
    lengths = lengths.to(torch.int64)
    ptab = page_table.to(torch.int64)
    state = attend_tile(qg, _gather(kq_all[layer], ptab),
                        _gather(kp_all[layer], ptab),
                        _gather(vq_all[layer], ptab),
                        _gather(vp_all[layer], ptab), 0, lengths, state,
                        int8_qk=int8_qk)
    out = self_fold_finalize(qg, k_self.float(), v_self.float(), state)
    # the reference aliases the pools (input_output_aliases): update in place
    rows = torch.arange(B, device=dev)
    slot = torch.clamp(lengths // page, max=ptab.shape[1] - 1)
    wpid, col = ptab[rows, slot], lengths % page
    kq_all[layer, wpid, :, :, col] = nkq
    kp_all[layer, wpid, :, :, col] = nkp
    vq_all[layer, wpid, :, :, col] = nvq
    vp_all[layer, wpid, :, :, col] = nvp
    return out.reshape(B, Hq, D).to(q.dtype)


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
    require(q.dim() == 3 and kq_all.dim() == 5, "q (B, Hq, D), pools 5-D")
    B, Hq, D = q.shape
    L, P, Hkv, D2, page = kq_all.shape
    require(D == 2 * D2 and Hq % Hkv == 0, "head shapes disagree")
    require(page % 128 == 0,
            f"page {page}: pages under 128 tokens (or not a multiple of 128) "
            "need the separate append and read-only paged kernels, which are "
            "not ported yet")
    require(0 <= layer < L, f"layer {layer} out of range {L}")
    require(page_table.dim() == 2 and page_table.shape[0] == B
            and lengths.shape == (B,), "page_table (B, NP), lengths (B,)")
    require(q.dtype == torch.bfloat16, "q must be bf16")
    require(kq_all.dtype == torch.uint8 and vq_all.dtype == torch.uint8
            and kp_all.dtype == torch.float32 and vp_all.dtype == torch.float32,
            "pool dtypes: u8 codes, f32 params")
    require(nkq.shape == (B, Hkv, D2) and nkp.shape == (B, Hkv, 2)
            and k_self.shape == (B, Hkv, D), "new-token shapes")
    tensors = (q, kq_all, kp_all, vq_all, vp_all, page_table, lengths,
               k_self, v_self, nkq, nkp, nvq, nvp)
    if not on_cuda(tensors):
        return paged_self_append_plain(q, kq_all, kp_all, vq_all, vp_all,
                                       layer, page_table, lengths, k_self,
                                       v_self, nkq, nkp, nvq, nvp,
                                       sm_scale=sm_scale, int8_qk=int8_qk)
    G = Hq // Hkv
    require(D <= 128 and G <= 8, "kernel needs head_dim <= 128, Hq/Hkv <= 8")
    require(all(t.is_contiguous() for t in (kq_all, kp_all, vq_all, vp_all)),
            "pools must be contiguous (they are updated in place)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    q = q.contiguous()
    ptab = page_table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    k_self, v_self = k_self.float().contiguous(), v_self.float().contiguous()
    nkq, nvq = nkq.contiguous(), nvq.contiguous()
    nkp, nvp = nkp.float().contiguous(), nvp.float().contiguous()
    out = torch.empty_like(q)
    fn = cuda_build.function(
        "paged_attention", "paged_attention_self_append_launch",
        [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    rc = fn(ptr(q), ptr(kq_all), ptr(kp_all), ptr(vq_all), ptr(vp_all),
            ptr(ptab), ptr(lens), ptr(k_self), ptr(v_self), ptr(nkq),
            ptr(nkp), ptr(nvq), ptr(nvp), ptr(out), B, layer, P, Hkv, G, D,
            page, ptab.shape[1], sm_scale, int(int8_qk), recip_f32(127.0),
            stream(q))
    cuda_build.check(rc, "int4_paged_decode_attention_self_append")
    LAUNCHES["int4_paged_decode_attention_self_append"] += 1
    return out
