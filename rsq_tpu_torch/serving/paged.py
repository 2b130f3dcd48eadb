"""Paged continuous-batching serving engine with prefix caching (the port
of rsq_tpu.serving.paged's fast single-device path).

KV memory is a global page pool; a slot owns page ids.  Pages fully covered
by a prompt are registered under a cumulative content hash, so a later
request sharing that prefix reuses them and prefills only its tail,
attending to the cached prefix through the pool.  A cached page is
immutable while shared: appends only touch pages past the owner's prompt.

Prefill is plain PyTorch around the linear and lm_head kernels; each
decode step runs, per layer, the qkv linear(s) -> decode_prep -> paged
attention with in-place append -> o -> up/gate -> down, then the lm_head.
With pages under 128 tokens the step runs, as the reference does, the
pool append kernel and then the read-only paged attention over the
lengths + 1 tokens instead of the self-appending kernel (and, as there,
without attn_int8_qk).  A page of 128 tokens or more must be a multiple of
128.  Params may be fused (fuse_for_decode: qkv, upgate) or unfused (q, k,
v, up, gate): W4A4, weight-only W4 (a4=False), E8P re-encoded to affine
int4, or dense bf16, as serving/model._linear_fast dispatches them.

prefill_paged and decode_step_paged are the reference's per-layer oracles
on unstacked params["layers"] (serving/model.serving_linear).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rsq_tpu_torch import resolve_device
from rsq_tpu_torch.core.hadamard import hadamard_transform_last
from rsq_tpu_torch.kernels import paged_kv as PKV
from rsq_tpu_torch.kernels.kv_cache import (asym_quant_pack_head,
                                            decode_prep, to_lane_major,
                                            unpack_dequant_head)
from rsq_tpu_torch.models import llama as M
from rsq_tpu_torch.serving.model import (ServingConfig, _attn_out,
                                         _fast_path_helpers, _last_logits,
                                         _mlp, _qkv, _sl, attn_out_fast,
                                         lm_head_logits, mlp_fast, qkv_fast,
                                         stack_layer_params)
from rsq_tpu_torch.serving.native import make_page_allocator

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def prefix_hashes(token_ids: np.ndarray, page_size: int) -> list[int]:
    """Cumulative FNV-1a hash per FULL page of the prompt: hash[j] covers
    tokens [0, (j+1)*page), so only true prefixes collide."""
    out = []
    h = _FNV_OFFSET
    for j in range(len(token_ids) // page_size):
        chunk = np.asarray(token_ids[j * page_size:(j + 1) * page_size],
                           np.int64)
        for t in chunk.tobytes():
            h = ((h ^ t) * _FNV_PRIME) & (2**64 - 1)
        out.append(h)
    return out


def _check_page(page: int) -> None:
    """Mirrors the reference's refusal (kernels/paged_kv.py:818-819): any
    page under 128 tokens, else a multiple of 128."""
    if page < 1 or (page >= 128 and page % 128):
        raise ValueError(
            f"page size {page}: pages of 128 tokens or more must be a "
            "multiple of 128 (as in the reference)")


def _pool_write_pages(pool, layer: int, page_ids, kq, kp, vq, vp):
    """Write whole pages of one layer in place, in order (a repeated page id
    -- the null page under tail bucketing -- keeps the last write).
    kq/vq: (H, D/2, n*page); kp/vp: (H, 2, n*page); page_ids: n ints."""
    page = pool["kq"].shape[-1]
    for name, val in (("kq", kq), ("kp", kp), ("vq", vq), ("vp", vp)):
        arr = pool[name]
        for j, pid in enumerate(page_ids):
            arr[layer, pid] = val[..., j * page:(j + 1) * page]


def _pool_append_token(pool, layer: int, page_table, positions, kq, kp, vq,
                       vp):
    """Append one token per row in place: kq/vq (B, H, D/2, 1), kp/vp
    (B, H, 2, 1) at page page_table[b, pos // page], lane pos % page (the
    reference's dynamic_update_slices; plain indexing, no kernel)."""
    PKV.paged_append_plain(pool["kq"], pool["kp"], pool["vq"], pool["vp"],
                           layer, page_table, positions, kq[..., 0],
                           kp[..., 0], vq[..., 0], vp[..., 0])
    return pool


def _gather_layer_prefix(pool, layer: int, page_ids):
    """Dequantize a layer's prefix pages -> (k, v) each (1, S, Hkv, D) f32."""
    idx = torch.as_tensor(list(page_ids), device=pool["kq"].device)

    def grab(qn, pn):
        qv = pool[qn][layer][idx].movedim(0, -2)     # (H, D/2, n, page)
        pv = pool[pn][layer][idx].movedim(0, -2)
        qv = qv.reshape(qv.shape[0], qv.shape[1], -1)
        pv = pv.reshape(pv.shape[0], pv.shape[1], -1)
        x = unpack_dequant_head(qv.transpose(-1, -2), pv.transpose(-1, -2))
        return x.transpose(0, 1)[None]               # (1, S, H, D)
    return grab("kq", "kp"), grab("vq", "vp")


def _prefill_paged_local(params, pool, page_row, input_tail,
                         sc: ServingConfig, prefix_pages: int,
                         prefix_len: int, prompt_len: int):
    """Chunked prefill over stacked params: run the prompt tail (everything
    past the cached prefix), attending to [cached prefix ++ tail], and write
    the tail's K/V pages into the pool in place.  Returns (logits (1, V),
    pool)."""
    cfg = sc.cfg
    if not sc.kv_int4:
        raise NotImplementedError("paged engine requires kv_int4")
    ls = params["layers_stacked"]
    page = pool["kq"].shape[-1]
    L = pool["kq"].shape[0]
    st = input_tail.shape[1]
    hd = cfg.head_dim_
    nq, nkv, mix_heads, mix_act = _fast_path_helpers(cfg)
    nrep = nq // nkv
    row, tail_ids, cos, sin, mask = _tail_setup(page_row, input_tail, cfg,
                                                page, prefix_pages, prefix_len)

    x = params["embed"][input_tail].to(torch.bfloat16)

    for i in range(L):
        h = M.rms_norm(x, _sl(ls.get("input_norm"), i), cfg.rms_norm_eps)
        q, k, v = qkv_fast(ls, h.reshape(st, -1), i, sc)
        q = M.apply_rope(q.reshape(1, st, nq, hd), cos, sin)
        k = M.apply_rope(k.reshape(1, st, nkv, hd), cos, sin)
        attn = _tail_attention(pool, i, row, tail_ids, prefix_pages,
                               prefix_len, q, k, v.reshape(1, st, nkv, hd),
                               mask, sc, nrep)
        x = attn_out_fast(ls, i, x, attn.reshape(1, st, nq * hd), sc,
                          mix_heads)
        x = mlp_fast(ls, i, x, cfg, sc, mix_act)

    last = prompt_len - prefix_len - 1
    x = M.rms_norm(x[:, last:last + 1], params.get("final_norm"),
                   cfg.rms_norm_eps)
    return lm_head_logits(params, x)[:, 0], pool


def _tail_attention(pool, layer: int, row, tail_ids, prefix_pages: int,
                    prefix_len: int, q, k, v, mask, sc: ServingConfig,
                    nrep: int):
    """One layer of a paged prefill after its projections: write the tail's
    quantized K/V pages in place, then attend [cached prefix ++ tail] (the
    prefix dequantized from the pool, in the Hadamard basis).  q, k, v:
    (1, St, H, D) post-rope."""
    kb, vb = k.transpose(1, 2), v.transpose(1, 2)            # (1, H, St, D)
    kq_, kp_ = PKV.quantize_prompt(kb, hadamard=sc.kv_hadamard)
    vq_, vp_ = PKV.quantize_prompt(vb, hadamard=False)
    _pool_write_pages(pool, layer, tail_ids, kq_[0], kp_[0], vq_[0], vp_[0])
    if not prefix_pages:
        return M.attention(q, M.repeat_kv(k, nrep), M.repeat_kv(v, nrep),
                           mask[:, prefix_len:])
    qr, kr = q.transpose(1, 2), kb
    if sc.kv_hadamard:
        qr, kr = hadamard_transform_last(qr), hadamard_transform_last(kr)
    qr, kr = qr.transpose(1, 2), kr.transpose(1, 2)
    pk, pv = _gather_layer_prefix(pool, layer, row[:prefix_pages])
    keys = torch.cat([pk.to(qr.dtype), kr.to(qr.dtype)], dim=1)
    vals = torch.cat([pv.to(qr.dtype), v.to(qr.dtype)], dim=1)
    return M.attention(qr, M.repeat_kv(keys, nrep), M.repeat_kv(vals, nrep),
                       mask)


def _tail_setup(page_row, input_tail, cfg, page: int, prefix_pages: int,
                prefix_len: int):
    """(row, tail page ids, rope cos/sin, causal mask over [prefix ++ tail])
    of a paged prefill."""
    st = input_tail.shape[1]
    dev = input_tail.device
    row = [int(p) for p in page_row]
    tail_ids = row[prefix_pages:prefix_pages + st // page]
    positions = prefix_len + torch.arange(st, device=dev)
    cos, sin = M.rope_tables(cfg, positions)
    kpos = torch.arange(prefix_len + st, device=dev)[None, :]
    mask = torch.where(kpos <= positions[:, None], 0.0, -1e30).float()
    return row, tail_ids, cos, sin, mask


@torch.no_grad()
def prefill_paged(params, pool, page_row, input_tail, sc: ServingConfig,
                  prefix_pages: int, prefix_len: int, prompt_len: int):
    """The reference's per-layer paged prefill on unstacked params["layers"]
    (serving_linear): the prompt tail after the cached prefix, its pages
    written in place.  Returns (last-token logits (V,), pool)."""
    cfg = sc.cfg
    if not sc.kv_int4:
        raise NotImplementedError("paged engine requires kv_int4")
    page = pool["kq"].shape[-1]
    st = input_tail.shape[1]
    nrep = cfg.num_attention_heads // cfg.num_key_value_heads
    row, tail_ids, cos, sin, mask = _tail_setup(page_row, input_tail, cfg,
                                                page, prefix_pages, prefix_len)
    x = params["embed"][input_tail].to(torch.bfloat16)
    for i, lp in enumerate(params["layers"]):
        h = M.rms_norm(x, lp.get("input_norm"), cfg.rms_norm_eps)
        q, k, v = _qkv(lp, h, cfg, sc)
        q, k = M.apply_rope(q, cos, sin), M.apply_rope(k, cos, sin)
        attn = _tail_attention(pool, i, row, tail_ids, prefix_pages,
                               prefix_len, q, k, v, mask, sc, nrep)
        x = x + _attn_out(lp, attn.reshape(1, st, -1), cfg, sc)
        h2 = M.rms_norm(x, lp.get("post_norm"), cfg.rms_norm_eps)
        x = x + _mlp(lp, h2, cfg, sc)
    last = prompt_len - prefix_len - 1
    return _last_logits(params, x[:, last:last + 1], cfg)[0], pool


@torch.no_grad()
def prefill_paged_fast(params, pool, page_row, input_tail, sc: ServingConfig,
                       prefix_pages: int, prefix_len: int, prompt_len: int):
    """Paged prefill of one request (pool updated in place, as the reference
    donates it).  Returns (last-token logits (V,), pool)."""
    logits, pool = _prefill_paged_local(params, pool, page_row, input_tail,
                                        sc, prefix_pages, prefix_len,
                                        prompt_len)
    return logits[0], pool


def _decode_paged_local(params, pool, page_tables, lengths, token_ids,
                        sc: ServingConfig):
    """One joint decode step over all slots: per layer the linears,
    decode_prep, and the paged attention kernel that folds the new token in
    and appends it to the pool in place; with pages under 128 tokens the
    append kernel, then the read-only attention over lengths + 1 tokens
    (default QK: the reference passes no int8_qk there)."""
    cfg = sc.cfg
    ls = params["layers_stacked"]
    L = pool["kq"].shape[0]
    page = pool["kq"].shape[-1]
    _check_page(page)
    fused_append = page % 128 == 0
    b = token_ids.shape[0]
    hd = cfg.head_dim_
    nq, _, mix_heads, mix_act = _fast_path_helpers(cfg)

    x = params["embed"][token_ids][:, None, :].to(torch.bfloat16)
    cos, sin = M.rope_tables(cfg, lengths)                   # (B, hd)
    read_len = lengths + 1                 # the sub-128 read sees the new token
    for i in range(L):
        h = M.rms_norm(x, _sl(ls.get("input_norm"), i), cfg.rms_norm_eps)
        q, k, v = qkv_fast(ls, h.reshape(b, -1), i, sc)
        qh, k_self, v_self, kq_, kp_, vq_, vp_ = decode_prep(
            q, k, v, cos, sin, kv_had=sc.kv_hadamard)
        if fused_append:
            attn = PKV.int4_paged_decode_attention_self_append(
                qh, pool["kq"], pool["kp"], pool["vq"], pool["vp"], i,
                page_tables, lengths, k_self, v_self, kq_, kp_, vq_, vp_,
                int8_qk=sc.attn_int8_qk)
        else:
            PKV.paged_append_pool(pool["kq"], pool["kp"], pool["vq"],
                                  pool["vp"], i, page_tables, lengths, kq_,
                                  kp_, vq_, vp_)
            attn = PKV.int4_paged_decode_attention(
                qh, pool["kq"][i], pool["kp"][i], pool["vq"][i],
                pool["vp"][i], page_tables, read_len)
        x = attn_out_fast(ls, i, x, attn.reshape(b, 1, nq * hd), sc,
                          mix_heads)
        x = mlp_fast(ls, i, x, cfg, sc, mix_act)

    x = M.rms_norm(x, params.get("final_norm"), cfg.rms_norm_eps)
    return lm_head_logits(params, x)[:, 0], pool


@torch.no_grad()
def decode_step_paged_fast(params, pool, page_tables, lengths, token_ids,
                           sc: ServingConfig):
    """One decode step (pool updated in place).  lengths: (B,) tokens
    already cached per slot; token_ids: (B,).  Returns (logits (B, V), pool)."""
    return _decode_paged_local(params, pool, page_tables, lengths, token_ids,
                               sc)


@torch.no_grad()
def decode_step_paged(params, pool, page_tables, lengths, token_ids,
                      sc: ServingConfig):
    """The reference's per-layer paged decode step on unstacked
    params["layers"]: per layer the projections (serving_linear), the new
    token quantized and appended by plain indexing, then the read-only
    paged attention over lengths + 1 tokens.  Any page size; the pool is
    updated in place.  Returns (logits (B, V), pool)."""
    cfg = sc.cfg
    B, hd = token_ids.shape[0], cfg.head_dim_
    x = params["embed"][token_ids][:, None, :].to(torch.bfloat16)
    cos, sin = M.rope_tables(cfg, lengths)
    cos, sin = cos[:, None, :], sin[:, None, :]
    for i, lp in enumerate(params["layers"]):
        h = M.rms_norm(x, lp.get("input_norm"), cfg.rms_norm_eps)
        q, k, v = _qkv(lp, h, cfg, sc)
        q, k = M.apply_rope(q, cos, sin), M.apply_rope(k, cos, sin)
        kb, vb = k.transpose(1, 2), v.transpose(1, 2)        # (B, H, 1, D)
        if sc.kv_hadamard:
            kb = hadamard_transform_last(kb)
        kq_, kp_ = to_lane_major(*asym_quant_pack_head(kb))
        vq_, vp_ = to_lane_major(*asym_quant_pack_head(vb))
        pool = _pool_append_token(pool, i, page_tables, lengths, kq_, kp_,
                                  vq_, vp_)
        qh = q.reshape(B, -1, hd)
        if sc.kv_hadamard:
            qh = hadamard_transform_last(qh)
        attn = PKV.int4_paged_decode_attention(
            qh, pool["kq"][i], pool["kp"][i], pool["vq"][i], pool["vp"][i],
            page_tables, lengths + 1)
        x = x + _attn_out(lp, attn.reshape(B, 1, -1), cfg, sc)
        h2 = M.rms_norm(x, lp.get("post_norm"), cfg.rms_norm_eps)
        x = x + _mlp(lp, h2, cfg, sc)
    return _last_logits(params, x, cfg), pool


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PagedRequest:
    uid: int
    prompt_ids: np.ndarray
    max_new_tokens: int
    output: list = dataclasses.field(default_factory=list)
    pages: list = dataclasses.field(default_factory=list)
    reused_pages: int = 0
    done: bool = False
    # with record_logits=True: the logits that produced each output token
    logit_trace: list = dataclasses.field(default_factory=list)


class PagedServingEngine:
    """Continuous batching over a shared page pool with prefix caching."""

    def __init__(self, params, sc: ServingConfig, num_slots: int = 8,
                 num_pages: int | None = None, page_size: int = 128,
                 eos_token: int | None = None, prefix_caching: bool = True,
                 record_logits: bool = False, device="cuda"):
        if not sc.kv_int4:
            raise ValueError("paged engine serves the INT4 cache")
        _check_page(page_size)
        self.device = resolve_device(device)
        cfg = sc.cfg
        if "layers_stacked" not in params:
            params = stack_layer_params(params)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"engine device is {self.device}")
        self.params = params
        self.sc = sc
        self.record_logits = record_logits
        self.page = page_size
        self.np_per_slot = -(-sc.max_seq // page_size)
        self.num_slots = num_slots
        self.eos = eos_token
        self.prefix_caching = prefix_caching
        if num_pages is None:
            num_pages = num_slots * self.np_per_slot + 1
        self.pool = PKV.init_pool(cfg.num_layers, num_pages,
                                  cfg.num_key_value_heads, cfg.head_dim_,
                                  page_size, device=self.device)
        # the C++ allocator (serving/native), or its Python twin without g++
        self.alloc = make_page_allocator(num_pages)
        # permanent scratch page: idle slots' rows point here, so their
        # appends (and tail-bucket padding) never touch a live page
        self.null_page = self.alloc.alloc(1)[0]
        self.page_tables = np.full((num_slots, self.np_per_slot),
                                   self.null_page, np.int32)
        self.lengths = np.zeros((num_slots,), np.int32)
        self.slots: list[PagedRequest | None] = [None] * num_slots
        self.queue: list[PagedRequest] = []
        self.next_tok = np.zeros((num_slots,), np.int32)
        self._uid = 0

    def add_request(self, prompt_ids, max_new_tokens: int = 32) -> int:
        self._uid += 1
        self.queue.append(PagedRequest(self._uid,
                                       np.asarray(prompt_ids, np.int32),
                                       max_new_tokens))
        return self._uid

    def _admit_one(self, req: PagedRequest, slot: int) -> bool:
        plen = len(req.prompt_ids)
        total = min(plen + req.max_new_tokens, self.sc.max_seq)
        need_total = -(-total // self.page)

        reused: list[int] = []
        if self.prefix_caching:
            # reuse at most the pages strictly before the last prompt token
            # so the tail prefill always has >= 1 real token
            limit = (plen - 1) // self.page
            for h in prefix_hashes(req.prompt_ids, self.page)[:limit]:
                pid = self.alloc.prefix_lookup(h)
                if pid < 0:
                    break
                reused.append(pid)

        fresh = self.alloc.alloc(need_total - len(reused))
        if fresh is None:
            for pid in reused:
                self.alloc.decref(pid)
            return False

        pages = reused + fresh
        prefix_pages = len(reused)
        prefix_len = prefix_pages * self.page
        tail = req.prompt_ids[prefix_len:]
        # bucket the tail to a power-of-two page count (the reference does
        # so to bound compiled programs; kept so both write the same pages):
        # padding pages write through the row's null-page entries
        n_tail = -(-len(tail) // self.page)
        cap = self.np_per_slot - prefix_pages
        bucket = 1
        while bucket < n_tail:
            bucket *= 2
        st_pad = min(bucket, cap) * self.page
        tail_pad = np.zeros((1, st_pad), np.int64)
        tail_pad[0, :len(tail)] = tail

        row = np.full((self.np_per_slot,), self.null_page, np.int32)
        row[:len(pages)] = pages
        logits, self.pool = prefill_paged_fast(
            self.params, self.pool, row,
            torch.as_tensor(tail_pad, device=self.device), self.sc,
            prefix_pages=prefix_pages, prefix_len=prefix_len, prompt_len=plen)

        if self.prefix_caching:
            # register every fully-prompt-covered page (a duplicate hash
            # keeps the already-cached page canonical; ours stays owned)
            for j, h in enumerate(prefix_hashes(req.prompt_ids, self.page)):
                if j < len(pages):
                    self.alloc.prefix_insert(h, pages[j])

        tok = int(torch.argmax(logits))
        req.output.append(tok)
        if self.record_logits:
            req.logit_trace.append(logits.float().cpu().numpy())
        req.pages = pages
        req.reused_pages = prefix_pages
        self.slots[slot] = req
        self.page_tables[slot] = row
        self.lengths[slot] = plen
        self.next_tok[slot] = tok
        return True

    def _admit(self):
        for slot in range(self.num_slots):
            if self.slots[slot] is None and self.queue:
                if not self._admit_one(self.queue[0], slot):
                    break  # page pressure: wait for retirements
                self.queue.pop(0)

    def _retire(self, slot: int):
        req = self.slots[slot]
        req.done = True
        for pid in req.pages:
            self.alloc.decref(pid)
        self.slots[slot] = None
        self.page_tables[slot] = self.null_page
        self.lengths[slot] = 0

    def step(self) -> list[PagedRequest]:
        self._admit()
        if all(s is None for s in self.slots):
            return []
        dev = self.device
        logits, self.pool = decode_step_paged_fast(
            self.params, self.pool, torch.as_tensor(self.page_tables, device=dev),
            torch.as_tensor(self.lengths, device=dev),
            torch.as_tensor(self.next_tok, device=dev), self.sc)
        # idle slots stay at length 0 (the reference lets them count up; their
        # appends land in the null page either way)
        active = np.array([s is not None for s in self.slots])
        self.lengths[active] += 1
        toks = torch.argmax(logits, dim=-1).cpu().numpy()
        logits_np = (logits.float().cpu().numpy() if self.record_logits
                     else None)
        finished = []
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(toks[slot])
            req.output.append(tok)
            if self.record_logits:
                req.logit_trace.append(logits_np[slot])
            self.next_tok[slot] = tok
            hit_eos = self.eos is not None and tok == self.eos
            if (len(req.output) >= req.max_new_tokens or hit_eos
                    or int(self.lengths[slot]) + 1 >= self.sc.max_seq):
                finished.append(req)
                self._retire(slot)
        return finished

    def run_until_done(self, max_steps: int = 10_000) -> list[PagedRequest]:
        done = []
        for _ in range(max_steps):
            done += self.step()
            if not self.queue and all(s is None for s in self.slots):
                break
        return done

    @property
    def cache_stats(self) -> dict:
        s = self.alloc.stats
        s["free_pages"] = self.alloc.free_count
        s["cached_pages"] = self.alloc.cached_count
        return s
