"""Slot-based continuous-batching serving engine over the contiguous cache
(the port of rsq_tpu.serving.engine).

B cache slots decode jointly with per-slot lengths and positions; a
finished sequence frees its slot and a queued request is admitted by
prefilling into the free slot while the other slots keep their state.

As in the reference, the C++ scheduler (serving/native.maybe_scheduler)
keeps the slot and page accounting when g++ can build it: every request
is enqueued there, admitted into its slot and released at retirement, and
an admission it refuses is an error.  Without it (`sched` is None) the
engine runs in Python alone.  The scheduler only counts on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rsq_tpu_torch import resolve_device
from rsq_tpu_torch.serving.model import (ServingConfig, _prefill_fast,
                                         decode_step_stacked, init_cache,
                                         stack_layer_params)
from rsq_tpu_torch.serving.native import maybe_scheduler

# the stacked fast path takes per-slot lengths natively
decode_step_varlen = decode_step_stacked


def bucket_length(s: int, lo: int = 16) -> int:
    """Power-of-two bucket (min `lo`) a prompt of length s pads into."""
    b = lo
    while b < s:
        b *= 2
    return b


@torch.no_grad()
def prefill_into_slot(params, cache, input_ids, sc: ServingConfig, slot: int,
                      true_len: int | None = None):
    """Prefill ONE sequence (input_ids (1, S_bucket), right-padded; true_len
    its real length) into cache slot `slot`, leaving the other slots
    untouched.  The prefill writes straight through the slot's views
    cache[k][:, slot:slot+1]: they are not contiguous, and the prefill's
    cache writes are indexed assignments, which follow any strides, so no
    temporary is needed (no kernel writes the cache at prefill).  Returns
    (logits (V,), cache)."""
    sub = {k: (v[:, slot:slot + 1] if k != "length"
               else torch.zeros((1,), dtype=v.dtype, device=v.device))
           for k, v in cache.items()}
    logits, sub = _prefill_fast(params, sub, input_ids, sc,
                                true_len=true_len)
    cache["length"][slot] = sub["length"][0]
    return logits[0], cache


@dataclasses.dataclass
class Request:
    uid: int
    prompt_ids: np.ndarray
    max_new_tokens: int
    output: list = dataclasses.field(default_factory=list)
    done: bool = False
    # with record_logits=True: the logits that produced each output token
    logit_trace: list = dataclasses.field(default_factory=list)


class ServingEngine:
    """Greedy continuous-batching engine over `num_slots` cache slots."""

    def __init__(self, params, sc: ServingConfig, num_slots: int = 8,
                 eos_token: int | None = None, record_logits: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        if "layers_stacked" not in params:
            params = stack_layer_params(params)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"engine device is {self.device}")
        self.params = params
        self.sc = sc
        self.num_slots = num_slots
        self.eos = eos_token
        self.record_logits = record_logits
        self.cache = init_cache(sc, num_slots, device=self.device)
        # host copy of the slot lengths; idle slots stay at 0 (the
        # reference lets them count up), so their appends land in their own
        # position 0 and never run past max_seq
        self.lengths = np.zeros((num_slots,), np.int32)
        self.slots: list[Request | None] = [None] * num_slots
        self.queue: list[Request] = []
        self.next_tok = np.zeros((num_slots,), np.int32)
        self._uid = 0
        # the C++ scheduler keeps slot/page accounting when available
        self.sched = maybe_scheduler(num_slots, sc.max_seq)

    def add_request(self, prompt_ids, max_new_tokens: int = 32) -> int:
        self._uid += 1
        req = Request(self._uid, np.asarray(prompt_ids, np.int32),
                      max_new_tokens)
        self.queue.append(req)
        if self.sched is not None:
            self.sched.enqueue(req.uid, len(req.prompt_ids), max_new_tokens)
        return req.uid

    def _record(self, req: Request, logits):
        if self.record_logits:
            req.logit_trace.append(logits.float().cpu().numpy())

    def _admit(self):
        for slot in range(self.num_slots):
            if self.slots[slot] is None and self.queue:
                req = self.queue.pop(0)
                if self.sched is not None and not self.sched.admit(req.uid,
                                                                   slot):
                    raise RuntimeError(f"the scheduler refused request "
                                       f"{req.uid} in slot {slot}")
                s = len(req.prompt_ids)
                padded = np.zeros((1, bucket_length(s)), np.int64)
                padded[0, :s] = req.prompt_ids
                logits, self.cache = prefill_into_slot(
                    self.params, self.cache,
                    torch.as_tensor(padded, device=self.device), self.sc,
                    slot, true_len=s)
                tok = int(torch.argmax(logits))
                req.output.append(tok)
                self._record(req, logits)
                self.slots[slot] = req
                self.lengths[slot] = s
                self.next_tok[slot] = tok

    def _retire(self, slot: int):
        req = self.slots[slot]
        req.done = True
        self.slots[slot] = None
        self.lengths[slot] = 0
        if self.sched is not None:
            self.sched.release(req.uid)

    def step(self) -> list[Request]:
        """Admit queued requests, run one joint decode step, retire finished
        sequences.  Returns the newly finished requests."""
        self._admit()
        if all(s is None for s in self.slots):
            return []
        self.cache["length"] = torch.tensor(self.lengths, device=self.device)
        logits, self.cache = decode_step_varlen(
            self.params, self.cache,
            torch.tensor(self.next_tok, device=self.device), self.sc)
        active = np.array([s is not None for s in self.slots])
        self.lengths[active] += 1
        toks = torch.argmax(logits, dim=-1).cpu().numpy()
        finished = []
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(toks[slot])
            req.output.append(tok)
            self._record(req, logits[slot])
            self.next_tok[slot] = tok
            hit_eos = self.eos is not None and tok == self.eos
            # +1: the prefill already emitted the first token
            if (len(req.output) >= req.max_new_tokens or hit_eos
                    or int(self.lengths[slot]) + 1 >= self.sc.max_seq):
                finished.append(req)
                self._retire(slot)
        return finished

    def run_until_done(self, max_steps: int = 10_000) -> list[Request]:
        done = []
        for _ in range(max_steps):
            done += self.step()
            if not self.queue and all(s is None for s in self.slots):
                break
        return done
