"""Host-side accounting of the serving engines (the port of
rsq_tpu.serving.native): the C++ request scheduler and refcounted page
allocator of scheduler.cpp through ctypes, and PyPageAllocator, their
pure-Python twin.

The library is built with g++ on first use, keyed by a hash of the source
and the flags, into rsq_tpu_torch/_build/ (ignored by git; nothing is
built at import time).  As in the reference, `maybe_scheduler` returns None
and `make_page_allocator` returns the Python twin when the build or the
load fails, so the engines still run in Python alone.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "scheduler.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
_lib = None


def _so_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libscheduler-{digest[:16]}.so"


def _build() -> str:
    """Compile scheduler.cpp unless this source's library exists; written
    to a temporary name first, so processes building at once never load a
    half-written file."""
    so = _so_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    return str(so)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build())
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    sigs = {
        "sched_create": (vp, [ctypes.c_int, ctypes.c_int, ctypes.c_int]),
        "sched_destroy": (None, [vp]),
        "sched_enqueue": (None, [vp, i64, ctypes.c_int, ctypes.c_int]),
        "sched_admit": (ctypes.c_int, [vp, i64, ctypes.c_int]),
        "sched_release": (None, [vp, i64]),
        "sched_free_slots": (ctypes.c_int, [vp]),
        "sched_pages_free": (i64, [vp]),
        "sched_queue_len": (ctypes.c_int, [vp]),
        "sched_slot_of": (ctypes.c_int, [vp, i64]),
        "pa_create": (vp, [ctypes.c_int]),
        "pa_destroy": (None, [vp]),
        "pa_alloc": (ctypes.c_int, [vp, ctypes.c_int, ctypes.POINTER(i32)]),
        "pa_incref": (None, [vp, i32]),
        "pa_decref": (None, [vp, i32]),
        "pa_prefix_insert": (i32, [vp, ctypes.c_uint64, i32]),
        "pa_prefix_lookup": (i32, [vp, ctypes.c_uint64]),
        "pa_free_count": (i64, [vp]),
        "pa_cached_count": (i64, [vp]),
        "pa_stats": (None, [vp, ctypes.POINTER(i64)]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    _lib = lib
    return lib


class NativeScheduler:
    """Slot and page accounting of admitted requests, with a FIFO queue
    (C++): admission is refused when the slot is taken, the uid unknown or
    the page budget short."""

    def __init__(self, num_slots: int, max_seq: int, page_size: int = 256):
        self._lib = _load()
        self._h = self._lib.sched_create(num_slots, max_seq, page_size)

    def __del__(self):
        try:
            self._lib.sched_destroy(self._h)
        except Exception:
            pass

    def enqueue(self, uid: int, prompt_len: int, max_new_tokens: int):
        self._lib.sched_enqueue(self._h, uid, prompt_len, max_new_tokens)

    def admit(self, uid: int, slot: int) -> bool:
        return bool(self._lib.sched_admit(self._h, uid, slot))

    def release(self, uid: int):
        self._lib.sched_release(self._h, uid)

    @property
    def free_slots(self) -> int:
        return self._lib.sched_free_slots(self._h)

    @property
    def pages_free(self) -> int:
        return self._lib.sched_pages_free(self._h)

    @property
    def queue_len(self) -> int:
        return self._lib.sched_queue_len(self._h)

    def slot_of(self, uid: int) -> int:
        return self._lib.sched_slot_of(self._h, uid)


def maybe_scheduler(num_slots: int, max_seq: int,
                    page_size: int = 256) -> NativeScheduler | None:
    try:
        return NativeScheduler(num_slots, max_seq, page_size)
    except Exception as e:  # no g++, or the build failed
        logger.warning("native scheduler unavailable (%s); "
                       "running Python-only", e)
        return None


def _u64(h: int) -> ctypes.c_uint64:
    return ctypes.c_uint64(h & (2**64 - 1))


class NativePageAllocator:
    """Refcounted page allocator with a prefix cache (C++, vLLM-style);
    the same surface and semantics as PyPageAllocator."""

    def __init__(self, num_pages: int):
        self._lib = _load()
        self._h = self._lib.pa_create(num_pages)

    def __del__(self):
        try:
            self._lib.pa_destroy(self._h)
        except Exception:
            pass

    def alloc(self, n: int) -> list[int] | None:
        out = (ctypes.c_int32 * max(n, 1))()
        if not self._lib.pa_alloc(self._h, n, out):
            return None
        return [int(out[i]) for i in range(n)]

    def incref(self, page_id: int):
        self._lib.pa_incref(self._h, page_id)

    def decref(self, page_id: int):
        self._lib.pa_decref(self._h, page_id)

    def prefix_insert(self, h: int, page_id: int) -> int:
        return int(self._lib.pa_prefix_insert(self._h, _u64(h), page_id))

    def prefix_lookup(self, h: int) -> int:
        return int(self._lib.pa_prefix_lookup(self._h, _u64(h)))

    @property
    def free_count(self) -> int:
        return int(self._lib.pa_free_count(self._h))

    @property
    def cached_count(self) -> int:
        return int(self._lib.pa_cached_count(self._h))

    @property
    def stats(self) -> dict:
        out = (ctypes.c_int64 * 3)()
        self._lib.pa_stats(self._h, out)
        return {"hits": int(out[0]), "misses": int(out[1]),
                "evictions": int(out[2])}


class PyPageAllocator:
    """Refcounted page allocator with a prefix cache (vLLM-style): pages
    whose refcount drops to 0 park in an LRU while their prefix hash is
    registered, and are evicted only under allocation pressure.  The
    pure-Python twin of NativePageAllocator: the fallback without g++, and
    the oracle the C++ one is tested against."""

    def __init__(self, num_pages: int):
        self._refs = [0] * num_pages
        self._hash = [None] * num_pages
        self._free = list(range(num_pages - 1, -1, -1))
        self._cache: dict[int, int] = {}
        self._lru: list[int] = []  # evictable, oldest first
        self._stats = {"hits": 0, "misses": 0, "evictions": 0}

    def _evict_one(self) -> bool:
        if not self._lru:
            return False
        pid = self._lru.pop(0)
        del self._cache[self._hash[pid]]
        self._hash[pid] = None
        self._free.append(pid)
        self._stats["evictions"] += 1
        return True

    def alloc(self, n: int) -> list[int] | None:
        while len(self._free) < n:
            if not self._evict_one():
                return None
        out = []
        for _ in range(n):
            pid = self._free.pop()
            self._refs[pid] = 1
            self._hash[pid] = None
            out.append(pid)
        return out

    def incref(self, pid: int):
        if self._refs[pid] == 0 and pid in self._lru:
            self._lru.remove(pid)
        self._refs[pid] += 1

    def decref(self, pid: int):
        if self._refs[pid] <= 0:
            return
        self._refs[pid] -= 1
        if self._refs[pid] == 0:
            if self._hash[pid] is not None:
                self._lru.append(pid)
            else:
                self._free.append(pid)

    def prefix_insert(self, h: int, pid: int) -> int:
        if h in self._cache:
            return self._cache[h]
        self._hash[pid] = h
        self._cache[h] = pid
        return pid

    def prefix_lookup(self, h: int) -> int:
        pid = self._cache.get(h, -1)
        if pid < 0:
            self._stats["misses"] += 1
            return -1
        self.incref(pid)
        self._stats["hits"] += 1
        return pid

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def cached_count(self) -> int:
        return len(self._cache)

    @property
    def stats(self) -> dict:
        return dict(self._stats)


def make_page_allocator(num_pages: int):
    try:
        return NativePageAllocator(num_pages)
    except Exception as e:
        logger.warning("native page allocator unavailable (%s); "
                       "using Python twin", e)
        return PyPageAllocator(num_pages)
