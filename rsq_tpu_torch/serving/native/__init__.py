"""Page allocator of the paged engine (the port of
rsq_tpu.serving.native.PyPageAllocator, in pure Python; the C++ allocator
binding is not ported yet)."""

from __future__ import annotations


class PyPageAllocator:
    """Refcounted page allocator with a prefix cache (vLLM-style): pages
    whose refcount drops to 0 park in an LRU while their prefix hash is
    registered, and are evicted only under allocation pressure.  Same
    semantics as the reference's NativePageAllocator / PyPageAllocator."""

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
