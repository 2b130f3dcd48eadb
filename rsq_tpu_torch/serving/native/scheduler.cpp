// Native request scheduler / KV-page accountant for the serving engine.
//
// Host-side native counterpart of the runtime bookkeeping the reference
// keeps in CUDA/C++ (the FlashInfer page tables, quarot/kernels/include/
// flashinfer/page.cuh:19 `paged_kv_t`, and the GPU job allocation loop,
// scripts/job_allocater.sh): a page free-list with per-request allocation,
// admission control against the KV-memory budget, and a FIFO request
// queue.  The engines of rsq_tpu_torch.serving call it through ctypes (C
// ABI); the device cache keeps its shape, with this accountant deciding
// which request may occupy which slot and how many pages it owns.  The
// same source as rsq_tpu/serving/native/scheduler.cpp.
//
// Build (serving/native/__init__.py does it on first use, into
// rsq_tpu_torch/_build/): g++ -O2 -std=c++17 -shared -fPIC scheduler.cpp

#include <cstdint>
#include <deque>
#include <list>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

struct Pending {
  int64_t uid;
  int prompt_len;
  int max_new_tokens;
};

struct Allocation {
  int slot;
  std::vector<int> pages;
};

struct Scheduler {
  int num_slots;
  int max_seq;
  int page_size;
  std::vector<int> free_pages;           // free list (LIFO)
  std::vector<int64_t> slot_owner;       // uid per slot, -1 free
  std::deque<Pending> queue;
  std::unordered_map<int64_t, Pending> pending_info;
  std::unordered_map<int64_t, Allocation> allocs;
  std::mutex mu;

  Scheduler(int slots, int max_seq_, int page)
      : num_slots(slots), max_seq(max_seq_), page_size(page),
        slot_owner(slots, -1) {
    int pages_per_slot = (max_seq + page - 1) / page;
    int total = pages_per_slot * slots;
    free_pages.reserve(total);
    for (int i = total - 1; i >= 0; --i) free_pages.push_back(i);
  }

  int pages_needed(const Pending &p) const {
    int len = p.prompt_len + p.max_new_tokens;
    if (len > max_seq) len = max_seq;
    return (len + page_size - 1) / page_size;
  }
};

}  // namespace

extern "C" {

void *sched_create(int num_slots, int max_seq, int page_size) {
  return new Scheduler(num_slots, max_seq, page_size);
}

void sched_destroy(void *h) { delete static_cast<Scheduler *>(h); }

void sched_enqueue(void *h, int64_t uid, int prompt_len, int max_new_tokens) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  Pending p{uid, prompt_len, max_new_tokens};
  s->queue.push_back(p);
  s->pending_info[uid] = p;
}

// Admit `uid` into `slot`. Returns 1 on success, 0 if the slot is taken,
// the uid is unknown, or the page budget is exhausted.
int sched_admit(void *h, int64_t uid, int slot) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if (slot < 0 || slot >= s->num_slots) return 0;
  if (s->slot_owner[slot] != -1) return 0;
  auto it = s->pending_info.find(uid);
  if (it == s->pending_info.end()) return 0;
  int need = s->pages_needed(it->second);
  if (static_cast<int>(s->free_pages.size()) < need) return 0;

  Allocation a;
  a.slot = slot;
  for (int i = 0; i < need; ++i) {
    a.pages.push_back(s->free_pages.back());
    s->free_pages.pop_back();
  }
  s->allocs[uid] = std::move(a);
  s->slot_owner[slot] = uid;
  for (auto q = s->queue.begin(); q != s->queue.end(); ++q) {
    if (q->uid == uid) { s->queue.erase(q); break; }
  }
  s->pending_info.erase(it);
  return 1;
}

void sched_release(void *h, int64_t uid) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->allocs.find(uid);
  if (it == s->allocs.end()) return;
  for (int p : it->second.pages) s->free_pages.push_back(p);
  s->slot_owner[it->second.slot] = -1;
  s->allocs.erase(it);
}

int sched_free_slots(void *h) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  int n = 0;
  for (int64_t o : s->slot_owner) n += (o == -1);
  return n;
}

int64_t sched_pages_free(void *h) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return static_cast<int64_t>(s->free_pages.size());
}

int sched_queue_len(void *h) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return static_cast<int>(s->queue.size());
}

int sched_slot_of(void *h, int64_t uid) {
  auto *s = static_cast<Scheduler *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->allocs.find(uid);
  return it == s->allocs.end() ? -1 : it->second.slot;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Refcounted page allocator with prefix cache (vLLM-style, new capability —
// the reference's paged_kv_t has per-request pages only, page.cuh:19).
//
// Pages holding a fully-written prompt prefix are registered under a
// cumulative content hash; a later request whose prompt shares that prefix
// re-uses the page (incref) instead of re-prefilling it.  Pages whose
// refcount reaches zero stay cached (evictable, LRU) until the free list
// runs dry.
// ---------------------------------------------------------------------------

namespace {

struct PageState {
  int refs = 0;
  uint64_t hash = 0;
  bool cached = false;
};

struct PageAllocator {
  std::vector<PageState> pages;
  std::vector<int> free_list;                         // LIFO
  std::unordered_map<uint64_t, int> cache;            // hash -> page id
  std::list<int> lru;                                 // evictable, front=old
  std::unordered_map<int, std::list<int>::iterator> lru_pos;
  int64_t hits = 0, misses = 0, evictions = 0;
  std::mutex mu;

  explicit PageAllocator(int n) : pages(n) {
    free_list.reserve(n);
    for (int i = n - 1; i >= 0; --i) free_list.push_back(i);
  }

  void drop_from_lru(int id) {
    auto it = lru_pos.find(id);
    if (it != lru_pos.end()) {
      lru.erase(it->second);
      lru_pos.erase(it);
    }
  }

  bool evict_one() {  // requires lock held; returns false if nothing to evict
    if (lru.empty()) return false;
    int id = lru.front();
    lru.pop_front();
    lru_pos.erase(id);
    cache.erase(pages[id].hash);
    pages[id] = PageState{};
    free_list.push_back(id);
    ++evictions;
    return true;
  }
};

}  // namespace

extern "C" {

void *pa_create(int num_pages) { return new PageAllocator(num_pages); }

void pa_destroy(void *h) { delete static_cast<PageAllocator *>(h); }

// Allocate n fresh pages (refcount 1) into out_ids. Evicts unreferenced
// cached pages LRU-first when the free list is short. Returns 1/0.
int pa_alloc(void *h, int n, int32_t *out_ids) {
  auto *a = static_cast<PageAllocator *>(h);
  std::lock_guard<std::mutex> g(a->mu);
  while (static_cast<int>(a->free_list.size()) < n)
    if (!a->evict_one()) return 0;
  for (int i = 0; i < n; ++i) {
    int id = a->free_list.back();
    a->free_list.pop_back();
    a->pages[id] = PageState{1, 0, false};
    out_ids[i] = id;
  }
  return 1;
}

void pa_incref(void *h, int32_t id) {
  auto *a = static_cast<PageAllocator *>(h);
  std::lock_guard<std::mutex> g(a->mu);
  if (a->pages[id].refs++ == 0) a->drop_from_lru(id);
}

// Drop one reference. At zero: cached pages park in the LRU (still
// lookup-able), uncached pages return to the free list.
void pa_decref(void *h, int32_t id) {
  auto *a = static_cast<PageAllocator *>(h);
  std::lock_guard<std::mutex> g(a->mu);
  PageState &p = a->pages[id];
  if (p.refs <= 0) return;
  if (--p.refs == 0) {
    if (p.cached) {
      a->lru.push_back(id);
      a->lru_pos[id] = std::prev(a->lru.end());
    } else {
      p = PageState{};
      a->free_list.push_back(id);
    }
  }
}

// Register `id` under `hash`. If the hash is already cached (a concurrent
// duplicate prefill), the existing entry wins; returns the canonical id.
int32_t pa_prefix_insert(void *h, uint64_t hash, int32_t id) {
  auto *a = static_cast<PageAllocator *>(h);
  std::lock_guard<std::mutex> g(a->mu);
  auto it = a->cache.find(hash);
  if (it != a->cache.end()) return it->second;
  a->pages[id].hash = hash;
  a->pages[id].cached = true;
  a->cache[hash] = id;
  return id;
}

// Look up a cached prefix page. On hit increfs and returns the id; -1 miss.
int32_t pa_prefix_lookup(void *h, uint64_t hash) {
  auto *a = static_cast<PageAllocator *>(h);
  std::lock_guard<std::mutex> g(a->mu);
  auto it = a->cache.find(hash);
  if (it == a->cache.end()) {
    ++a->misses;
    return -1;
  }
  int id = it->second;
  if (a->pages[id].refs++ == 0) a->drop_from_lru(id);
  ++a->hits;
  return id;
}

int64_t pa_free_count(void *h) {
  auto *a = static_cast<PageAllocator *>(h);
  std::lock_guard<std::mutex> g(a->mu);
  return static_cast<int64_t>(a->free_list.size());
}

int64_t pa_cached_count(void *h) {
  auto *a = static_cast<PageAllocator *>(h);
  std::lock_guard<std::mutex> g(a->mu);
  return static_cast<int64_t>(a->cache.size());
}

// stats: out[0]=hits, out[1]=misses, out[2]=evictions
void pa_stats(void *h, int64_t *out) {
  auto *a = static_cast<PageAllocator *>(h);
  std::lock_guard<std::mutex> g(a->mu);
  out[0] = a->hits;
  out[1] = a->misses;
  out[2] = a->evictions;
}

}  // extern "C"
