"""The C++ scheduler and page allocator of rsq_tpu_torch.serving.native
(built here with g++) against PyPageAllocator, the port's Python twin, and
against rsq_tpu.serving.native's binding of the same source, on seeded
call sequences: every return value, free and cached counts and stats equal
after every call (chip_smoke.allocator_trace, which the smoke runs on the
card's host too).  Then the engines: the paged and the contiguous engine
run on the native path by default, and give the same tokens with it off
(the Python twin, no scheduler)."""

import numpy as np
import pytest

from rsq_tpu.serving import native as JN
from rsq_tpu_torch.models.config import ModelConfig
from rsq_tpu_torch.serving import engine as TE
from rsq_tpu_torch.serving import model as TS
from rsq_tpu_torch.serving import native as TN
from rsq_tpu_torch.serving import paged as TPG
from chip_smoke import allocator_trace
from test_torch_packing import dense_model, torch_serving_params


@pytest.mark.parametrize("seed,num_pages", [(0, 6), (1, 16), (2, 64)])
def test_native_page_allocator_matches_twin_and_reference(seed, num_pages):
    traces = [allocator_trace(a, seed, steps=400) for a in (
        TN.NativePageAllocator(num_pages), TN.PyPageAllocator(num_pages),
        JN.NativePageAllocator(num_pages), JN.PyPageAllocator(num_pages))]
    assert traces[0] == traces[1] == traces[2] == traces[3]
    stats = traces[0][-1][2]
    assert stats["hits"] > 0 and stats["misses"] > 0
    if num_pages == 6:
        assert stats["evictions"] > 0


def scheduler_trace(sched, seed, num_slots=4, max_seq=512, page=128):
    """Seeded enqueue / admit / release calls (and admissions the scheduler
    must refuse: a taken or out-of-range slot, an unknown uid); every
    result and the counts after each call."""
    rng = np.random.default_rng(seed)
    queued, admitted, out, uid = [], {}, [], 0
    for _ in range(300):
        op = rng.choice(["enqueue", "admit", "release", "bad"],
                        p=[0.35, 0.35, 0.25, 0.05])
        if op == "enqueue":
            uid += 1
            sched.enqueue(uid, int(rng.integers(1, max_seq)),
                          int(rng.integers(1, 300)))
            queued.append(uid)
        elif op == "admit" and queued:
            u = queued[int(rng.integers(len(queued)))]
            slot = int(rng.integers(num_slots))
            ok = sched.admit(u, slot)
            if ok:
                queued.remove(u)
                admitted[u] = slot
            out.append(("admit", u, slot, ok))
        elif op == "release" and admitted:
            u = list(admitted)[int(rng.integers(len(admitted)))]
            sched.release(u)
            del admitted[u]
        elif op == "bad":
            out.append(("bad", sched.admit(uid + 1000, 0),
                        sched.admit(queued[0] if queued else 0, num_slots)))
        out.append((sched.free_slots, sched.pages_free, sched.queue_len,
                    tuple(sched.slot_of(u) for u in range(uid + 1))))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_native_scheduler_matches_reference(seed):
    """The port's NativeScheduler against the reference's binding of the
    same C++ on one call sequence; the accounting also holds by hand:
    pages_free is the pool less each admitted request's
    ceil(min(prompt + new, max_seq) / page)."""
    t = TN.NativeScheduler(4, 512, 128)
    j = JN.NativeScheduler(4, 512, 128)
    assert scheduler_trace(t, seed) == scheduler_trace(j, seed)
    s = TN.NativeScheduler(2, 512, 128)
    assert (s.free_slots, s.pages_free, s.queue_len) == (2, 8, 0)
    s.enqueue(7, 200, 100)
    s.enqueue(8, 500, 100)
    assert s.admit(7, 1) and not s.admit(8, 1) and s.admit(8, 0)
    assert (s.free_slots, s.pages_free, s.queue_len) == (0, 8 - 3 - 4, 0)
    assert (s.slot_of(7), s.slot_of(8), s.slot_of(9)) == (1, 0, -1)
    s.release(7)
    assert (s.free_slots, s.pages_free) == (1, 4)


def test_fallbacks_without_a_compiler(monkeypatch):
    """As in the reference: no library -> maybe_scheduler is None and
    make_page_allocator is the Python twin."""
    def broken():
        raise OSError("no g++")

    monkeypatch.setattr(TN, "_lib", None)
    monkeypatch.setattr(TN, "_build", broken)
    assert TN.maybe_scheduler(2, 256) is None
    assert isinstance(TN.make_page_allocator(4), TN.PyPageAllocator)


def test_library_built_in_the_build_directory():
    path = TN._so_path()
    assert path.parent.name == "_build" and path.parent.parent.name == \
        "rsq_tpu_torch"
    TN._load()
    assert path.exists()


@pytest.fixture(scope="module")
def served():
    cfg = ModelConfig.tiny()
    params, quant = dense_model(cfg, seed=1)
    sc = TS.ServingConfig(model=cfg, a4=True, kv_int4=True, kv_hadamard=True,
                          online_had=True, max_seq=256)
    return cfg, torch_serving_params(cfg, params, quant), sc


def _requests(cfg):
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab_size, 130)
    return [(np.concatenate([shared, rng.integers(0, cfg.vocab_size, n)]),
             mnt) for n, mnt in [(5, 4), (9, 3)]] + [
        (rng.integers(0, cfg.vocab_size, n), mnt) for n, mnt in [(6, 5),
                                                                  (40, 2)]]


def _serve(make, cfg, native: bool, monkeypatch):
    with monkeypatch.context() as m:
        if not native:
            m.setattr(TPG, "make_page_allocator", TN.PyPageAllocator)
            m.setattr(TE, "maybe_scheduler", lambda *a, **k: None)
        eng = make()
    for p, mnt in _requests(cfg):
        eng.add_request(p, max_new_tokens=mnt)
    done = eng.run_until_done(max_steps=100)
    return eng, {r.uid: r.output for r in done}


@pytest.mark.parametrize("engine", ["paged", "contiguous"])
def test_engine_outputs_equal_native_on_and_off(served, engine, monkeypatch):
    """Four requests through two slots (two share a 128-token page at page
    128): the same tokens with the native allocator / scheduler and with
    the Python twin / none; the native path is the default."""
    cfg, sp, sc = served
    if engine == "paged":
        def make():
            return TPG.PagedServingEngine(sp, sc, num_slots=2, page_size=128,
                                          device="cpu")
    else:
        def make():
            return TE.ServingEngine(sp, sc, num_slots=2, device="cpu")
    eng_on, on = _serve(make, cfg, True, monkeypatch)
    eng_off, off = _serve(make, cfg, False, monkeypatch)
    assert on == off and len(on) == 4
    if engine == "paged":
        assert isinstance(eng_on.alloc, TN.NativePageAllocator)
        assert isinstance(eng_off.alloc, TN.PyPageAllocator)
        assert eng_on.cache_stats == eng_off.cache_stats
        assert eng_on.cache_stats["hits"] == 1
    else:
        assert isinstance(eng_on.sched, TN.NativeScheduler)
        assert eng_off.sched is None
        assert eng_on.sched.free_slots == 2 and eng_on.sched.queue_len == 0
        assert eng_on.sched.pages_free == 2 * 1   # 256 / the default 256
