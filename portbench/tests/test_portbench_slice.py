"""A traced slice on the CPU at a shrunk grid, the profiler stood in for
by an empty record: its buckets hold every slot the slice served, each
with the iterations the frozen decoder needs on it, and the spans name
the benchmark's own layers."""
import contextlib
import time

import small
from harness import arith, trace


def test_a_traced_slice_counts_its_buckets(monkeypatch):
    @contextlib.contextmanager
    def no_profiler(device):
        out = {}
        yield out
        out.update(records=[], read_s=0.0)
    monkeypatch.setattr(trace, "traced", no_profiler)
    spans = []
    summarize = trace.summarize

    def kept(records, s, t0, t1, symbols):
        spans.extend(name for name, _, _ in s.items)
        return summarize(records, s, t0, t1, symbols)
    monkeypatch.setattr(trace, "summarize", kept)
    cell = small.small_cell("siso-classical", monkeypatch)
    driver = arith.load("drivers", cell.config["driver"])
    run = driver.run(cell, seed=3_000_000_023, seconds=0.5, traced=True,
                     device="cpu", t_start=time.time())
    s = run.slice
    assert s["ticks"] == cell.mix["trace_ticks"]
    assert sum(b["real_slots"] for b in s["buckets"]) == s["slots"] > 0
    for b in s["buckets"]:
        rung = cell.rungs[b["mcs"]]
        assert len(b["real_iters"]) == b["real_slots"] * \
            rung.codewords_per_slot
        assert all(0 <= it <= cell.config["decoder"]["max_iters"]
                   for it in b["real_iters"])
        assert b["lanes"] >= 1 and b["batch"] == cell.mix["batch_size"]
    # one bucket a (tick, rung): as many as the scheduler's replays
    assert len(s["buckets"]) == s["steps"]
    assert set(spans) == {"tick", "slot_factory"}
    assert arith.step_ops(cell, s["buckets"]) > 0
