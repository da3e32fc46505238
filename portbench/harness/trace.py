"""A traced slice of serving: the benchmark's own host spans and the
profiler's device records (CUPTI), put on one clock.

The profiler records device activity only: its host-operation records
are not needed and reading them is what made traced windows slow.  The
two clocks are tied by a marker: after a synchronize, with the card
idle, the host stamps its clock and launches one small kernel, the
trace's first device record; its start less the stamp is the offset (a
launch latency, microseconds, off).
"""
from __future__ import annotations

import contextlib
import time

import torch

CLOCK = time.perf_counter_ns
TOP = 10  # entries of each breakdown list


class Spans:
    """Named host intervals (ns on :data:`CLOCK`), nested by time."""

    def __init__(self):
        self.items: list = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = CLOCK()
        try:
            yield
        finally:
            self.items.append((name, t0, CLOCK()))

    def wrap(self, name: str, fn):
        def spanned(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        return spanned

    def timeline(self, t0: int, t1: int) -> list:
        """[t0, t1) cut into (innermost span's name, start, end) pieces,
        ``harness`` where no span is open (spans nest: one thread)."""
        out, stack, cur = [], [], t0

        def emit(upto):
            nonlocal cur
            upto = min(max(upto, cur), t1)
            if upto > cur:
                out.append((stack[-1][0] if stack else "harness", cur, upto))
                cur = upto

        for name, s, e in sorted(self.items, key=lambda x: (x[1], -x[2])):
            while stack and stack[-1][1] <= s:
                emit(stack[-1][1])
                stack.pop()
            emit(s)
            stack.append((name, e))
        while stack:
            emit(stack[-1][1])
            stack.pop()
        emit(t1)
        return out


def device_records(prof) -> list:
    """(name, start_ns, end_ns) of every device record (kernels, copies,
    memsets); a user annotation's device range is left out."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        note = getattr(e, "is_user_annotation", None)
        if e.device_type() != DeviceType.CUDA or (note is not None
                                                  and note()):
            continue
        out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def union(intervals: list) -> list:
    """Disjoint sorted cover of ``[(start, end), ...]``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@contextlib.contextmanager
def traced(device):
    """Profile the body on ``device``; yields a dict that, after the
    block, holds ``records`` on the host clock (the marker dropped)."""
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, device=device)
    out: dict = {}
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        t_mark = CLOCK()
        marker.add_(1.0)
        torch.cuda.synchronize(device)
        yield out
        torch.cuda.synchronize(device)
    t0 = CLOCK()
    recs = sorted(device_records(prof), key=lambda r: r[1])
    if not recs:
        raise RuntimeError("the traced slice holds no device record")
    offset = recs[0][1] - t_mark
    out["records"] = [(n, s - offset, e - offset) for n, s, e in recs[1:]]
    out["read_s"] = (CLOCK() - t0) / 1e9


def _overlap(a: list, b: list) -> dict:
    """Per name of ``b``'s (name, start, end) pieces, the time they share
    with ``a``'s (start, end) intervals (both sorted, each disjoint)."""
    out: dict = {}
    i = j = 0
    while i < len(a) and j < len(b):
        (s0, e0), (name, s1, e1) = a[i], b[j]
        lo, hi = max(s0, s1), min(e0, e1)
        if hi > lo:
            out[name] = out.get(name, 0) + (hi - lo)
        if e0 < e1:
            i += 1
        else:
            j += 1
    return out


def summarize(records: list, spans: Spans, t0: int, t1: int,
              symbols) -> dict:
    """Device busy time (the union of the records inside [t0, t1]), the
    device time and record count of each kernel symbol, the top device
    operations, the device's idle time split by the innermost benchmark
    span the host was in meanwhile, and the host's own time in each
    span (its self time)."""
    inside = [(n, max(s, t0), min(e, t1)) for n, s, e in records
              if e > t0 and s < t1]
    cover = union([(s, e) for _, s, e in inside])
    busy_ns = sum(e - s for s, e in cover)
    by_name: dict = {}
    for n, s, e in inside:
        by_name[n] = by_name.get(n, 0) + (e - s)
    by_symbol = {}
    for sym in symbols:
        hits = [(e - s) for n, s, e in inside if sym in n]
        by_symbol[sym] = (sum(hits) / 1e9, len(hits))
    edges = [t0] + [x for se in cover for x in se] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    pieces = spans.timeline(t0, t1)
    idle = _overlap(gaps, pieces)
    host: dict = {}
    for name, s, e in pieces:
        host[name] = host.get(name, 0) + (e - s)
    top = lambda d: [[n, v / 1e9] for n, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (t1 - t0) / 1e9,
        "by_symbol": by_symbol,
        "device_ops": top(by_name),
        "idle_gaps": top(idle),
        "host_self_s": top(host),
    }
