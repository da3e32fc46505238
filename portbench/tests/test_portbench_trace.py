"""The traced slice's reduction on synthetic records: busy time is the
union of the device records, idle time is split by the innermost host
span, and the host's self time by span."""
import small  # noqa: F401  (puts portbench on the path)
from harness import trace


def _spans(items):
    s = trace.Spans()
    s.items = list(items)
    return s


def test_the_timeline_names_the_innermost_span():
    spans = _spans([("tick", 0, 100), ("plan", 10, 40),
                    ("factory", 20, 30), ("feedback", 60, 90)])
    assert spans.timeline(0, 120) == [
        ("tick", 0, 10), ("plan", 10, 20), ("factory", 20, 30),
        ("plan", 30, 40), ("tick", 40, 60), ("feedback", 60, 90),
        ("tick", 90, 100), ("harness", 100, 120)]


def test_busy_idle_and_host_time():
    spans = _spans([("tick", 0, 100), ("plan", 10, 40),
                    ("feedback", 60, 90)])
    records = [("k_a", 5, 20), ("k_b", 15, 30), ("k_a", 70, 80),
               ("k_c", 95, 130)]
    out = trace.summarize(records, spans, 0, 100, ["k_a"])
    assert round(out["busy_s"] * 1e9) == 25 + 10 + 5
    assert round(out["window_s"] * 1e9) == 100
    assert out["by_symbol"]["k_a"] == (25e-9, 2)
    idle = {n: round(v * 1e9) for n, v in out["idle_gaps"]}
    # idle: [0, 5) tick, [30, 40) plan, [40, 60) tick, [60, 70) and
    # [80, 90) feedback, [90, 95) tick
    assert idle == {"tick": 30, "plan": 10, "feedback": 20}
    host = {n: round(v * 1e9) for n, v in out["host_self_s"]}
    assert host == {"tick": 40, "plan": 30, "feedback": 30}
