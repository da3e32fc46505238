"""One run of one cell, printed to the benchmark's contract.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Loads ``BENCHMARK.json``'s workload, its configuration and its mix,
refuses to run without the CUDA cards the cell asks for, hands the cell
to its configuration's driver (``portbench/drivers/<driver>.py``), reads
the cell's metrics (``portbench/metrics/<name>.py``: with ``--trace 0``
its end-to-end metrics, with ``--trace 1`` its per-layer ones), and
prints one JSON line last on standard output.  The numbers the
comparison judged, each beside its limit, are the last lines on standard
error and the last key of that line.  ``--control`` puts the reference
in its lower precision in the program's place (for the control runs; no
run of the benchmark passes it).
"""
from __future__ import annotations

import argparse
import json
import sys

from harness import arith, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the process may not hold."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def metrics_of(bench: dict, workload: str, traced: bool) -> list:
    """The entries of ``BENCHMARK.json`` a run of ``workload`` reports."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


def read_metrics(entries: list, run) -> dict:
    out = {}
    for m in entries:
        value = arith.load("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(run, entries: list, device: dict) -> dict:
    out = {
        "correct": run.verdict["correct"],
        "attempted": run.window["slots"],
        "failed": 0,
        "metrics": read_metrics(entries, run),
        "device": device,
    }
    if run.slice is not None:
        out["breakdown"] = {"device_ops": run.slice["device_ops"],
                            "idle_gaps": run.slice["idle_gaps"]}
    out["compared"] = run.verdict["compared"]
    return out


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = spec.read_json(spec.ROOT / "BENCHMARK.json")
    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    driver = arith.load("drivers", cell.config["driver"])
    run = driver.run(cell, seed=args.seed, seconds=args.seconds,
                     traced=bool(args.trace), device="cuda:0",
                     t_start=t_start, control=args.control)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.slice is not None:
        device.update(busy_s=run.slice["busy_s"],
                      window_s=run.slice["window_s"])
    line = result_line(run, metrics_of(bench, args.workload,
                                       bool(args.trace)), device)
    found = loaded_forbidden()
    if found:
        print(f"the process holds {found} after the window", file=sys.stderr)
        return 3
    w = run.window
    fifths = [(len(w["tick_s"]) * i) // 5 for i in range(6)]
    print(json.dumps({"setup": run.notes, "window_s": w["wall_s"],
                      "fifths_slots_a_tick": [
                          sum(w["served"][a:b]) / max(b - a, 1)
                          for a, b in zip(fifths, fifths[1:])],
                      "fifths_ms_a_tick": [
                          1e3 * sum(w["tick_s"][a:b]) / max(b - a, 1)
                          for a, b in zip(fifths, fifths[1:])],
                      "ticks": w["ticks"], "steps": w["steps"],
                      "step_s": w["step_s"],
                      "compared_jobs": run.verdict["jobs"],
                      "compared_slots": run.verdict["slots"],
                      "compared_codewords": run.verdict["codewords"]}),
          file=sys.stderr)
    for k, v in run.verdict["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
