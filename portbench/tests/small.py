"""A cell shrunk to the CPU for the harness's tests: the configuration's
rungs at 64 subcarriers, registered in the port's catalogue under names of
their own (as the port's own tests shrink a ladder), and a small mix."""
from __future__ import annotations

import copy
import dataclasses
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (BENCH, BENCH.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from harness import spec  # noqa: E402

SHRINK = dict(n_subcarriers=64, fft_size=64, n_taps=4, delay_spread=1.0)
MIX = {"cells": [{"name": "c0", "n_users": 3, "arrival_rate": 2.0,
                  "snr_db": 8.0},
                 {"name": "c1", "n_users": 3, "arrival_rate": 0.6,
                  "snr_db": 9.5}],
       "batch_size": 2, "max_batches_per_tick": 1, "deadline_ttis": 4,
       "max_retx": 2, "adapt": True, "target_bler": 0.1, "olla_step": 0.1,
       "arrival_seed": 5, "pool_payloads": 8, "warmup_ticks": 4, "trace_ticks": 4,
       "sample_jobs_per_rung": 10_000}


def register(config: dict, put) -> dict:
    """The configuration at 64 subcarriers, its rungs registered as a
    ladder of shrunk clones through ``put(table, key, value)`` into the
    port's catalogue (a test's ``monkeypatch.setitem``, which restores
    it); returns the shrunk configuration."""
    from repro_torch.phy import scenarios

    cfg = copy.deepcopy(config)
    cfg["grid"].update(SHRINK)
    names = []
    for r in cfg["rungs"]:
        s = scenarios.get_scenario(r["name"])
        r["name"] = "pb-" + r["name"]
        put(scenarios._REGISTRY, r["name"], s.replace(
            name=r["name"], grid=dataclasses.replace(s.grid, **SHRINK)))
        names.append(r["name"])
    cfg["ladder"] = "pb-" + cfg["ladder"]
    put(scenarios._LADDERS, cfg["ladder"],
        scenarios.MCSLadder(cfg["ladder"], tuple(names)))
    return cfg


def small_cell(name: str, monkeypatch, mix: dict = MIX) -> spec.Cell:
    """The configuration ``name`` shrunk and registered for one test."""
    config = spec.read_json(BENCH / "configs" / f"{name}.json")
    cfg = register(config, monkeypatch.setitem)
    return spec.make_cell(f"small-{name}", 1, cfg, copy.deepcopy(mix))
