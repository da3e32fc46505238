"""Deterministic, seeded fault injection for the serving stack (port of
:mod:`repro.serve.faults`).

A carrier-grade runtime is validated by *injecting* the failures it must
survive (numerics corruption, crashed steps, stragglers, dead cells), not
by waiting for them.  This module is the injection side of the fault
layer; :mod:`repro_torch.serve.supervisor` is the handling side:

* :class:`FaultEvent`: one scheduled fault: a kind, the TTI tick it fires
  on, the bucket sequence index within that tick (``seq``; step buckets
  are served in sorted (group, rung) order, so ``seq`` addresses a
  concrete captured step), an optional target cell, and a magnitude
  (straggler seconds).
* :class:`FaultPlan`: an immutable schedule of events.  Build one
  explicitly for targeted tests, or with :meth:`FaultPlan.seeded` for
  reproducible randomized schedules: the sampling draws from
  :func:`repro_torch.serve.runtime.cell_rng` (numpy PCG64 seeded as the
  reference seeds it), so a plan is a pure function of ``(seed, n_ticks,
  n_cells, rates)`` and equal arguments give the reference's events.
* :class:`FaultInjector`: consumes a plan during a run.  Events are
  **one-shot**: the supervisor's retry and fallback paths re-stage clean
  inputs and the consumed event does not fire again, which models
  transient faults (bit flips in staged DMA buffers, a killed step) as
  opposed to deterministic bugs.  Every consumed event is counted per
  kind in :attr:`FaultInjector.injected`.

Fault kinds
-----------
``nan_llr``
    NaN burst into the staged combining-LLR prior of one lane: the
    classic soft-buffer corruption; it propagates to non-finite combined
    LLRs and must be caught by the supervisor's non-finite guard.
``corrupt_slot``
    Inf corruption of one lane's staged receive tensor (``y_time``/``y``):
    DMA corruption on the host -> device path.
``step_error``
    The captured step raises (:class:`InjectedFault`), a runtime failure.
    Schedule several events at the same ``(tick, seq)`` to escalate past
    the supervisor's bounded retries.
``straggler``
    ``magnitude`` seconds of extra latency inside the timed step window:
    a slow device or host hop; drives the supervisor's per-TTI watchdog.
``cell_crash``
    Drop cell ``cell``'s entire in-flight :class:`CellLoop` state at the
    start of tick ``tick``: the supervisor must recover it from the last
    checkpoint and reconcile job accounting exactly.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

from repro_torch.serve.runtime import cell_rng

FAULT_KINDS = (
    "nan_llr", "corrupt_slot", "step_error", "straggler", "cell_crash"
)

# fault kinds applied to the staged batch before the step runs
STAGE_KINDS = ("nan_llr", "corrupt_slot")

# the (seed, cell) stream index FaultPlan.seeded draws from: far outside
# any real cell index so fault schedules never alias traffic streams
_PLAN_STREAM = 0xFA017


class InjectedFault(RuntimeError):
    """Raised at the step's call site by a ``step_error`` event."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault (see the module docstring for the kinds)."""
    kind: str
    tick: int
    seq: int = 0
    cell: Optional[int] = None
    magnitude: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; have {FAULT_KINDS}"
            )


class FaultPlan:
    """An immutable, reproducible schedule of :class:`FaultEvent`."""

    def __init__(self, events=()):
        self.events = tuple(
            sorted(events, key=lambda e: (e.tick, e.seq, e.kind))
        )

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def __repr__(self) -> str:
        kinds = collections.Counter(e.kind for e in self.events)
        body = ", ".join(f"{k}={n}" for k, n in sorted(kinds.items()))
        return f"FaultPlan({len(self.events)} events: {body})"

    @classmethod
    def none(cls) -> "FaultPlan":
        """The empty plan: a supervised run under it must be field for
        field identical to an unsupervised run."""
        return cls()

    @classmethod
    def seeded(cls, seed: int, n_ticks: int, n_cells: int,
               rates: Optional[dict] = None, *,
               straggler_s: float = 0.005, max_crashes: int = 1,
               max_seq: int = 4) -> "FaultPlan":
        """Sample a reproducible schedule: per tick and kind, one event
        fires with probability ``rates[kind]`` (default 0), targeting a
        uniform cell and bucket ``seq`` in ``[0, max_seq)``.  At most
        ``max_crashes`` cell crashes are scheduled.  The draw order is
        fixed (tick-major, kinds sorted, three draws per (tick, kind)
        whether it fires or not), so equal arguments give the same plan.
        """
        rates = dict(rates or {})
        unknown = set(rates) - set(FAULT_KINDS)
        if unknown:
            raise ValueError(
                f"unknown fault kinds in rates: {sorted(unknown)}"
            )
        rng = cell_rng(seed, _PLAN_STREAM)
        events, crashes = [], 0
        for tick in range(n_ticks):
            for kind in sorted(FAULT_KINDS):
                p = float(rates.get(kind, 0.0))
                # draw unconditionally so the stream position (and thus
                # every other event) is invariant to individual rates
                hit = rng.random() < p
                seq = int(rng.integers(0, max(max_seq, 1)))
                cell = int(rng.integers(0, max(n_cells, 1)))
                if not hit:
                    continue
                if kind == "cell_crash":
                    if crashes >= max_crashes:
                        continue
                    crashes += 1
                events.append(FaultEvent(
                    kind=kind, tick=tick, seq=seq, cell=cell,
                    magnitude=straggler_s if kind == "straggler" else 0.0,
                ))
        return cls(events)


class FaultInjector:
    """Consume a :class:`FaultPlan` during one run (events are one-shot).

    The supervisor polls it at three points: cell crashes at tick start
    (:meth:`crashes`), staged-tensor corruption and straggler latency per
    step bucket (:meth:`stage_events` / :meth:`straggle_s`), and step
    exceptions per dispatch attempt (:meth:`step_error`, which consumes
    **one** event per call, so stacked events escalate through the retry
    budget).
    """

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan if plan is not None else FaultPlan.none()
        self._pending: list = list(self.plan.events)
        self.injected: collections.Counter = collections.Counter()

    @property
    def total(self) -> int:
        """Events consumed (actually injected) so far."""
        return int(sum(self.injected.values()))

    @property
    def pending(self) -> int:
        return len(self._pending)

    def _take(self, pred, limit: Optional[int] = None) -> list:
        hit = [e for e in self._pending if pred(e)]
        if limit is not None:
            hit = hit[:limit]
        for e in hit:
            self._pending.remove(e)
            self.injected[e.kind] += 1
        return hit

    def crashes(self, tick: int) -> list:
        """Cell indices crashing at the start of ``tick``."""
        return [
            e.cell for e in self._take(
                lambda e: e.kind == "cell_crash" and e.tick == tick
            )
            if e.cell is not None
        ]

    def stage_events(self, tick: int, seq: int) -> list:
        """Staged-tensor corruptions for step bucket ``(tick, seq)``."""
        return self._take(
            lambda e: e.kind in STAGE_KINDS
            and e.tick == tick and e.seq == seq
        )

    def straggle_s(self, tick: int, seq: int) -> float:
        """Total straggler seconds to add inside ``(tick, seq)``'s timed
        step window."""
        return float(sum(
            e.magnitude for e in self._take(
                lambda e: e.kind == "straggler"
                and e.tick == tick and e.seq == seq
            )
        ))

    def step_error(self, tick: int, seq: int) -> Optional[FaultEvent]:
        """Consume one pending ``step_error`` for ``(tick, seq)``, if any
        (called once per dispatch attempt: stacked events outlast the
        retry budget)."""
        hit = self._take(
            lambda e: e.kind == "step_error"
            and e.tick == tick and e.seq == seq,
            limit=1,
        )
        return hit[0] if hit else None
