"""Executable registry: every captured serving step, owned in one place
(port of :mod:`repro.serve.exec_registry`).

The reference compiles each serving step ahead of time so that no tick
pays for a JIT stall.  On the card the cost to remove is another one: an
eager receive step makes a few hundred launches from Python, and the
device idles while the host makes them.  So each step here is a CUDA
graph of the pipeline's whole receive chain, captured once per
(rung, slot schema) before the first TTI and replayed per batch.

* :class:`ExecKey` — one hashable identity per step: (scenario, receiver
  variant, precision, slot batch, lane bucket, backend, donation, slot
  schema), the reference's fields; ``backend`` is the pipeline's device
  type (``"cuda"`` or ``"cpu"``), or, for a step of one entry of a
  several-entry cell mesh, that entry's device and place (one step per
  (group, rung, lane bucket, grid entry)).
* Mesh steps (``lanes > 0``, :func:`lane_step`): the port's counterpart of
  the reference's ``vmap(pipeline._apply)``.  A staged ``(lanes, batch,
  ...)`` batch is viewed as ``(lanes * batch, ...)``, so the lanes fold
  into the kernels' batch axis, with ``noise_var`` one value per lane;
  ``pipeline.run`` serves it, and the batched outputs are viewed back as
  ``(lanes, batch, ...)``.  It is captured as one CUDA graph like a
  single-cell step.
* :class:`CapturedStep` — the step itself.  It owns static input tensors
  of the example batch's keys, shapes and dtypes (the batched keys and the
  scenario side info such as ``noise_var`` alike).  On CUDA it runs the
  step once eagerly on a side stream (building the kernels, setting each
  launcher's shared-memory attribute, filling the per-device constant
  caches and creating the cuFFT plans), then captures it over the static
  inputs into a private memory pool.  A call copies the live batch into
  the static inputs, replays the graph and returns its output dict.  On the
  CPU there is no graph: the same staging runs, then the eager chain over
  the static inputs, so the staging, key checks and accounting run in the
  CPU tests.  A capture that fails raises; nothing falls back to eager
  serving on CUDA.  The kernels' launch choices (their ``pick_*``: a
  winner of :mod:`repro_torch.kernels.tune`, else the static heuristic)
  are resolved when the step is captured and baked into its graph, as
  the reference's jit resolves its tuned block shapes at trace time; a
  winner stored later takes effect at the next capture.
* :class:`ExecRegistry` — an LRU-bounded map ``ExecKey -> CapturedStep``
  with the reference's accounting: ``compile_time_s`` is warm-up plus
  capture wall time, ``executables_compiled`` counts captures,
  ``cache_hits`` in-memory re-acquires.  An evicted step drops its graph
  and pool.
* :class:`BucketPolicy` and its three policies, and the template builders
  (:func:`template_slot`, :func:`template_batch`), pure Python as in the
  reference; templates are drawn by :class:`TorchSlotFactory` from a
  fixed seed and stacked by the runtime's own :func:`stack_slots`.

There is no persistent cache, so the reference's ``default_cache_dir``,
``enable_persistent_cache`` and ``disable_persistent_cache`` have no
counterpart: a CUDA graph cannot outlive its process, and the kernels'
own build cache (``build/repro_torch_kernels/``) already persists across
processes.

Launch accounting: the kernel wrappers count a launch in
:data:`repro_torch.kernels._build.launches` when Python calls them, which
a capture does once and a replay never does.  A capture therefore takes
its own counts back out (it launched nothing) and each replay adds them
again, so the counts stay the kernels' executions.  The eager warm-up
before a capture did run its kernels once, and those counts stay
(:attr:`CapturedStep.warmup_launches`): a step captured in the middle of
a run, such as a supervisor's degradation step, adds them to that run.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Callable, Optional

import numpy as np
import torch

__all__ = [
    "BucketPolicy", "CapturedStep", "CostModelBuckets", "ExecKey",
    "ExecRegistry", "ExecStats", "FixedBuckets", "PowerOfTwoBuckets",
    "exec_key_for", "get_registry", "lane_step",
    "set_registry", "slot_schema", "template_batch", "template_slot",
]


# ---------------------------------------------------------------------------
# Keys and stats
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExecKey:
    """Stable identity of one captured serving step.

    ``lanes == 0`` is a single-cell step; ``lanes > 0`` a mesh step over
    that lane bucket (its share of it, on a grid: ``backend`` then names
    the entry's device and place, ``cuda:0/1,0``).  ``variant``
    fingerprints the pipeline beyond its display name (stage structure +
    neural-weight digest); ``schema`` names the slot's batched keys, so
    open-loop and HARQ slots capture separately.
    """
    scenario: str
    receiver: str
    precision: str
    batch: int
    lanes: int
    backend: str
    variant: str = ""
    donate: bool = False
    schema: str = ""

    def __str__(self) -> str:
        return "|".join((
            self.scenario, self.receiver, self.precision,
            f"b{self.batch}", f"l{self.lanes}", self.backend,
            self.variant, "donate" if self.donate else "keep", self.schema,
        ))


@dataclasses.dataclass
class ExecStats:
    """Per-engine capture accounting (one accumulator per serve frontend):
    ``executables_compiled`` counts captures, ``cache_hits`` in-memory
    re-acquires, ``compile_time_s`` the warm-up plus capture wall time."""
    compile_time_s: float = 0.0
    executables_compiled: int = 0
    cache_hits: int = 0

    def add(self, compile_s: float, compiled: bool, hit: bool) -> None:
        self.compile_time_s += compile_s
        self.executables_compiled += int(compiled)
        self.cache_hits += int(hit)

    def merge(self, other: "ExecStats") -> "ExecStats":
        self.compile_time_s += other.compile_time_s
        self.executables_compiled += other.executables_compiled
        self.cache_hits += other.cache_hits
        return self

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def slot_schema(slot: dict) -> str:
    """Compact structural tag of a slot batch: its batched keys (open-loop
    slots vs HARQ slots carrying ``rv`` + ``prior_llr``)."""
    from repro_torch.serve.runtime import BATCHED_KEYS

    return "+".join(k for k in BATCHED_KEYS if k in slot)


def _pipeline_variant(pipeline) -> str:
    """Stage-structure + params fingerprint (cached on the pipeline): the
    reference's, the leaves in its flatten order."""
    v = getattr(pipeline, "_exec_variant", None)
    if v is None:
        from repro_torch.common.params import tree_leaves

        parts = [st.name for st in pipeline.stages]
        if pipeline.params is not None:
            h = hashlib.blake2b(digest_size=8)
            for leaf in tree_leaves(pipeline.params):
                a = np.asarray(leaf.detach().cpu())
                h.update(str(a.shape).encode())
                h.update(str(a.dtype).encode())
                h.update(a.tobytes())
            parts.append(h.hexdigest())
        v = hashlib.blake2b(
            "/".join(parts).encode(), digest_size=8
        ).hexdigest()
        pipeline._exec_variant = v
    return v


def exec_key_for(pipeline, batch: int, *, lanes: int = 0,
                 donate: bool = False, schema: str = "",
                 backend: Optional[str] = None,
                 entry: Optional[tuple] = None) -> ExecKey:
    """The :class:`ExecKey` of ``pipeline``'s step at (batch, lanes); with
    ``entry``, the step of that ``(row, column)`` of a grid of several
    entries, one per entry even where two share a device."""
    if entry is not None:
        backend = f"{pipeline.device}/{entry[0]},{entry[1]}"
    return ExecKey(
        scenario=pipeline.scenario.name,
        receiver=pipeline.name,
        precision=pipeline.precision,
        batch=int(batch),
        lanes=int(lanes),
        backend=backend or pipeline.device.type,
        variant=_pipeline_variant(pipeline),
        donate=bool(donate),
        schema=schema,
    )


# ---------------------------------------------------------------------------
# Templates: deterministic example inputs for ahead-of-time capture
# ---------------------------------------------------------------------------

def template_slot(scenario, *, harq: bool = False, device=None) -> dict:
    """One batch-1 example slot of ``scenario`` on ``device`` (None ->
    CUDA), drawn from seed 0 (values are irrelevant to the capture; keys,
    shapes and dtypes are everything).

    ``harq=True`` builds the closed-loop schema: a coded slot at RV 0 with
    the zeroed combining-LLR prior riding along, exactly as
    :meth:`repro_torch.serve.runtime.CellLoop.make_slot` stages it.
    """
    from repro_torch.phy import coding
    from repro_torch.serve.runtime import TorchSlotFactory

    factory = TorchSlotFactory(device)
    if not harq:
        gen = torch.Generator(device=factory.device)
        gen.manual_seed(0)
        return scenario.make_batch(gen, 1)
    if scenario.code is None:
        raise ValueError(f"{scenario.name}: HARQ templates need a coded "
                         "scenario")
    slot = factory(0, scenario, 1, rv=0)
    slot["prior_llr"] = np.zeros(
        (1, coding.codewords_per_slot(scenario), scenario.code.n_mother),
        np.float32,
    )
    return slot


def template_batch(scenario, batch: int, *, harq: bool = False,
                   device=None) -> dict:
    """A stacked ``batch``-slot example, through the runtime's own
    :func:`~repro_torch.serve.runtime.stack_slots`, so its keys, shapes
    and dtypes are those of a served batch."""
    from repro_torch.serve.runtime import stack_slots

    return stack_slots(
        [template_slot(scenario, harq=harq, device=device)], batch - 1)


# ---------------------------------------------------------------------------
# Batch-bucketing policies
# ---------------------------------------------------------------------------

class BucketPolicy:
    """Maps a dynamic lane/batch count onto one registered static bucket.

    The contract every policy keeps: ``bucket_for(n) >= n`` for every n it
    accepts, and the image of ``bucket_for`` over ``1..max_n`` is exactly
    ``buckets(max_n)`` — so an engine that captures ``buckets(max_n)``
    never captures at dispatch time.
    """

    def bucket_for(self, n: int) -> int:
        raise NotImplementedError

    def buckets(self, max_n: int) -> tuple:
        """Every bucket 1..max_n maps onto (the capture set)."""
        return tuple(sorted({
            self.bucket_for(n) for n in range(1, max(int(max_n), 1) + 1)
        }))


class PowerOfTwoBuckets(BucketPolicy):
    """Doubling buckets from ``base`` — at most log2 step shapes."""

    def __init__(self, base: int = 1):
        self.base = max(int(base), 1)

    def bucket_for(self, n: int) -> int:
        if n < 1:
            raise ValueError(f"lane count must be >= 1, got {n}")
        b = self.base
        while b < n:
            b *= 2
        return b

    def __repr__(self) -> str:
        return f"PowerOfTwoBuckets(base={self.base})"


class FixedBuckets(BucketPolicy):
    """An explicit ascending bucket set; counts above the top are an
    error (the operator declared the capacity envelope)."""

    def __init__(self, sizes):
        self.sizes = tuple(sorted({int(s) for s in sizes}))
        if not self.sizes or self.sizes[0] < 1:
            raise ValueError(f"invalid bucket sizes {sizes!r}")

    def bucket_for(self, n: int) -> int:
        if n < 1:
            raise ValueError(f"lane count must be >= 1, got {n}")
        for s in self.sizes:
            if s >= n:
                return s
        raise ValueError(
            f"lane count {n} exceeds the largest bucket {self.sizes[-1]} "
            f"of {self!r}"
        )

    def __repr__(self) -> str:
        return f"{type(self).__name__}(sizes={self.sizes})"


class CostModelBuckets(FixedBuckets):
    """Bucket set chosen by a padded-cost model over a lane-count profile.

    Dynamic-programming partition of ``1..max_n``: each bucket ``b``
    serves every count in its span at cost ``b`` lanes (padding included),
    weighted by ``weights[n-1]`` (expected frequency of count ``n``,
    uniform by default), plus ``compile_cost`` per registered bucket (the
    capture-time/registry-capacity price of one more step shape).  Small
    ``compile_cost`` approaches one bucket per count; large approaches a
    single max-size bucket.  ``quantum`` constrains buckets to multiples.
    """

    def __init__(self, max_n: int, *, weights=None,
                 compile_cost: float = 4.0, quantum: int = 1):
        max_n = int(max_n)
        quantum = max(int(quantum), 1)
        if max_n < 1:
            raise ValueError(f"max_n must be >= 1, got {max_n}")
        if weights is None:
            weights = [1.0] * max_n
        weights = [float(w) for w in weights]
        if len(weights) != max_n:
            raise ValueError(
                f"weights has {len(weights)} entries for max_n={max_n}"
            )
        # candidate bucket boundaries: multiples of the quantum
        cands = list(range(quantum, max_n + quantum, quantum))
        # prefix[i] = total weight of counts 1..i
        prefix = [0.0] * (max_n + 1)
        for n in range(1, max_n + 1):
            prefix[n] = prefix[n - 1] + weights[n - 1]
        # best[i] = (cost, chosen buckets) covering counts 1..cands[i]
        best: list = []
        for i, b in enumerate(cands):
            # bucket b alone covers 1..b
            choice = (compile_cost + b * prefix[min(b, max_n)], (b,))
            for j in range(i):
                span_w = (prefix[min(b, max_n)]
                          - prefix[min(cands[j], max_n)])
                c = best[j][0] + compile_cost + b * span_w
                if c < choice[0]:
                    choice = (c, best[j][1] + (b,))
            best.append(choice)
        super().__init__(best[-1][1])
        self.max_n = max_n
        self.quantum = quantum


# ---------------------------------------------------------------------------
# The captured step
# ---------------------------------------------------------------------------

def lane_step(pipeline, lanes: int, batch: int) -> Callable[[dict], dict]:
    """``pipeline.run`` over a staged ``(lanes, batch, ...)`` batch, the
    lanes folded into the batch axis: the batched keys are viewed as
    ``(lanes * batch, ...)``, ``noise_var`` holds ``lanes`` values (or
    one), the other side info is the lanes' common value; every output
    that is not such an input is viewed back as ``(lanes, batch, ...)``."""
    from repro_torch.serve.runtime import BATCHED_KEYS

    rows = lanes * batch

    def step(staged: dict) -> dict:
        state, side = {}, set()
        for k, v in staged.items():
            if k in BATCHED_KEYS:
                if tuple(v.shape[:2]) != (lanes, batch):
                    raise ValueError(f"{k!r}: {tuple(v.shape)} is not a "
                                     f"({lanes}, {batch}, ...) lane stack")
                state[k] = v.reshape(rows, *v.shape[2:])
            else:
                state[k] = v
                side.add(k)
        nv = staged.get("noise_var")
        if nv is not None and torch.as_tensor(nv).numel() not in (1, lanes):
            raise ValueError(f"noise_var holds {torch.as_tensor(nv).numel()}"
                             f" values for {lanes} lanes")
        out = pipeline.run(state)
        return {k: (v.reshape(lanes, batch, *v.shape[1:])
                    if k not in side and isinstance(v, torch.Tensor)
                    else v)
                for k, v in out.items()}

    return step


def _shapes(example: dict) -> tuple:
    """The example's tensors' and arrays' (key, shape, dtype).  Steps of
    one key whose examples differ here are separate entries: a scenario's
    name, which the key holds, does not fix its grid, and a registry
    shared by a process may meet a shrunk copy of a registered
    scenario."""
    return tuple(sorted(
        (k, tuple(v.shape), str(v.dtype)) for k, v in example.items()
        if isinstance(v, (torch.Tensor, np.ndarray))))


def _spec(batch: dict) -> dict:
    """What a batch must share with the capture: per key, a tensor's
    (shape, dtype), or a non-tensor value itself (an array by its bytes)."""
    def one(v):
        if isinstance(v, torch.Tensor):
            return ("tensor", tuple(v.shape), v.dtype)
        if isinstance(v, np.ndarray):
            return ("array", v.shape, v.dtype.str, v.tobytes())
        return ("value", v)

    return {k: one(v) for k, v in batch.items()}


class CapturedStep:
    """``fn`` (a pipeline's ``run``: batch dict -> state dict) over static
    input tensors shaped like ``example``: a CUDA graph when the example's
    tensors lie on a CUDA device, the eager ``fn`` over the same static
    inputs on the CPU.

    A call stages the live batch into the static inputs with ``copy_``
    and returns the step's output dict.  On CUDA that dict holds the
    graph's static outputs: they are valid until this step's next call,
    which overwrites them in place.
    """

    def __init__(self, fn: Callable[[dict], dict], example: dict):
        from repro_torch.kernels import _build

        self.fn = fn
        self.spec = _spec(example)
        self.static = {
            k: (v.detach().clone() if isinstance(v, torch.Tensor) else v)
            for k, v in example.items()
        }
        self._tensor_keys = tuple(
            k for k, v in example.items() if isinstance(v, torch.Tensor))
        devices = {self.static[k].device for k in self._tensor_keys}
        if len(devices) != 1:
            raise ValueError(f"example tensors on {sorted(map(str, devices))}"
                             ": a step takes one device")
        self.device = devices.pop()
        self.graph = None
        self.pool = None
        self.out = None
        self.launch_delta: collections.Counter = collections.Counter()
        # the launches of the eager warm-up, which ran its kernels once
        self.warmup_launches: collections.Counter = collections.Counter()
        self.replays = 0
        if self.device.type != "cuda":
            return
        dev = self.device
        # warm-up outside capture: builds the kernels, sets the launchers'
        # shared-memory attributes, fills the per-device constant caches
        # and creates the cuFFT plans and library workspaces
        before = collections.Counter(_build.launches)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(self.static)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.warmup_launches = _build.launches - before
        before = collections.Counter(_build.launches)
        self.pool = torch.cuda.graph_pool_handle()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), \
                torch.cuda.graph(self.graph, pool=self.pool):
            self.out = fn(self.static)
        torch.cuda.synchronize(dev)
        # the capture recorded these launches without running them; each
        # replay runs them once
        self.launch_delta = _build.launches - before
        _build.launches.subtract(self.launch_delta)
        _build.launches += collections.Counter()  # drop the zero counts

    def check(self, batch: dict) -> None:
        """Raise unless ``batch`` has the capture's keys, tensor shapes and
        dtypes, and non-tensor values."""
        got = _spec(batch)
        if sorted(got) != sorted(self.spec):
            raise ValueError(
                f"batch keys {sorted(got)} differ from the captured step's "
                f"{sorted(self.spec)}")
        for k, want in self.spec.items():
            if got[k] != want:
                raise ValueError(f"batch key {k!r}: {got[k][1:]} differs "
                                 f"from the captured step's {want[1:]}")

    def __call__(self, batch: dict) -> dict:
        self.check(batch)
        for k in self._tensor_keys:
            self.static[k].copy_(batch[k])
        return self.replay()

    def replay(self) -> dict:
        """Run the step over its static inputs as they stand: a caller
        that writes ``static`` in place itself stages nothing."""
        self.replays += 1
        if self.graph is None:
            return self.fn(self.static)
        from repro_torch.kernels import _build

        self.graph.replay()
        _build.launches.update(self.launch_delta)
        return dict(self.out)

    def close(self) -> None:
        """Drop the graph, its pool and the static tensors."""
        self.graph = self.pool = self.out = None
        self.static = {}


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

class ExecRegistry:
    """LRU-bounded map of :class:`ExecKey` -> :class:`CapturedStep`
    (one a key and example shape set: :func:`_shapes`).

    ``capacity`` bounds resident steps (None = unbounded);
    least-recently-acquired entries evict first and drop their graphs.
    """

    def __init__(self, *, capacity: Optional[int] = None):
        self.capacity = capacity
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self.stats = ExecStats()  # registry-wide accounting
        self.lookups = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: ExecKey) -> bool:
        return any(k == key for k, _ in self._entries)

    def keys(self) -> list:
        return [k for k, _ in self._entries]

    # -- acquisition ------------------------------------------------------
    def acquire(self, key: ExecKey, fn: Callable[[dict], dict],
                example: dict, *, stats: Optional[ExecStats] = None
                ) -> CapturedStep:
        """The captured step for ``key``, capturing ``fn`` over
        ``example`` (a batch built by the dispatch path's own staging
        code) if absent.  Capture happens here, ahead of the timed serving
        window; a replay never captures."""
        self.lookups += 1
        entry = (key, _shapes(example))
        step = self._entries.get(entry)
        if step is not None:
            self._entries.move_to_end(entry)
            self.stats.add(0.0, False, True)
            if stats is not None:
                stats.add(0.0, False, True)
            return step
        t0 = time.perf_counter()
        step = CapturedStep(fn, example)
        dt = time.perf_counter() - t0
        self.stats.add(dt, True, False)
        if stats is not None:
            stats.add(dt, True, False)
        self._entries[entry] = step
        while (self.capacity is not None
               and len(self._entries) > self.capacity):
            _, old = self._entries.popitem(last=False)
            old.close()
            self.evictions += 1
        return step

    def acquire_pipeline_step(self, pipeline, example: dict, *, batch: int,
                              lanes: int = 0,
                              stats: Optional[ExecStats] = None,
                              entry: Optional[tuple] = None
                              ) -> CapturedStep:
        """Acquire ``pipeline``'s serving step over ``example``.

        ``lanes == 0`` captures the single-cell step (``pipeline.run``
        over a stacked batch); ``lanes > 0`` the mesh step
        (:func:`lane_step` over a staged ``(lanes, batch, ...)`` batch),
        ``entry`` naming its place on a grid of several entries.  The
        key's ``donate`` follows the reference's rule, true for a mesh
        step off the CPU; the static inputs never alias the caller's
        batch, so it names the step and changes nothing else."""
        donate = lanes > 0 and pipeline.device.type != "cpu"
        key = exec_key_for(pipeline, batch, lanes=lanes, donate=donate,
                           schema=slot_schema(example), entry=entry)
        fn = lane_step(pipeline, lanes, batch) if lanes else pipeline.run
        return self.acquire(key, fn, example, stats=stats)

    # -- reporting --------------------------------------------------------
    def report(self) -> dict:
        return {
            "resident": len(self._entries),
            "lookups": self.lookups,
            "evictions": self.evictions,
            **self.stats.as_dict(),
        }


_DEFAULT: Optional[ExecRegistry] = None


def get_registry() -> ExecRegistry:
    """The process-wide default registry (shared across every engine)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = ExecRegistry()
    return _DEFAULT


def set_registry(reg: Optional[ExecRegistry]) -> None:
    """Install (or with ``None`` drop) the process-wide registry."""
    global _DEFAULT
    _DEFAULT = reg
