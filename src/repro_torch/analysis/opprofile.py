"""Per-rank FLOPs, collective bytes and boundary bytes of a traced step
(the port's counterpart of :mod:`repro.analysis.hloparse`).

The reference reads its roofline terms off the compiled SPMD HLO text of
a step: ``dot`` FLOPs, the collectives GSPMD inserted, and the operand +
result bytes of every top-level op, each weighted by its enclosing
while-loop trip counts.  Torch has no HLO.  :func:`profile_step` runs the
step itself under a ``TorchDispatchMode`` that sits *below* DTensor: an op
with a DTensor argument is handed on (the mode returns ``NotImplemented``),
DTensor's dispatch runs the per-rank local ops and the functional
collectives its redistributions send, and the mode counts those.  So
every number is per device, as the reference's partitioned HLO shapes
are, and the collectives are the ones the port's own sharded step sends:
DTensor's sharding propagation decides them, not a re-derived model.

* FLOPs: each matmul / bmm / addmm / baddbmm (``dot_flops``) and
  convolution (``conv_flops``) local op, as ``torch.utils.flop_counter``
  counts it (2 x M x N x K for a product).
* Collectives: every ``_c10d_functional`` op with its operand bytes and
  group size, priced by the reference's ring formulas
  (``hloparse.py:305-322``): all-reduce 2(g-1)/g x operand, all-gather
  (g-1) x the local shard, reduce-scatter and all-to-all (g-1)/g x the
  operand, anything else the operand.  On a CPU mesh (gloo ranks, or the
  dry run's fake group) DTensor replaces a Shard -> Shard all-to-all by
  an all-gather and a chunk; :func:`profile_step` counts that all-gather
  as the all-to-all it stands for (operand: the local input), as an NCCL
  mesh would send it.
* ``boundary_bytes``: the input and output bytes of every local op that
  moves data (views and allocations skipped): the unfused upper bound of
  HBM traffic, as the reference's.
* ``peak_live_bytes`` (no counterpart in ``HloProfile``): the peak of the
  local bytes that the step's ops allocated and that are still
  referenced.  Each non-view output adds its bytes while a Python
  reference to it lives (``weakref.finalize``); a view that outlives its
  base tensor object is not counted, so this is a lower bound of an
  allocator's peak.  The dry run reports it as ``temp_bytes``.

DTensor's shape propagation runs each op once on fake tensors of the
global shapes; the mode skips those.  The reference's HLO-text machinery
(``parse_module``, ``_trip_count``, its regexes) has no counterpart by
design: there is no HLO, and the models' Python layer loops dispatch each
layer's ops, so no loop weighting is needed.

``collective_wire_bytes_f32`` is the share of the wire bytes carried in
fp32 payloads.  The reference halves it (``collective_wire_bytes_
bf16corr``) because XLA:CPU lowers bf16 dots in fp32 and places the TP
all-reduces on the fp32 outputs, which the TPU moves in bf16.  DTensor
moves every payload in its own dtype, the one the card would move, so
here the corrected bytes are the wire bytes: an fp32 payload is a real
fp32 payload (the fp32 router, fp32 gradients of fp32 parameters).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# the reference's collective names, by the functional op that stands for
# each (its ``*_coalesced`` forms included)
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}
# functional-collective plumbing that moves no data of its own
_PLUMBING = {"wait_tensor", "_wrap_tensor_autograd"}
# local ops that allocate or relabel without moving data
_NO_BYTES = {"empty", "empty_strided", "empty_like", "zeros", "detach",
             "lift_fresh", "alias", "_local_scalar_dense", "set_"}


@dataclasses.dataclass
class OpProfile:
    """:class:`repro.analysis.hloparse.HloProfile`'s fields and properties,
    counted from a traced step (per rank)."""
    dot_flops: float = 0.0
    conv_flops: float = 0.0
    collective_operand_bytes: float = 0.0
    collective_wire_bytes: float = 0.0
    collective_wire_bytes_f32: float = 0.0  # portion carried in f32 payloads
    boundary_bytes: float = 0.0
    collective_counts: dict = dataclasses.field(default_factory=dict)
    collective_bytes_by_op: dict = dataclasses.field(default_factory=dict)
    peak_live_bytes: float = 0.0

    @property
    def flops(self):
        return self.dot_flops + self.conv_flops

    @property
    def collective_wire_bytes_bf16corr(self) -> float:
        """The wire bytes: DTensor's payloads already carry the program's
        own dtypes (see the module docstring), so no fp32 share is
        halved."""
        return self.collective_wire_bytes


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name).size()


def _wire(kind: str, opb: float, g: int) -> float:
    """The reference's ring-algorithm bytes a device sends."""
    if kind == "all-reduce":
        return 2.0 * opb * (g - 1) / max(g, 1)
    if kind == "all-gather":
        return opb * (g - 1)  # operand is the local shard
    if kind in ("reduce-scatter", "all-to-all"):
        return opb * (g - 1) / max(g, 1)  # operand is the full buffer
    return opb


class _Counter(TorchDispatchMode):
    def __init__(self, prof: OpProfile):
        super().__init__()
        self.prof = prof
        self.alltoall = threading.local()  # set inside a CPU mesh fallback
        self.live = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def _allocated(self, out) -> None:
        for t in _tensors(out):
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._free, n)
        self.prof.peak_live_bytes = max(self.prof.peak_live_bytes, self.live)

    def _collective(self, kind: str, args, kwargs) -> None:
        ins = _tensors(args[0] if args else ())
        opb = float(sum(_nbytes(x) for x in ins))
        group = kwargs.get("group_name", args[-1] if args else None)
        g = _group_size(group) if isinstance(group, str) else 1
        pending = getattr(self.alltoall, "input", None)
        if kind == "all-gather" and pending is not None:
            # a CPU mesh's all-to-all fallback: price the all-to-all
            kind, opb = "all-to-all", float(_nbytes(pending))
            self.alltoall.input = None
        wire = _wire(kind, opb, g)
        p = self.prof
        p.collective_operand_bytes += opb
        p.collective_wire_bytes += wire
        if any(x.dtype == torch.float32 for x in ins):
            p.collective_wire_bytes_f32 += wire
        p.collective_counts[kind] = p.collective_counts.get(kind, 0) + 1
        p.collective_bytes_by_op[kind] = (
            p.collective_bytes_by_op.get(kind, 0.0) + opb)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        flat = _tensors((args, kwargs))
        if any(isinstance(x, DTensor) for x in flat):
            return NotImplemented  # DTensor dispatches the local ops
        out = func(*args, **kwargs)
        if any(isinstance(x, FakeTensor) for x in flat + _tensors(out)):
            return out  # DTensor's global-shape propagation
        packet = func.overloadpacket
        name = packet.__name__
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d_functional", "_dtensor"):
            if name in _COLLECTIVES:
                self._collective(_COLLECTIVES[name], args, kwargs)
                self._allocated(out)
            return out
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            if "conv" in name:
                self.prof.conv_flops += n
            else:
                self.prof.dot_flops += n
        if not (func.is_view or name in _NO_BYTES or name in _PLUMBING):
            self.prof.boundary_bytes += sum(
                _nbytes(x) for x in flat + _tensors(out))
        if not func.is_view:
            self._allocated(out)
        return out


@contextlib.contextmanager
def _price_cpu_alltoall(counter: _Counter):
    """Mark the all-gather of DTensor's CPU all-to-all fallback (the
    function is patched for the duration of the profile only)."""
    try:
        from torch.distributed.tensor import placement_types as pt
    except ImportError:
        yield
        return
    real = getattr(pt, "shard_dim_alltoall", None)
    if real is None:
        yield
        return

    def marked(input, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type == "cpu":
            counter.alltoall.input = input
        try:
            return real(input, gather_dim, shard_dim, mesh, mesh_dim)
        finally:
            counter.alltoall.input = None

    pt.shard_dim_alltoall = marked
    try:
        yield
    finally:
        pt.shard_dim_alltoall = real


def profile_step(fn: Callable, *args, **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` once and count its per-rank work.
    Returns ``(OpProfile, fn's result)``."""
    prof = OpProfile()
    counter = _Counter(prof)
    with _price_cpu_alltoall(counter), counter:
        out = fn(*args, **kwargs)
    return prof, out
