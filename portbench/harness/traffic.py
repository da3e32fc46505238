"""The benchmark's traffic: device-resident pools of coded slots, drawn in
set-up, and the slot factory that serves views into them.

The closed loop asks its factory for each slot as
``factory(seed, scenario, 1, rv=..., info=...)``, where ``seed`` is the
integer the cell's stream drew and ``scenario`` the rung at the user's
SNR (and the cell's interferers).  One pool holds ``P`` slots of one
(rung, SNR, interferers, redundancy version), drawn in one batched call
of the frozen generator (:mod:`harness.generator`).  A new transmission
is entry ``seed % P`` of its RV-0 pool.  A retransmission carries the
payload of its first transmission: the ``info`` the loop hands back is a
view into an RV-0 pool, which names its entry ``p``, and the slot served
is entry ``p`` of the pool at the asked RV, the same payloads encoded at
that RV over a channel of their own.  The factory draws nothing, so the
timed window generates no slot.  The pools are drawn from the run's
seed, so each seed serves slots of its own.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from harness import generator
from harness.spec import Cell

BATCHED = ("y_time", "y", "x", "h", "bits", "info_bits", "rv")


def pool_key(rung_idx: int, snr_db: float, interferer_db: tuple,
             rv: int) -> tuple:
    return (rung_idx, float(snr_db), tuple(float(v) for v in interferer_db),
            int(rv))


@dataclasses.dataclass
class Pool:
    slots: dict  # the generator's batch-P slot dict

    def entry(self, p: int) -> dict:
        """Entry ``p`` as a batch-1 slot: views of the batched keys, the
        pool's side info shared."""
        return {k: (v[p:p + 1] if k in BATCHED else v)
                for k, v in self.slots.items()}


def cell_links(cell: Cell) -> set:
    """Every (SNR, interferers) a user of the mix can transmit at: each
    cell's SNR (users keep theirs through handover); a mix with an SNR
    spread or coupled cells has no finite set and is refused."""
    links = set()
    for c in cell.mix["cells"]:
        if c.get("snr_spread_db", 0.0) or c.get("coupling_db") is not None:
            raise ValueError("pooled traffic needs a fixed link a cell")
        links.add((float(c["snr_db"]), ()))
    return links


class SlotPools:
    """Every pool a run of ``cell`` can ask for, drawn from ``seed`` on
    ``device``, and the slot factory over them (``__call__``)."""

    def __init__(self, cell: Cell, seed: int, device, n_payloads: int):
        self.cell = cell
        self.P = int(n_payloads)
        self.max_rv = int(cell.mix["max_retx"])
        self.by_name = {r.name: i for i, r in enumerate(cell.rungs)}
        self.pools: dict = {}
        self._origin: dict = {}  # RV-0 info view's data_ptr -> (key, p)
        self._where: dict = {}  # an entry's y_time data_ptr -> (key, p)
        self.calls = 0
        self.spans = None  # a traced slice's trace.Spans, or None
        ss = np.random.SeedSequence(int(seed))
        links = sorted(cell_links(cell))
        for ri, rung in enumerate(cell.rungs):
            for snr, intf in links:
                link = rung.replace(snr_db=snr,
                                    interferer_db=rung.interferer_db + intf)
                info = None
                for rv in range(self.max_rv + 1):
                    state = ss.spawn(1)[0].generate_state(2, np.uint32)
                    gen = torch.Generator(device=device)
                    gen.manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)
                    slots = generator.make_coded_slot(
                        gen, link, self.P, rv=rv, info=info)
                    info = slots["info_bits"]
                    key = pool_key(ri, snr, link.interferer_db, rv)
                    self.pools[key] = Pool(slots)
        # every entry's views, made once: a call copies a dict of them
        self._entries = {key: [pool.entry(p) for p in range(self.P)]
                         for key, pool in self.pools.items()}
        for key, entries in self._entries.items():
            for p, entry in enumerate(entries):
                self._where[entry["y_time"].data_ptr()] = (key, p)
                if key[3] == 0:
                    self._origin[entry["info_bits"].data_ptr()] = (key, p)

    @property
    def device_bytes(self) -> int:
        return sum(v.numel() * v.element_size()
                   for pool in self.pools.values()
                   for v in pool.slots.values()
                   if isinstance(v, torch.Tensor))

    def __call__(self, seed: int, scenario, batch: int, *, rv=None,
                 info=None) -> dict:
        """The slot the loop asked for, as views into a pool.  Anything
        the pools cannot honour (a batch of several, an unpooled link or
        RV, an ``info`` that is not a pool's) raises."""
        if self.spans is not None:
            with self.spans.span("slot_factory"):
                return self._serve(seed, scenario, batch, rv, info)
        return self._serve(seed, scenario, batch, rv, info)

    def _serve(self, seed, scenario, batch, rv, info) -> dict:
        self.calls += 1
        if batch != 1:
            raise ValueError(f"the pools serve batch 1, not {batch}")
        if rv is None:
            raise ValueError("the closed loop stamps every slot's RV")
        ri = self.by_name[scenario.name]
        if info is None:
            if rv != 0:
                raise ValueError(f"a new transmission at RV {rv}")
            key = pool_key(ri, scenario.snr_db, scenario.interferer_db, 0)
            p = int(seed) % self.P
        else:
            key0, p = self._origin[info.data_ptr()]
            key = key0[:3] + (int(rv),)
            if key[:3] != pool_key(ri, scenario.snr_db,
                                   scenario.interferer_db, 0)[:3]:
                raise ValueError(f"a retransmission of {key0} as "
                                 f"{scenario.name} at {scenario.snr_db} dB")
        return dict(self._entries[key][p])

    def locate(self, slot: dict) -> tuple:
        """(pool key, entry) of a slot this factory served."""
        return self._where[slot["y_time"].data_ptr()]

    def origin(self, info) -> tuple:
        """(RV-0 pool key, entry) of the payloads ``info``, a view that a
        first transmission of this factory carried."""
        return self._origin[info.data_ptr()]
