"""The comparison that decides ``correct``.

Each sampled job is followed through its transmissions in the window by
the configuration's plain reference (``portbench/reference/<name>.py``),
on its own: transmission ``k`` (RV ``k``) is the pool entry of the job's
payloads at that RV, and its HARQ prior is the reference's own combined
buffer of transmission ``k - 1`` (zero for the first), so nothing the
program staged or carried reaches the reference.  The program's
feedback for each transmission is judged against it:

* ``llr_gap``: the widest gap, over the compared slots, between the
  program's combined LLR buffer (``cw_llr``, what HARQ carries to the
  next transmission) and the reference's, as a share of that slot's
  largest reference magnitude.  A prior dropped, combined twice or taken
  from another job, and a slot served from another job's payloads, all
  show here;
* ``crc_mismatch``: the share of compared codewords whose CRC verdict
  (``crc_ok``, the ACK or NACK) differs from the reference's.  A
  transmission past the configuration's last RV counts as mismatched in
  every codeword.

A configuration names the numbers it compares and their limits.  With
``control``, the reference in its lower precision, following its own
chain of priors, stands in the program's place; it has to come out not
correct.
"""
from __future__ import annotations

import numpy as np
import torch

from harness import arith, chain


def reference_of(cell):
    return arith.load("reference", cell.config["reference"])


def _inputs(pools, recs: list, k: int, prior, device) -> dict:
    ys, nvs = [], []
    for rec in recs:
        key0, p = rec.origin
        slots = pools.pools[key0[:3] + (k,)].slots
        ys.append(slots["y_time"][p])
        nvs.append(slots["noise_var"])
    return {
        "y_time": torch.stack(ys).to(device),
        "noise_var": torch.stack(nvs).to(device).float(),
        "rv": torch.full((len(recs),), k, dtype=torch.int32, device=device),
        "prior_llr": prior,
    }


def judge(cell, pools, records: list, *, device,
          control: bool = False) -> dict:
    """The numbers compared, each with its limit, and ``correct``."""
    ref = reference_of(cell)
    gap, mismatch, codewords, slots = 0.0, 0, 0, 0
    by_rung: dict = {}
    for rec in records:
        by_rung.setdefault(rec.mcs, []).append(rec)
    for mcs, recs in sorted(by_rung.items()):
        rung = cell.rungs[mcs]
        shape = (len(recs), rung.codewords_per_slot, rung.code.n_mother)
        prior = torch.zeros(shape, device=device)
        prior_low = torch.zeros(shape, device=device)
        for k in range(max(len(r.cw_llr) for r in recs)):
            idx = [i for i, r in enumerate(recs) if len(r.cw_llr) > k]
            if k > pools.max_rv:  # a transmission the code has no RV for
                n = sum(recs[i].crc_ok[k].size for i in idx)
                mismatch += n
                codewords += n
                slots += len(idx)
                continue
            rows = torch.tensor(idx, device=device)
            batch = _inputs(pools, [recs[i] for i in idx], k, prior[rows],
                            device)
            want = ref.receive(cell, rung, batch)
            prior[rows] = want["cw_llr"]
            if control:
                got = ref.receive(cell, rung,
                                  {**batch, "prior_llr": prior_low[rows]},
                                  lower=True)
                prior_low[rows] = got["cw_llr"]
                got_llr = got["cw_llr"].cpu().numpy()
                got_crc = got["crc_ok"].cpu().numpy()
            else:
                got_llr = np.stack([recs[i].cw_llr[k][0] for i in idx])
                got_crc = np.stack([recs[i].crc_ok[k] for i in idx])
            w_llr = want["cw_llr"].cpu().numpy()
            w_crc = want["crc_ok"].cpu().numpy()
            scale = np.abs(w_llr).reshape(len(idx), -1).max(axis=1)
            diff = np.abs(got_llr - w_llr).reshape(len(idx), -1).max(axis=1)
            gap = max(gap, float(np.max(diff / np.maximum(scale, 1e-30))))
            mismatch += int(np.sum(got_crc != w_crc))
            codewords += w_crc.size
            slots += len(idx)
    values = {"llr_gap": gap,
              "crc_mismatch": mismatch / codewords if codewords else 1.0}
    limits = cell.config["correctness"]["limits"]
    compared = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = bool(slots) and all(v["value"] <= v["limit"]
                             for v in compared.values())
    return {"correct": ok, "compared": compared, "slots": slots,
            "codewords": codewords, "jobs": len(records)}


def count_iterations(cell, buckets: list, *, device) -> None:
    """Each traced bucket's ``real_iters``: the iterations the frozen
    decoder (:func:`harness.chain.ldpc_decode`, its early exit on the
    syndrome) needs on every real codeword's combined LLRs, as the
    program handed them to its decoder; the LLRs are dropped."""
    dec = cell.config["decoder"]
    chain.fp32_only()
    with torch.no_grad():
        for b in buckets:
            code = cell.rungs[b["mcs"]].code
            llr = torch.from_numpy(b.pop("cw_llr")).to(device)
            _, iters = chain.ldpc_decode(code, llr.reshape(-1, code.n_mother),
                                         dec["max_iters"], dec["alpha"])
            b["real_iters"] = iters.cpu().tolist()
