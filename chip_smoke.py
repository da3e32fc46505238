#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0, no result line) on failure:

1. Device: the card's name and ``nvidia-smi`` name / power limit; TF32 is
   switched off for matmuls and cuDNN so every fp32 product is full fp32.
2. Build: ``nvcc`` compiles the eleven hand-written kernels, nine
   sources, from ``src/repro_torch/csrc`` (one process per source, in
   parallel).
3. Kernel vs plain twin, on the card, at the main paths' shapes:
   ``ls_che`` (SISO, 2x2 and the 4x4 MU grids, and a 40-symbol 2x2 slot
   with a pilot at symbol 35), ``mmse_detect_demap`` (SISO-16QAM,
   2x2-16QAM, 4x8-64QAM, SISO-256QAM, SISO-1024QAM (5 bits per axis, a
   modem built by hand), then 2x1, 4x2, 3x3 and 8x6 antenna shapes,
   which have no compiled instance) at batch 8, ``sic_detect_demap`` (the
   MU-MIMO 4x4-16QAM grid, 2x2-16QAM, 4x8-64QAM, SISO-1024QAM and the
   same four shapes) at batch 8, and the MU grid at batch 2, both bit for
   bit; both also at the mesh paths' lane-folded shapes (SISO 8 lanes x 8
   slots, the MU grid 4 lanes x 8, one noise variance a lane), where each
   lane's rows must also equal a one-value launch on that lane's rows,
   ``ldpc_decode`` and the int8 ``ldpc_decode_q`` (r12 and r34, 216
   codewords, at a converging and a non-converging SNR, r12 at lifting
   sizes z = 16, 384 and 512 (int8 also 64), and an r34 code with layers
   of 18 edges; int8 also at a saturating point; posteriors and iteration
   counts bit for bit), ``te_gemm`` (every GEMM shape
   of DeepRx and CE-ViT at
   batch 8, every epilogue, softmax rows of 300, 600 and 1000 columns,
   bf16, Fig. 10's FC GEMM and a ragged case), ``mha``
   (CE-ViT's (32, 64, 16), (16, 256, 64) causal and not, bf16, ragged,
   D = 48, 80, 128, 256 and 512, Fig. 10's (4, 128, 128) causal in fp32
   and bf16), ``te_gemm_quant`` (256^3
   and DeepRx's block conv at int8 and fp8, every epilogue, a ragged, a
   bf16-output and an M % 64 != 0 case, softmax rows of 300; the int8
   product with epilogue none or relu bit for bit),
   ``mha_quant`` ((4, 256, 64)
   causal and CE-ViT's (32, 64, 16) at int8 and fp8, D = 128, 256, 384,
   48 and 80, ragged, a bf16 output; its yardstick one SDPA call on the
   codes widened to fp32), ``fc_softmax`` (the paper's 512^3 FC
   block, the reference's test shapes, a ragged row, bf16, a cluster of
   one block, a ragged bf16 row, a 600-column row) and ``dwconv_block``
   (the paper's 32 x 16 x 512 -> 512 block, the reference's test shapes,
   ragged C and F, bf16, F = 768 and, in two passes, 1536, 8200 and
   12288).
   Each kernel's time per call (CUDA events around the wrapper, so launch
   overhead included) and device time (CUPTI), its plain twin's time, a
   library yardstick's where one PyTorch call computes the same thing
   (per call, and its device time: every kernel it launches, summed),
   the host microseconds per call of every wrapper and of the yardstick
   where one is timed (``host_us``), and its bound
   (the larger of bytes at 3.35 TB/s and operations at the
   peak for the operands' type: 67 TFLOP/s fp32, 989 TFLOP/s bf16, 1,979
   TOP/s int8 / fp8, ``repro_torch.core.machine``'s ``H100_SXM``) are
   printed.  A CUPTI trace with none of a case's kernels is retaken up to
   three times, then the run fails.  Rows 1-4 are also held, at the main
   paths' shapes, to the unfused oracles of ``repro_torch.kernels.ref``:
   ``ls_che`` (the SISO, 2x2 and MU grids) to ``ls_che_ref`` at rtol
   1e-4, detect + demap (the four registered scenarios) and SIC (the MU
   grid) to ``mmse_detect_demap_ref`` / ``sic_detect_demap_ref`` at >=
   99.9% LLR sign agreement and rtol 1e-3 / atol 1e-5 of the largest
   |LLR|, the fp32 decoder (r12 +3 dB, r34 +6 dB) to ``ldpc_decode_ref``
   in hard bits and iteration counts.  Before phase 3 the script points
   ``REPRO_TUNE_CACHE`` at a fresh ``build/tune-<pid>.json``, so phases
   3-6 launch every kernel at its picker's heuristic.
4. Closed loops served through the executable registry
   (``repro_torch.serve.exec_registry``): every rung's receive chain is
   captured as a CUDA graph when the scheduler is built
   (``prebuild=True``, a registry of the path's own), and each batch is
   staged into the graph's inputs and replayed.  Each loop runs with the
   kernels' launch counts zeroed just before and read just after.  A
   wrapper counts its launch when Python calls it, which a capture does
   and a replay does not, so the registry adds each step's captured
   launches per replay: these counts must equal captures times replays
   (a check of the bookkeeping only), with one capture per rung and jobs
   conserved exactly.  The evidence that the graphs ran the kernels is
   measured: ten more steady ticks of every path run under a CUPTI trace,
   in which every kernel of the path must appear (by its device symbol),
   no more often than that window's replays account for, and a kernel
   the path must not run must not appear.  The paths:
   ``SlotScheduler("siso-coded", fused)`` for 50 TTIs and
   ``"mimo2x2-coded"`` for 10 (the classical receiver: ``ls_che``, detect
   + demap, LDPC), then the neural receivers on ``"siso-coded"`` for 20
   TTIs each: ``receiver="cevit", options={"fused_rx": True}`` (TE GEMM,
   MHA, detect + demap, LDPC) and ``receiver="deeprx"`` (TE GEMM, LDPC),
   with the port's own seeded weights (untrained: BER ~0.5, nearly every
   block NACKed); then the MU-MIMO SIC receiver,
   ``"mimo4x4-qam16-mu-snr18"`` with ``{"fused": True, "sic": True}`` for
   10 TTIs (``ls_che``, SIC, LDPC), and the int8 datapath, ``"siso-coded"``
   with ``{"fused": True, "precision": "int8"}`` for 20 (``ls_che``,
   detect + demap, the int8 LDPC, and the fp32 LDPC not once).  One
   batch of each path is served by graph replay and must equal the eager
   ``pipeline.run`` of the same batch bit for bit; it is then compared
   with the plain twins on the CPU: the classical ones must decode
   identically (CRC flags, payloads, iteration counts), the neural ones
   must agree in LLR signs (>= 99.9%), values (rtol 1e-3, atol 1e-5 of
   the largest |LLR|) and CRC flags.  Each path prints its compile fields
   (captures, their seconds, cache hits), its registry steady tick and,
   on one padded batch, the registry window beside the eager
   ``pipeline.run`` (median host ms, turn by turn).  The CRC pass rate of
   one MU batch through the SIC and the joint-LMMSE receivers is printed,
   not gated.  For the SISO classical, CE-ViT, DeepRx, SIC and int8 paths
   a host split is printed, not gated (ten ticks' wall, registry windows
   and slot generation; each stage's eager host time; the host reads of
   a batch); the traced ticks of every path also give the device's busy
   and idle time and the split of device time by kernel.
4b. Multi-cell serving (``repro_torch.serve.cell_mesh``), the lanes of
   a step folded into the kernels' batch axis with one noise variance a
   lane, each (group, rung, lane bucket) step one CUDA graph, launch
   counts zeroed just before each run and read just after.  Two closed
   loops of ``MeshSlotScheduler``: 8 ``siso-coded`` cells of 8 users
   (``arrival_rate`` 3.0 on the first two, 0.8 on the rest, ``snr_db`` 8 +
   0.5 i, batch 8, one batch a cell a tick, deadline 4 TTIs) for 20 TTIs,
   an urban cluster of co-sited cells, two of them hot, so users hand
   over; and 4 ``mimo4x4-qam16-mu-snr18`` SIC cells of 4 users, coupled
   at -25 dB with transmit powers 0, -3, -6, -9 dB, for 10 TTIs.  Each
   must conserve jobs exactly, capture one graph per (group, rung, bucket)
   step before the first TTI and none after, count launches equal to
   captures x replays, show each of its kernels in a CUPTI trace of ten
   replayed ticks that capture nothing, hand users over
   (the first), and serve one recorded bucket whose real lanes each equal
   the single-cell registry step of the same rung on that lane's slots
   (CRC flags, payloads, iteration counts and LLRs bit for bit, ``h_hat``
   at rtol 1e-4).  Each prints its steady tick, replays per tick and the
   device's idle share.  Then the open-loop ``CellMeshEngine`` over the
   four-cell fleet of ``examples/phy_multicell_serve.py`` with the fused
   kernels and uneven traffic (16, 4, 4, 4 slots): every slot served,
   launches equal to captures x replays, and each of its kernels in a
   CUPTI trace of a second run of the same traffic from another seed.
4c. Supervised fault-tolerant serving (``repro_torch.serve.supervisor``)
   on a co-sited cluster of 4 ``siso-coded`` cells of 8 users
   (``arrival_rate`` 0.8, ``snr_db`` 8 + 0.5 i, batch 8, deadline 4,
   lane buckets 1 and 2), cells 0-1 on the fused fp32 chain and cells
   2-3 on the fused int8 chain, each run with the launch counts zeroed
   just before and read just after, which must equal the captures x
   replays plus the eager warm-up of each step captured in the run.
   (1) ``Supervisor(fault_plan=FaultPlan.none())`` against the
   unsupervised ``MeshSlotScheduler`` for 10 TTIs, four runs in the
   order unsupervised, supervised, supervised, unsupervised: reports
   equal field for field outside the wall-clock fields, every fault
   counter 0, no degradation step; each run's steady tick printed.  (2) The reference's canonical fault schedule on 4
   cells without its stragglers, for 20 TTIs with per-tick checkpoints: a
   NaN burst in an int8 lane's prior, an ``inf`` in an fp32 lane's
   ``y_time``, one retried step error and one cell crash; the CRC flags
   served, the tick logs, the reports outside their fault fields and the
   job ids equal the clean run's (a degraded lane's flags that differ are
   printed, then the run fails), the counts equal the plan's, one
   degradation step is captured per (rung, lane bucket) degraded, and the
   int8 group runs the fp32 decoder only through it, at least once.
   (3) Three stacked step errors on one bucket (quarantined), a straggler
   of three times a watchdog set to three times run 2's longest time from
   tick start to last dispatch, and a crash against a checkpoint up to three ticks
   stale: one tick over budget, deferred batches, nothing shed, the
   lost-window jobs failed, conservation exact, then drained to no
   backlog and no open HARQ process.  (4) Ten more clean ticks of run 2's
   supervisor under a CUPTI trace that must capture nothing and show
   ``ls_che``, detect + demap and both decoders; then one int8 bucket
   with a NaN burst in its first lane, its dispatch alone under a trace
   (retaken on a later bucket while a kernel is missing) in which each
   kernel appears at most as often as the replays account for, and the
   fp32 decoder exactly as often as the degradation step replayed
   (once).  (5)
   ``SupervisedBatchRunner`` on one int8 batch of
   ``siso-qam16-r12-snr15`` with ``inf`` in one slot's ``y_time``: one
   degraded batch, the fp32 decoder replayed once.  Each run prints its
   fault counters, steady tick and summary; the two traced windows of
   run 4 their idle shares (the other runs are not traced).
4d. The mesh paths over a ``(cell, batch)`` grid of several entries
   (``launch.mesh.CellMesh``; each entry a shard with its own staged
   buffers and its own CUDA graph, every shard's replay launched before
   any is read back).  Phase 4b's two closed loops (the 8 SISO cells for
   20 TTIs, the 4 coupled MU SIC cells for 10), each on the grids (4, 1)
   and (2, 2) that repeat cuda:0, the launch counts zeroed just before
   each run and read just after: every (group, rung, lane bucket, grid
   entry) step captured before the first TTI and none after, launches
   equal to captures x replays, each kernel of the path launched and seen
   in a CUPTI trace of ten replayed ticks; the trajectory (the report
   outside its wall-clock fields and ``mesh_shape`` / ``n_filler_lanes``,
   which follow the grid's lane buckets; every tick log; the job ids)
   equal to phase 4b's one-device run's; and one served bucket's shards,
   put back in lane order, equal to the one-device lane step on the whole
   stack (CRC flags, payloads, iteration counts, LLRs and combined LLRs
   bit for bit).  Then phase 4c's canonical fault schedule (run 2) on a
   (2, 1) grid at lane bucket 2: its fault counts and its trajectory
   equal run 2's.  Printed beside the one-device figures: the steady
   tick, replays (one a shard) and captures per tick, the device's idle
   share, then the ``nvidia-smi`` line.  With two or more cards the same
   runs span the distinct cards; with one, a line says the grid repeated
   one card.
5. The blocks path, with the launch counts zeroed just before and read
   just after: the paper's three AI-PHY compute blocks (Fig. 10) at full
   width, each through its sequential plan (separate ops; the FC GEMM on
   ``te_gemm``) and its concurrent plan (the fused kernel) of
   ``repro_torch.core.pool``: FC + softmax x (512, 512) @ (512, 512),
   the depthwise-separable block x (1, 34, 18, 512) -> 512, MHA
   (4, 128, 128) causal; then the quantized kernel-ops entry point at
   int8 and fp8: ``ops.te_gemm_quant`` at 256^3 and DeepRx's block conv
   (28,672 x 288 -> 32), ``ops.mha_quant`` at (4, 256, 64) causal and
   CE-ViT's (32, 64, 16) full.  The two plans of each block must agree
   within the reference's gates and with the plain twins, every
   quantized op with its twin (the int8 GEMM bit for bit), and each of
   ``fc_softmax``, ``dwconv_block``, ``mha``, ``te_gemm``,
   ``te_gemm_quant`` and ``mha_quant`` must have launched.  The H100's
   Fig. 10, each block's sequential and concurrent time, is printed, not
   gated.
6. Training (``repro_torch.train.neural_receiver``, the port of
   ``examples/train_neural_receiver.py``): CE-ViT at full width
   (``CEViTConfig()``: d_model 128, 4 heads, 4 layers, d_ff 256, patch 4)
   on the example's 128-subcarrier uncoded grid, batch 32, 0 dB, the
   forward on ``te_gemm`` and ``mha`` (``TeGemmFunction`` /
   ``MhaFunction``, a plain torch backward).  (a) One step's loss and
   every gradient leaf through the kernels against autograd through the
   twins on the card (loss rtol 1e-4, each leaf within 1e-3 of its
   largest |g|).  (b) 500 steps with the launch counts zeroed just before
   and read just after, exactly 18 ``te_gemm`` and 4 ``mha`` a step;
   CE-ViT's held-out MSE must be below LS's.  (c) Ten more steps under a
   CUPTI trace that must show 18 and 4 launches a step.  Printed: ms a
   step, device time by kernel, the idle share, the three MSEs and the
   loss at steps 0, 100, ..., 400 and 499, beside the ``nvidia-smi``
   line.  Phase 3 also checks and times the six training GEMMs and the
   (128, 32, 32, 32) attention.
7. The autotuner (``repro_torch.kernels.tune``) over the kernels' own
   launch choices at the main paths' shapes: ``te_gemm`` at DeepRx's
   block conv (fp32, bf16, int8, e4m3) and CE-ViT's training wqkv, ``mha``
   at CE-ViT's (32, 64, 64, 16) and (16, 256, 256, 64) causal, detect +
   demap at SISO-16QAM and 4x8-64QAM, SIC at the MU grid and 8x6 (B = 8),
   both decoders at r12 over 216 codewords, ``ls_che`` at the three grids.
   Every candidate is held to the twin (bit for bit for detect, SIC, the
   decoders and int8; the fp32 / bf16 gates for the GEMMs and ``mha``;
   ``ls_che`` rtol 1e-5) and timed (device us, CUPTI); each op's tuner
   runs once and stores its winner; then the public wrapper, with no
   choice, must launch the winner (``_build.launch_choices``) and still
   equal the twin.  Each case prints its candidates, the heuristic's
   choice and the winner; the phase its wall time.
8. The LM model zoo (``repro_torch.configs``, ``repro_torch.models``),
   plain torch (no hand-written kernel may launch; the counts are zeroed
   just before and read just after). (a) Each of the ten archs' smoke
   configs on the card against the same module on the CPU, the same weights
   and tokens: forward, prefill and 4 decode steps, every logits and cache
   leaf within rtol 1e-4 + 5e-5 of the largest |value| (whisper 5e-4). (b)
   One model a family at its published width, batch 2, random weights from
   seed 0: llama3-8b (32 layers), moonshot-v1-16b-a3b (4 of 48),
   pixtral-12b (4 of 40, 1024 stub image tokens), zamba2-7b (81),
   rwkv6-1.6b (24), each on 256-token prompts, and whisper-tiny (1500 stub
   frames, 64 tokens): a teacher-forced forward, the prefill / decode
   consistency in fp32 compute (< 1e-3 of scale; llama3 at 2 layers and
   zamba2 at 7, where a random stack's chaos makes the full depth miss it
   in the reference too, the deeper stacks' errors printed), moonshot's
   no-drop identity (< 1e-4), then in bf16 compute the prefill and 16
   greedy decode steps, each under
   ``torch.cuda.set_sync_debug_mode("error")`` (after 2 more untimed), and
   10 more traced. (d) Each model served through ``ServeEngine`` on
   ``launch/serve.py``'s workload (8 requests, prompts of 4-32 tokens from
   ``default_rng(0)``, batch 4, 16 new tokens, ``max_len`` 256 past
   pixtral's image tokens), decode one CUDA graph: its tokens equal an
   eager greedy loop of ``prefill`` / ``decode_step`` run here, one
   capture an engine and one replay a decode step, a second
   ``generate`` under a CUPTI trace captures nothing. A JSON line a
   model: params, GB, peak memory, forward / prefill ms, decode ms a step
   (median of 16), tokens/s, the idle share; the graph's decode ms a step
   (median of 16 replays) beside the eager steps' at batch 4, generate
   tokens/s and the traced generate's idle share.
9. LM training, plain torch (no hand-written kernel may launch; counts
   zeroed just before, read just after): (a) smollm-360m's published
   config (fp32 parameters, bf16 compute, ``remat="full"``; the schema's
   ``scaled`` leaves re-drawn N(0, 0.02^2), as the reference's own init
   explodes at this depth: ``_lmt_conditioned``) on
   ``TokenStream(49152, 8, 2048)`` in 2 microbatches, lr 1e-3 (2e-3
   oscillates at this width) after 5 warm-up steps: a ``Trainer`` runs 20 steps, checkpointing every 10
   under ``build/``, a fresh one resumes at step 20 bit for bit and runs
   10 more; every loss finite, the last 5 below the first 5; (d) the
   trained parameters served through ``ServeEngine``, every token in the
   vocabulary; 5 more steps under a CUPTI trace. (b) One step at 1 and at
   4 microbatches, fp32 compute, one state: losses at rtol 1e-4,
   parameters within 1e-4 of each leaf's largest |value|. (c)
   moonshot-v1-16b-a3b at published width, 2 of 48 layers, on
   ``TokenStream(163840, 4, 1024)``, 10 steps, every loss, router loss
   and gradient norm finite. Printed: ms a step, tokens/s, MFU (6 N
   tokens at 989 TFLOP/s bf16), peak memory beside the state's and the
   full fp32 logits' bytes, the traced steps' idle share and device time
   by kernel, the losses, the ``nvidia-smi`` line.
10. The sharded LM paths and the roofline dry run (plain torch, no
   hand-written kernel may launch): (a) on a one-rank NCCL group
   (``dist.HashStore``, no socket) and ``make_host_mesh()``, smollm-360m's
   smoke config trains 3 steps through ``Trainer`` with its state placed
   as DTensors by the sharding rules, from the state the unsharded
   ``Trainer`` starts from: losses and parameters equal (fp32, rtol 1e-6);
   (b) ``ServeEngine`` with ``cache_shardings`` on that mesh, one smoke
   config a family: tokens equal the unsharded engine's, the decode step
   one CUDA graph over the DTensor cache; (c) in a subprocess,
   ``launch.dryrun`` reports on a (1, 1, 1) mesh (a one-rank fake group,
   the H100's bf16 peak) for phase 8 (d)'s llama3-8b decode at batch 4 and
   phase 9 (a)'s smollm-360m train step at 8 x 2048 in 2 microbatches,
   with the fp32 params those steps keep, each beside the measured ms a
   step and MFU: a measured step faster than its roofline's
   ``t_overlap_s`` fails the run; (d) the same process's llama3-8b
   ``train_4k`` cell on the 16x16 production mesh (a fake 256-rank
   group): its ``row()``, collective counts and ``trace_s``.  Every dry
   run: ``status`` ok, every term finite, and the ideal FLOPs at most the
   executed FLOPs of all ranks (:func:`executed_flops_ratio`, unclamped).
11. The ``kernels`` JSON line, the ``nvidia-smi`` line, and the result
   line ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits with code 2 and prints no result.
"""
from __future__ import annotations

import collections
import gc
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def free_card() -> None:
    """Return the card's memory of everything no longer referenced: a
    collection first, since models and schedulers left in reference
    cycles hold their tensors until the collector runs (which a phase
    that allocates few Python objects may not trigger), then the
    allocator's cache."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, calls: int = 1000, chunk: int = 100) -> float:
    """Host microseconds per call of ``fn``: ``calls`` calls back to back
    in chunks of ``chunk``, the host clock read before the card is
    synchronised after each chunk (so the time is the enqueue cost and
    never waits on a full launch queue); the median of the chunks' means,
    since the host's clock is shared with other work."""
    import torch

    for _ in range(50):
        fn()
    means = []
    for _ in range(calls // chunk):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(chunk):
            fn()
        means.append((time.perf_counter() - t0) / chunk * 1e6)
    torch.cuda.synchronize()
    return statistics.median(means)


def _device_events(prof) -> list:
    """(name, microseconds) of every device-side event (kernels, copies)
    the profiler recorded; a user annotation's device range (e.g.
    ``Optimizer.step``) spans kernels already counted and is left out.
    Read from the profiler's raw records: building its event objects
    (``prof.events()``) took ~10 s a window of 45k device events."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        annotation = getattr(e, "is_user_annotation", None)
        if e.device_type() != DeviceType.CUDA or (
                annotation is not None and annotation()):
            continue
        out.append((e.name(), e.duration_ns() / 1e3))
    return out


def _trace(fn, reps: int) -> list:
    """(name, microseconds) of the device events of ``reps`` calls of
    ``fn`` under a CUPTI trace, after one untraced call.  A window in
    which CUPTI recorded no device event at all (every call launches
    kernels, so the tracer failed) is taken again after a pause, up to
    :data:`WINDOW_RETAKES` times: late in a process such windows come a
    few in a row."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    events = []
    for _ in range(WINDOW_RETAKES):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = _device_events(prof)
        if events:
            break
        time.sleep(0.05)
    return events


WINDOW_RETAKES = 5  # an empty CUPTI window (the tracer failed) is retaken
TRACE_LEAD_LAUNCHES = 32  # small launches ahead of a one-dispatch window
TRACE_TRIES = 3  # a trace that holds none of the call's kernels is retaken


def device_us(fn, kernel, reps: int = 20) -> float:
    """Device microseconds per call of ``fn`` in the CUDA kernels whose
    names contain ``kernel`` (a string, or a tuple with one entry per
    kernel a call may launch once), from a CUPTI trace of ``reps`` calls:
    for each entry the mean over its recorded launches (after a few
    hundred traces in one process CUPTI records only some of a window's
    launches), summed.  A trace with no launch of any entry is taken
    again, up to :data:`TRACE_TRIES` times; then the case fails."""
    pats = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    for _ in range(TRACE_TRIES):
        events = _trace(fn, reps)
        means = [statistics.fmean(hits) for hits in
                 ([us for name, us in events if p in name] for p in pats)
                 if hits]
        if means:
            return sum(means)
    check(False, f"no CUPTI event of {pats} for {reps} calls in "
          f"{TRACE_TRIES} traces")


def library(fn) -> dict:
    """The yardstick columns of a case: one PyTorch call's time per call
    (CUDA events, host included) and its device time (every kernel it
    launches, summed per call, CUPTI); both None without such a call."""
    if fn is None:
        return {"library_ms": None, "library_device_us": None}
    return {"library_ms": time_ms(fn),
            "library_device_us": device_total_us(fn)}


def profile_window(sch, run, ticks) -> dict:
    """Host wall time, device busy time and its split by kernel over one
    call of ``run`` (``ticks`` steady ticks of a scheduler, or an engine's
    ``run``) under a CUPTI trace, and each ported kernel's launches as
    that trace records them (``traced_launches``, by
    :data:`KERNEL_SYMBOLS`) beside the count derived from the captures'
    launches times the graph replays in the window
    (``derived_launches``), and the steps captured inside the window
    (``captures_in_window``: none, when every step was captured ahead)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    derived0 = derived_launches(sch)
    steps0 = {id(st) for st in captured_steps(sch)}
    torch.cuda.synchronize()
    # device activity only: host-op records are not read here, and
    # parsing them took ~30 s a mesh window (45k device events)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        wall_us = (t1 - t0) * 1e6
    t2 = time.perf_counter()
    events = _device_events(prof)
    t3 = time.perf_counter()
    by_name: dict = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    check(bool(events), "the profiled ticks' trace holds no device event")
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    ours = {k: sum(us for name, us in by_name.items() if pat in name)
            for k, pat in KERNEL_SYMBOLS.items()}
    traced = {k: sum(1 for name, _ in events if pat in name)
              for k, pat in KERNEL_SYMBOLS.items()}
    new_steps = [st for st in captured_steps(sch) if id(st) not in steps0]
    return {
        "ticks": ticks, "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "device_events": len(events),
        "ported_kernels_ms": {k: v / 1e3 for k, v in ours.items()},
        "traced_launches": {k: n for k, n in traced.items() if n},
        "derived_launches": dict(+(derived_launches(sch) - derived0)),
        "captures_in_window": len(new_steps),
        "top_device_ms": [(name[:60], us / 1e3) for name, us in top],
        "trace_stop_s": t2 - t1, "trace_read_s": t3 - t2,
    }


# per-case fields printed besides the times, where a check records them
EXTRA_FIELDS = ("bit_exact", "joint_device_us", "max_abs_code", "iters_hist",
                "library_call", "host_us", "library_host_us", "oracle")

# each ported kernel: its source and the TPU kernel it replaces
KERNELS = {
    "ls_che": ("ls_che.cu", "src/repro/kernels/rx_fused.py:587"),
    "mmse_detect_demap": ("detect_demap.cu",
                          "src/repro/kernels/rx_fused.py:389"),
    "sic_detect_demap": ("detect_demap.cu",
                         "src/repro/kernels/rx_fused.py:404"),
    "ldpc_decode": ("ldpc_minsum.cu", "src/repro/kernels/ldpc.py:304"),
    "ldpc_decode_q": ("ldpc_minsum.cu",
                      "src/repro/kernels/ldpc.py:304"),
    "te_gemm": ("te_gemm.cu", "src/repro/kernels/te_gemm.py:123"),
    "mha": ("mha.cu", "src/repro/kernels/mha.py:64"),
    "te_gemm_quant": ("te_gemm_quant.cu",
                      "src/repro/kernels/te_gemm.py:230"),
    "mha_quant": ("mha_quant.cu", "src/repro/kernels/mha.py:172"),
    "fc_softmax": ("fc_softmax.cu", "src/repro/kernels/fc_softmax.py:43"),
    "dwconv_block": ("dwconv_block.cu",
                     "src/repro/kernels/dwconv_block.py:60"),
}

# the device-side symbol of each ported kernel (for the CUPTI trace)
KERNEL_SYMBOLS = {"ls_che": "ls_che_kernel",
                  "mmse_detect_demap": "detect_demap_kernel",
                  "sic_detect_demap": "sic_demap_kernel",
                  "ldpc_decode": "ldpc_minsum_kernel",
                  "ldpc_decode_q": "ldpc_minsum_q_kernel",
                  "te_gemm": "te_gemm_kernel",
                  "mha": "mha_kernel",
                  "te_gemm_quant": "te_gemm_quant_kernel",
                  "mha_quant": "mha_quant_kernel",
                  "fc_softmax": "fc_softmax_kernel",
                  "dwconv_block": "dwconv_block_kernel"}


def bound(bytes_moved: float, flops: float, peak: str = "fp32") -> tuple:
    """(ms, "bytes" or "operations"): the larger of ``bytes_moved`` at the
    card's HBM rate and ``flops`` at its peak for the operands' type
    (``fp32`` outside the tensor cores, ``bf16``, ``int8``), both from
    ``repro_torch.core.machine.H100_SXM``."""
    from repro_torch.core.machine import H100_SXM, H100_SXM_TENSOR_FLOPS

    rate = (H100_SXM.peak_flops if peak == "fp32"
            else H100_SXM_TENSOR_FLOPS[peak])
    t_bytes = bytes_moved / H100_SXM.hbm_bw * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain twin
# ---------------------------------------------------------------------------

def _grid_y(slot):
    import torch

    return torch.fft.fft(slot["y_time"], dim=2).contiguous()


def _ls_case(name: str, y, pilot_symbols: tuple, stride: int, op,
             oracle=None) -> dict:
    """One ``ls_che`` case: the kernel against its twin, and against
    ``oracle`` (the production LS path's H, ``ref.ls_che_ref``) where
    given, and its times."""
    import torch

    from repro_torch.kernels import rx_fused

    args = (y, pilot_symbols, stride, op)
    got = rx_fused.ls_che(*args)
    want = rx_fused.ls_che_torch(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
          f"ls_che[{name}] disagrees with its twin (max err {err})")
    extra = {}
    if oracle is not None:
        o_err = float((got - oracle).abs().max())
        check(torch.allclose(got, oracle, rtol=1e-4,
                             atol=1e-5 * float(oracle.abs().max())),
              f"ls_che[{name}] disagrees with ref.ls_che_ref (max err "
              f"{o_err})")
        extra["oracle"] = {"max_abs_err": o_err,
                           "tolerance": "rtol 1e-4, atol 1e-5 * max|oracle|"}
    comb = rx_fused._comb_extract(y, pilot_symbols, stride,
                                  op.shape[0]).mean(dim=1)
    b, n_sc, n_rx, n_tx = got.shape
    n_p = op.shape[1]
    nbytes = 8 * (b * len(pilot_symbols) * n_tx * n_p * n_rx + op.numel()
                  + got.numel())
    flops = 8.0 * b * n_rx * n_tx * n_p * n_sc
    bms, by = bound(nbytes, flops)
    run = lambda: rx_fused.ls_che(*args)
    lib = lambda: torch.einsum("btpr,tps->bsrt", comb, op)
    return dict(
        shape=f"{name} B={b}", max_abs_err=err,
        tolerance="rtol 1e-5, atol 1e-6",
        ms=time_ms(run),
        device_us=device_us(run, KERNEL_SYMBOLS["ls_che"]),
        host_us=host_us(run),
        plain_ms=time_ms(lambda: rx_fused.ls_che_torch(*args)),
        **library(lib), library_host_us=host_us(lib),
        library_call="torch.einsum on the comb (no gather)",
        bound_ms=bms, bound_by=by, **extra,
    )


def check_ls_che(dev) -> list:
    import torch

    from repro_torch.kernels import ref, rx_fused
    from repro_torch.phy import coding, ofdm, scenarios

    cases = []
    for name in ("siso-qam16-r12-snr15", "mimo2x2-qam16-r12-snr17",
                 "mimo4x4-qam16-mu-snr18"):
        scn = scenarios.get_scenario(name)
        g = scn.grid
        y = _grid_y(coding.make_coded_slot(ofdm.make_generator(1, dev),
                                           scn, 8))
        seq = ofdm.pilot_sequence_np(g)
        op = torch.from_numpy(rx_fused.make_ls_interp_operator(
            g.n_subcarriers, g.n_tx, g.pilot_stride, seq)).to(dev)
        oracle = ref.ls_che_ref(
            y, torch.from_numpy(seq).to(dev),
            torch.from_numpy(ofdm.link_pilot_masks_np(g)).to(dev),
            g.pilot_stride)
        cases.append(_ls_case(name, y, g.pilot_symbols, g.pilot_stride, op,
                              oracle))
    # a 40-symbol 2x2 slot with a pilot past symbol 31 (the pilot symbols
    # reach the kernel as a list)
    gen = _gen(dev, 35)
    y = torch.complex(torch.randn(8, 40, 256, 2, generator=gen, device=dev),
                      torch.randn(8, 40, 256, 2, generator=gen, device=dev))
    seq = torch.exp(1j * torch.linspace(0.0, 6.0, 256)).numpy()
    op = torch.from_numpy(rx_fused.make_ls_interp_operator(
        256, 2, 4, seq)).to(dev)
    cases.append(_ls_case("2x2 40 symbols, pilots (3, 35)", y, (3, 35), 4,
                          op))
    return cases


# fp32 operations of the MMSE solves, counted from the algorithm: complex
# multiply-add = 8, complex multiply = 6, reciprocal of a complex pivot =
# 6, per level: subtract, square, compare

def _gram_flops(n_rx: int, n_tx: int) -> float:
    """The Hermitian Gram of H's n_tx columns: its upper triangle."""
    return 8.0 * n_rx * n_tx * (n_tx + 1) / 2


def _factor_flops(m: int) -> float:
    """An m-stream system eliminated in place: pivot reciprocals,
    multipliers and the rows below each pivot."""
    return sum(6 + (m - kd - 1) * (6 + 8 * (m - kd)) for kd in range(m))


def _column_flops(m: int, down_to: int = 0) -> float:
    """One right-hand side through the stored factors: forward elimination,
    then back substitution from row m - 1 down to row ``down_to``."""
    return 4.0 * m * (m - 1) + sum(8 * (m - kd - 1) + 6
                                   for kd in range(down_to, m))


def _demap_flops(nb: int) -> float:
    """One stream unbiased and its 2 nb max-log LLRs."""
    n_lv = 2 ** nb
    return 6 + 2 * (3 * n_lv + nb * (n_lv + 1))


def _detect_flops(n_rx: int, n_tx: int, nb: int, n_sym: int) -> float:
    """fp32 operations per RE of the fused detect+demap.  What depends on
    the subcarrier alone (the Gram, its elimination, the n_tx bias columns)
    is done once per (batch row, subcarrier) and spread over its n_sym
    REs; an RE adds H^H y, its solve and the demap of every stream."""
    per_sc = (_gram_flops(n_rx, n_tx) + _factor_flops(n_tx)
              + sum(_column_flops(n_tx, u) for u in range(n_tx)))
    per_re = (8.0 * n_tx * n_rx + _column_flops(n_tx)
              + n_tx * _demap_flops(nb))
    return per_re + per_sc / n_sym


# detect+demap cases past the registered scenarios: antenna shapes with
# no compiled instance (the runtime-sized route), (n_rx, n_tx, modem) on a
# random 256-subcarrier slot at batch 8
DEMAP_ANY_SHAPES = ((2, 1, "qpsk"), (4, 2, "qam16"), (3, 3, "qam64"),
                    (8, 6, "qam16"))
QAM1024 = "siso-qam1024"  # 5 bits per axis: the runtime-sized route


def _qam1024_modem():
    """1024-QAM built the way qam256 is: binary-reflected Gray over 32
    amplitudes, levels[gray(k)] = 2k - 31, norm 2 (32^2 - 1) / 3."""
    from repro_torch.phy import ofdm

    levels = [0.0] * 32
    for k in range(32):
        levels[k ^ (k >> 1)] = 2.0 * k - 31.0
    return ofdm.Modem("qam1024", 10, tuple(levels), 682.0)


def _demap_inputs(dev):
    """(label, (y, h, noise_var, modem)) of every detect+demap case: the
    registered scenarios' slots, a SISO 1024-QAM slot, then
    :data:`DEMAP_ANY_SHAPES`."""
    import torch

    from repro_torch.phy import ofdm, scenarios

    for name in ("siso-qam16-r12-snr15", "mimo2x2-qam16-r12-snr17",
                 "mimo4x8-qam64-snr24", "siso-qam256-r34-snr28"):
        scn = scenarios.get_scenario(name)
        slot = scn.make_batch(ofdm.make_generator(2, dev), 8)
        yield name, (_grid_y(slot), slot["h"][:, 0].contiguous(),
                     slot["noise_var"], scn.modem)
    # siso-qam256-r34-snr28's grid carrying 1024-QAM at 34 dB
    scn = scenarios.get_scenario("siso-qam256-r34-snr28")
    modem = _qam1024_modem()
    gen = _gen(dev, 1024)
    g = scn.grid
    bits = torch.randint(0, 2, (8, g.n_symbols, g.n_subcarriers, 1, 10),
                         generator=gen, device=dev, dtype=torch.int32)
    h = ofdm.tdl_channel(gen, g, 8)  # (8, 1, 1, n_sc)
    h = torch.movedim(h, -1, 1).contiguous()  # (8, n_sc, 1, 1)
    nv = torch.tensor(10.0 ** -3.4, device=dev)
    y = torch.einsum("bsrt,bmst->bmsr", h, modem.mod(bits))
    y = y + torch.complex(torch.randn(y.shape, generator=gen, device=dev),
                          torch.randn(y.shape, generator=gen, device=dev)
                          ) * torch.sqrt(nv / 2.0)
    yield QAM1024, (y.contiguous(), h, nv, modem)
    for n_rx, n_tx, modem in DEMAP_ANY_SHAPES:
        gen = _gen(dev, 10 * n_rx + n_tx)
        cg = lambda *s: torch.complex(
            torch.randn(*s, generator=gen, device=dev),
            torch.randn(*s, generator=gen, device=dev)) / math.sqrt(2.0)
        h = cg(8, 256, n_rx, n_tx)
        nv = torch.tensor(0.05 * n_tx, device=dev)
        y = cg(8, 14, 256, n_rx)
        yield f"{n_rx}x{n_tx}-{modem} (no instance)", (
            y, h, nv, ofdm.make_modem(modem))


# the mesh paths' lane-folded launches: (grid, lanes of 8 slots, dB
# between neighbouring lanes), each lane at its own noise variance
DEMAP_LANES = ("siso-qam16-r12-snr15", 8, 0.5)
SIC_LANES = ("mimo4x4-qam16-mu-snr18", 4, 3.0)


def _lane_inputs(dev, name: str, lanes: int, step_db: float) -> tuple:
    """(label, (y, h, noise_var, modem)): ``lanes`` lanes of 8 slots of
    ``name``, lane i at ``step_db * i`` dB above it, folded into one
    batch of 8 * lanes rows with ``lanes`` noise values."""
    import torch

    from repro_torch.phy import ofdm, scenarios

    scn = scenarios.get_scenario(name)
    ys, hs, nvs = [], [], []
    for i in range(lanes):
        slot = scn.replace(snr_db=scn.snr_db + step_db * i).make_batch(
            ofdm.make_generator(20 + i, dev), 8)
        ys.append(_grid_y(slot))
        hs.append(slot["h"][:, 0])
        nvs.append(slot["noise_var"])
    nv = torch.stack(nvs)
    check(len(set(nv.tolist())) == lanes, f"{name}: lanes share a noise "
          "variance")
    return (f"{name} {lanes} lanes x 8", (torch.cat(ys).contiguous(),
                                          torch.cat(hs).contiguous(), nv,
                                          scn.modem))


def _check_lanes(kernel, label: str, args) -> None:
    """Each lane's rows of a launch with one noise value a lane equal a
    one-value launch on that lane's rows, bit for bit."""
    import torch

    y, h, nv, modem = args
    got = kernel(*args)
    rows = y.shape[0] // nv.numel()
    for i in range(nv.numel()):
        part = slice(i * rows, (i + 1) * rows)
        one = kernel(y[part].contiguous(), h[part].contiguous(), nv[i],
                     modem)
        torch.cuda.synchronize()
        check(all(torch.equal(g[part], w) for g, w in zip(got, one)),
              f"{label}: lane {i} differs from its one-value launch")


def _hold_llr_oracle(name: str, llr, oracle) -> dict:
    """LLRs against an unfused oracle at the port's gate: >= 99.9% sign
    agreement, values within rtol 1e-3 and atol 1e-5 of the largest
    |LLR| (a uniform scale error keeps every sign)."""
    import torch

    signs = float(((llr > 0) == (oracle > 0)).float().mean())
    err = float((llr - oracle).abs().max())
    check(signs >= 0.999, f"{name}: LLR signs agree with the oracle on "
          f"{signs:.6f} of bits (gate 0.999)")
    check(torch.allclose(llr, oracle, rtol=1e-3,
                         atol=1e-5 * float(oracle.abs().max())),
          f"{name}: LLRs disagree with the oracle (max err {err})")
    return {"sign_agreement": signs, "max_abs_err": err,
            "tolerance": ">= 99.9% LLR signs, rtol 1e-3, atol 1e-5 * "
                         "max|oracle LLR|"}


# the main paths' detect + demap and SIC inputs, also held against the
# unfused oracles of kernels/ref.py
DEMAP_ORACLE = ("siso-qam16-r12-snr15", "mimo2x2-qam16-r12-snr17",
                "mimo4x8-qam64-snr24", "siso-qam256-r34-snr28")
SIC_ORACLE = ("mimo4x4-qam16-mu-snr18",)


def check_detect_demap(dev) -> list:
    import torch

    from repro_torch.kernels import ref, rx_fused

    cases = []
    for name, args in (*_demap_inputs(dev),
                       _lane_inputs(dev, *DEMAP_LANES)):
        y, h, nv, modem = args
        got = rx_fused.mmse_detect_demap(*args)
        want = rx_fused.mmse_detect_demap_torch(*args)
        torch.cuda.synchronize()
        # built with -fmad=false, the kernel rounds where the twin does
        exact = all(torch.equal(a, b_) for a, b_ in zip(got, want))
        err = max(float((a - b_).abs().max()) for a, b_ in zip(got, want))
        check(exact, f"detect_demap[{name}] is not bit-exact to its twin "
              f"(max err {err})")
        extra = {}
        if name in DEMAP_ORACLE:
            extra["oracle"] = _hold_llr_oracle(
                f"detect_demap[{name}]", got[2],
                ref.mmse_detect_demap_ref(*args)[2])
        if nv.numel() > 1:
            _check_lanes(rx_fused.mmse_detect_demap, name, args)
        b, n_sym, n_sc, n_rx = y.shape
        n_tx = h.shape[-1]
        nb = modem.bits_per_symbol // 2
        n_re = b * n_sym * n_sc
        nbytes = (8 * n_re * n_rx + 8 * h.numel() + 4 * nv.numel()
                  + n_re * n_tx * (8 + 4 + 4 * 2 * nb))
        bms, by = bound(nbytes, n_re * _detect_flops(n_rx, n_tx, nb, n_sym))
        run = lambda: rx_fused.mmse_detect_demap(*args)
        cases.append(dict(
            shape=f"{name} B={b}",
            max_abs_err=err, bit_exact=exact,
            tolerance="bit-exact (x_hat, nv_eff and LLRs equal; each "
            "lane also equal to its one-value launch)" if nv.numel() > 1
            else "bit-exact (x_hat, nv_eff and LLRs equal)",
            ms=time_ms(run),
            device_us=device_us(run, KERNEL_SYMBOLS["mmse_detect_demap"]),
            host_us=host_us(run),
            plain_ms=time_ms(
                lambda: rx_fused.mmse_detect_demap_torch(*args)),
            **library(None), bound_ms=bms, bound_by=by, **extra,
        ))
    return cases


def _sic_flops(n_rx: int, n_tx: int, nb: int, n_sym: int) -> float:
    """fp32 operations per RE of SIC.  Stage k's suffix Gram is a block of
    the full Gram, and its system and bias column 0 depend on the
    subcarrier alone: the Gram and every stage's elimination and bias
    column are done once per (batch row, subcarrier) and spread over its
    n_sym REs.  An RE adds, per stage, H[:, k:]^H y_res, its solve, the
    demap of stream k, and but for the last stage the hard decision on
    each axis and the cancellation."""
    n_lv = 2 ** nb
    per_sc = _gram_flops(n_rx, n_tx) + sum(
        _factor_flops(m) + _column_flops(m) for m in range(1, n_tx + 1))
    per_re = sum(8.0 * m * n_rx + _column_flops(m) + _demap_flops(nb)
                 for m in range(1, n_tx + 1))
    per_re += (n_tx - 1) * (2 * (3 * n_lv + 2) + 8.0 * n_rx)
    return per_re + per_sc / n_sym


def _sic_decisions(x_hat, modem):
    """Each stream's nearest level index per axis: the decisions SIC's
    stages subtract."""
    import torch

    lv = torch.tensor(modem.levels, device=x_hat.device)
    parts = torch.stack([x_hat.real, x_hat.imag], -1) * math.sqrt(modem.norm)
    return torch.argmin((parts[..., None] - lv) ** 2, dim=-1)


def check_sic(dev) -> list:
    import torch

    from repro_torch.kernels import ref, rx_fused
    from repro_torch.phy import ofdm, scenarios

    cases = []
    inputs = dict(_demap_inputs(dev))
    lanes, lane_args = _lane_inputs(dev, *SIC_LANES)
    inputs[lanes] = lane_args
    mu = "mimo4x4-qam16-mu-snr18"
    # the MU grid also at a served batch of 2: the factor phase's fixed
    # cost a block against few symbols' REs; then the mesh path's lanes
    for name in (mu, f"{mu} B=2", "mimo2x2-qam16-r12-snr17",
                 "mimo4x8-qam64-snr24", QAM1024, *(
                     label for label in inputs if "no instance" in label),
                 lanes):
        if name not in inputs:  # the MU grid is SIC's alone
            grid, _, batch = name.partition(" B=")
            scn = scenarios.get_scenario(grid)
            slot = scn.make_batch(ofdm.make_generator(2, dev),
                                  int(batch or 8))
            inputs[name] = (_grid_y(slot), slot["h"][:, 0].contiguous(),
                            slot["noise_var"], scn.modem)
        args = inputs[name]
        y, h, _, modem = args
        got = rx_fused.sic_detect_demap(*args)
        want = rx_fused.sic_detect_demap_torch(*args)
        torch.cuda.synchronize()
        # one differing decision would change every later stage of its RE
        check(torch.equal(_sic_decisions(got[0], modem),
                          _sic_decisions(want[0], modem)),
              f"sic[{name}] cancellation decisions differ from the twin's")
        exact = all(torch.equal(a, b_) for a, b_ in zip(got, want))
        err = max(float((a - b_).abs().max()) for a, b_ in zip(got, want))
        check(exact, f"sic[{name}] is not bit-exact to its twin (max err "
              f"{err})")
        extra = {}
        if name in SIC_ORACLE:
            extra["oracle"] = _hold_llr_oracle(
                f"sic[{name}]", got[2], ref.sic_detect_demap_ref(*args)[2])
        nv = args[2]
        if nv.numel() > 1:
            _check_lanes(rx_fused.sic_detect_demap, name, args)
        b, n_sym, n_sc, n_rx = y.shape
        n_tx = h.shape[-1]
        nb = modem.bits_per_symbol // 2
        n_re = b * n_sym * n_sc
        nbytes = (8 * n_re * n_rx + 8 * h.numel() + 4 * nv.numel()
                  + n_re * n_tx * (8 + 4 + 4 * 2 * nb))
        bms, by = bound(nbytes, n_re * _sic_flops(n_rx, n_tx, nb, n_sym))
        run = lambda: rx_fused.sic_detect_demap(*args)
        # one stream has nothing to cancel: the wrapper then launches the
        # joint receiver's kernel
        symbol = KERNEL_SYMBOLS["sic_detect_demap" if n_tx > 1
                                else "mmse_detect_demap"]
        cases.append(dict(
            shape=f"{name.partition(' B=')[0]} B={b}"
            + (f" ({nv.numel()} noise values)" if nv.numel() > 1 else ""),
            max_abs_err=err,
            bit_exact=exact,
            tolerance="bit-exact (decisions, x_hat, nv_eff and LLRs equal"
            + ("; each lane also equal to its one-value launch)"
               if nv.numel() > 1 else ")"),
            ms=time_ms(run),
            device_us=device_us(run, symbol),
            host_us=host_us(run),
            plain_ms=time_ms(lambda: rx_fused.sic_detect_demap_torch(*args),
                             reps=10),
            **library(None), bound_ms=bms, bound_by=by,
            # the joint receiver's kernel on the same inputs, for scale
            joint_device_us=device_us(
                lambda: rx_fused.mmse_detect_demap(*args),
                KERNEL_SYMBOLS["mmse_detect_demap"]), **extra,
        ))
    return cases


def _code_llrs(code, n_cw: int, snr_db: float, dev):
    """(n_cw, n_mother) BPSK-over-AWGN channel LLRs of random codewords."""
    import torch

    from repro_torch.phy import coding, ofdm

    gen = ofdm.make_generator(int(snr_db * 10) + code.m_b, dev)
    bits = torch.randint(0, 2, (n_cw, code.k), generator=gen, device=dev)
    tx = coding.rate_match(code, coding.encode(code, bits)).float()
    s2 = 10.0 ** (-snr_db / 10.0)
    y = (2 * tx - 1) + math.sqrt(s2) * torch.randn(
        tx.shape, generator=gen, device=dev)
    return coding.derate_match(code, 2.0 * y / s2).contiguous()


# (rate, z, make_code's other arguments, (fp32 SNRs, int8 (SNR, gain)
# points)): the registered z = 32 codes, then other lifting sizes (to 64
# the segment kernels, z = 384 (5G's largest) and 512 the row kernels
# with the messages in the workspace), then a code with layers of 17-18
# edges (the row kernels too)
LDPC_CODES = (
    ("r12", 32, {}, ((3.0, -6.0), ((3.0, 1.0), (-6.0, 1.0), (3.0, 8.0)))),
    ("r34", 32, {}, ((6.0, -6.0), ((6.0, 1.0), (-6.0, 1.0)))),
    ("r12", 16, {}, ((3.0,), ((3.0, 1.0),))),
    ("r12", 64, {}, ((), ((3.0, 1.0),))),
    ("r12", 384, {}, ((3.0,), ((3.0, 1.0),))),
    ("r12", 512, {}, ((3.0,), ((3.0, 1.0),))),
    ("r34", 32, {"k_b": 16, "col_degree": 8}, ((6.0,), ((6.0, 1.0),))),
)


def _code_label(rate: str, code, kw: dict) -> str:
    widest = max(map(len, code.layers()))
    return (f"{rate}{'' if code.z == 32 else f' z={code.z}'}"
            f"{f' {widest}-edge layers' if kw else ''}")


# the main path's codes and points, also held against ref.ldpc_decode_ref
LDPC_ORACLE = (("r12", 3.0), ("r34", 6.0))


def check_ldpc(dev) -> list:
    import torch

    from repro_torch.kernels import ldpc, ref
    from repro_torch.phy import coding

    cases = []
    for rate, z, kw, snrs in LDPC_CODES:
        if not snrs[0]:
            continue
        code = coding.make_code(rate, z=z, **kw)
        n_edges = sum(len(e) for e in code.layers())
        for snr in snrs[0]:
            llr = _code_llrs(code, 216, snr, dev)
            post, iters = ldpc.ldpc_decode(llr, code)
            post_t, iters_t = ldpc.ldpc_decode_torch(llr, code)
            torch.cuda.synchronize()
            label = f"{_code_label(rate, code, kw)}@{snr}dB"
            check(torch.equal(iters, iters_t),
                  f"ldpc[{label}] iteration counts differ")
            check(torch.equal(post > 0, post_t > 0),
                  f"ldpc[{label}] hard bits differ")
            check(torch.equal(post, post_t),
                  f"ldpc[{label}] posteriors differ")
            err = float((post - post_t).abs().max())
            extra = {}
            if z == 32 and not kw and (rate, snr) in LDPC_ORACLE:
                post_o, iters_o = ref.ldpc_decode_ref(llr, code)
                check(torch.equal(iters, iters_o) and torch.equal(
                    post > 0, post_o > 0), f"ldpc[{label}] hard bits or "
                      "iteration counts differ from ref.ldpc_decode_ref")
                extra["oracle"] = {
                    "max_abs_err": float((post - post_o).abs().max()),
                    "tolerance": "hard bits and iteration counts equal"}
            it = iters.long()
            # ~10 fp32 ops per edge and lifted row per sweep, 2 per edge
            # for each syndrome check (one before the first sweep)
            flops = float(((it * 10 + (it + 1) * 2) * n_edges
                           * code.z).sum())
            nbytes = 2 * llr.numel() * 4 + iters.numel() * 4
            bms, by = bound(nbytes, flops)
            run = lambda: ldpc.ldpc_decode(llr, code)
            cases.append(dict(
                shape=f"{_code_label(rate, code, kw)} {snr:+.0f}dB 216cw",
                max_abs_err=err,
                tolerance="hard bits, posteriors and iteration counts exact",
                iters_hist=torch.bincount(iters.long(),
                                          minlength=13).tolist(),
                ms=time_ms(run),
                device_us=device_us(run, KERNEL_SYMBOLS["ldpc_decode"]),
                host_us=host_us(run),
                plain_ms=time_ms(lambda: ldpc.ldpc_decode_torch(llr, code),
                                 reps=20, warmup=1),
                **library(None), bound_ms=bms, bound_by=by, **extra,
            ))
    return cases


def check_ldpc_q(dev) -> list:
    """The int8 decoder against its twin, bit for bit, at a converging,
    a non-converging and a saturating point (LLRs x 8: channel codes clip
    at +-127 and check messages saturate; a column of degree d bounds the
    posterior at 127 * (1 + d) codes, under the 12-bit clip)."""
    import torch

    from repro_torch.kernels import ldpc, quant
    from repro_torch.phy import coding

    cases = []
    for rate, z, kw, (_, points) in LDPC_CODES:
        code = coding.make_code(rate, z=z, **kw)
        n_edges = sum(len(e) for e in code.layers())
        for snr, gain in points:
            llr = (_code_llrs(code, 216, snr, dev) * gain).contiguous()
            run = lambda: ldpc.ldpc_decode(llr, code, precision="int8")
            post, iters = run()
            post_t, iters_t = ldpc.ldpc_decode_torch(llr, code,
                                                     precision="int8")
            torch.cuda.synchronize()
            label = (f"{_code_label(rate, code, kw)} {snr:+.0f}dB"
                     f"{' x8' if gain != 1 else ''}")
            check(torch.equal(iters, iters_t),
                  f"ldpc int8[{label}] iteration counts differ")
            check(torch.equal(post, post_t),
                  f"ldpc int8[{label}] posteriors differ")
            it = iters.long()
            # integer ops as row 4's fp32 count, priced at the fp32 rate
            ops = float(((it * 10 + (it + 1) * 2) * n_edges * code.z).sum())
            nbytes = 2 * llr.numel() * 4 + iters.numel() * 4
            bms, by = bound(nbytes, ops)
            codes = (post / quant.llr_scale()).round().abs().max()
            cases.append(dict(
                shape=f"{label} 216cw int8", max_abs_err=float(
                    (post - post_t).abs().max()), bit_exact=True,
                tolerance="posteriors and iteration counts exact",
                max_abs_code=int(codes),
                iters_hist=torch.bincount(it, minlength=13).tolist(),
                ms=time_ms(run),
                device_us=device_us(run, KERNEL_SYMBOLS["ldpc_decode_q"]),
                host_us=host_us(run),
                plain_ms=time_ms(lambda: ldpc.ldpc_decode_torch(
                    llr, code, precision="int8"), reps=10, warmup=1),
                **library(None), bound_ms=bms, bound_by=by,
            ))
    return cases


def _tolerance(dtype) -> tuple:
    """(rtol, text): fp32 sums run in another order than the twin's
    cuBLAS call; a bf16 output may differ by one rounding step."""
    import torch

    if dtype == torch.float32:
        return 1e-4, "rtol 1e-4, atol 1e-5 * max|twin|"
    return 2.0 ** -7, "rtol 2^-7 (one bf16 rounding step), atol 1e-5 * max|twin|"


def _hold(name: str, got, want, dtype) -> float:
    import torch

    rtol, _ = _tolerance(dtype)
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    ok = torch.allclose(got, want, rtol=rtol,
                        atol=1e-5 * float(want.abs().max()))
    check(ok, f"{name} disagrees with its twin (max err {err})")
    return err


# (label, M, K, N, epilogue, bias, dtype name): every GEMM of DeepRx and
# CE-ViT at batch 8 on the SISO grid (M = 8 * 14 * 256 and 8 * 64 rows),
# then the other epilogues, softmax rows wider than one column tile (two
# passes), bf16, Fig. 10's FC GEMM (the sequential plan's), a ragged case
# and the six GEMMs of the training path.  The first row is the main
# path's reported shape.
TE_GEMM_CASES = (
    ("deeprx block conv2", 28672, 288, 32, "none", True, "float32"),
    ("deeprx conv_in", 28672, 54, 32, "relu", True, "float32"),
    ("deeprx block conv1", 28672, 288, 32, "relu", True, "float32"),
    ("deeprx conv_out qpsk", 28672, 32, 2, "none", True, "float32"),
    ("deeprx conv_out 16qam", 28672, 32, 4, "none", True, "float32"),
    ("cevit embed", 512, 16, 64, "none", False, "float32"),
    ("cevit wqkv", 512, 64, 192, "none", False, "float32"),
    ("cevit wo", 512, 64, 64, "none", False, "float32"),
    ("cevit w1", 512, 64, 128, "none", True, "float32"),
    ("cevit w2", 512, 128, 64, "none", True, "float32"),
    ("cevit head", 512, 64, 8, "none", False, "float32"),
    ("silu", 512, 64, 128, "silu", True, "float32"),
    ("softmax", 512, 64, 64, "softmax", True, "float32"),
    ("softmax wide row", 300, 40, 200, "softmax", False, "float32"),
    ("ragged", 777, 100, 33, "relu", True, "float32"),
    ("deeprx block conv1 bf16", 28672, 288, 32, "relu", True, "bfloat16"),
    ("deeprx block conv2 bf16", 28672, 288, 32, "none", True, "bfloat16"),
    ("deeprx conv_in bf16", 28672, 54, 32, "relu", True, "bfloat16"),
    ("softmax N=300", 512, 64, 300, "softmax", True, "float32"),
    ("softmax N=600", 512, 64, 600, "softmax", True, "float32"),
    ("softmax N=1000", 256, 128, 1000, "softmax", False, "float32"),
    ("softmax N=600 bf16", 512, 64, 600, "softmax", True, "bfloat16"),
    ("fig10 FC GEMM", 512, 512, 512, "none", True, "float32"),
    # CE-ViT at full width in training (batch 32 x 32 tokens)
    ("cevit train embed", 1024, 16, 128, "none", False, "float32"),
    ("cevit train wqkv", 1024, 128, 384, "none", False, "float32"),
    ("cevit train wo", 1024, 128, 128, "none", False, "float32"),
    ("cevit train w1", 1024, 128, 256, "none", True, "float32"),
    ("cevit train w2", 1024, 256, 128, "none", True, "float32"),
    ("cevit train head", 1024, 128, 8, "none", False, "float32"),
)
# the symbols of every kernel a te_gemm call may launch (a wide softmax
# row adds the second pass)
TE_GEMM_SYMBOLS = ("te_gemm_kernel", "row_softmax_kernel")


def check_te_gemm(dev) -> list:
    import torch

    from repro_torch.kernels import te_gemm

    cases = []
    for label, m, k, n, epi, has_bias, dt in TE_GEMM_CASES:
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=dev)
        gen.manual_seed(m + 7 * k + 13 * n)
        x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
        w = (torch.randn(k, n, generator=gen, device=dev)
             / math.sqrt(k)).to(dtype)
        b = ((0.1 * torch.randn(n, generator=gen, device=dev)).to(dtype)
             if has_bias else None)
        got = te_gemm.te_gemm(x, w, b, epilogue=epi)
        want = te_gemm.te_gemm_torch(x, w, b, epilogue=epi)
        torch.cuda.synchronize()
        err = _hold(f"te_gemm[{label}]", got, want, dtype)
        item = x.element_size()
        nbytes = item * (m * k + k * n + m * n + (n if has_bias else 0))
        flops = 2.0 * m * n * k + (m * n if has_bias else 0)
        bms, by = bound(nbytes, flops, "fp32" if dtype == torch.float32
                        else "bf16")
        lib = lib_label = None
        if epi == "none":  # one library call computes the same function
            lib, lib_label = (((lambda: torch.addmm(b, x, w)), "torch.addmm")
                              if has_bias else
                              ((lambda: torch.mm(x, w)), "torch.mm"))
        run = lambda: te_gemm.te_gemm(x, w, b, epilogue=epi)
        cases.append(dict(
            shape=f"{label} ({m}x{k})@({k}x{n}) {epi}"
                  f"{' +bias' if has_bias else ''} {dt}",
            max_abs_err=err, tolerance=_tolerance(dtype)[1],
            ms=time_ms(run), device_us=device_us(run, TE_GEMM_SYMBOLS),
            host_us=host_us(run),
            plain_ms=time_ms(
                lambda: te_gemm.te_gemm_torch(x, w, b, epilogue=epi)),
            **library(lib), library_call=lib_label,
            library_host_us=None if lib is None else host_us(lib),
            bound_ms=bms, bound_by=by,
        ))
    return cases


def _attention_flops(bh: int, sq: int, sk: int, d: int,
                     causal: bool) -> float:
    """The (query, key) pairs the mask keeps: 2 * D operations each for
    q.k and for p.v, plus about 5 for the online softmax."""
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    return bh * pairs * (4.0 * d + 5.0)


# (BH, Sq, Sk, D, causal, dtype name); the first row is CE-ViT's
# attention at batch 8 (8 * 4 heads, 64 tokens of 16 dims)
MHA_CASES = (
    (32, 64, 64, 16, False, "float32"),
    (16, 256, 256, 64, False, "float32"),
    (16, 256, 256, 64, True, "float32"),
    (16, 256, 256, 64, False, "bfloat16"),
    (8, 200, 200, 128, True, "float32"),
    (4, 70, 130, 32, False, "float32"),
    (32, 64, 64, 48, False, "float32"),
    (8, 100, 100, 80, True, "float32"),
    (4, 128, 128, 256, False, "float32"),   # two output slabs of D
    (4, 128, 128, 128, True, "float32"),    # Fig. 10's MHA block
    (4, 128, 128, 128, True, "bfloat16"),
    (4, 128, 128, 512, False, "float32"),   # four output slabs of D
    (128, 32, 32, 32, False, "float32"),    # CE-ViT training, full width
)


def check_mha(dev) -> list:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import mha

    cases = []
    for bh, sq, sk, d, causal, dt in MHA_CASES:
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=dev)
        gen.manual_seed(bh * sq + d)
        q = torch.randn(bh, sq, d, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(bh, sk, d, generator=gen, device=dev).to(dtype)
                for _ in range(2))
        label = (f"({bh}, {sq}, {sk}, {d}) "
                 f"{'causal' if causal else 'full'} {dt}")
        got = mha.mha(q, k, v, causal=causal)
        want = mha.mha_torch(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = _hold(f"mha[{label}]", got, want, dtype)
        flops = _attention_flops(bh, sq, sk, d, causal)
        nbytes = q.element_size() * bh * d * (2 * sq + 2 * sk)
        bms, by = bound(nbytes, flops, "fp32" if dtype == torch.float32
                        else "bf16")
        run = lambda: mha.mha(q, k, v, causal=causal)
        lib = lambda: F.scaled_dot_product_attention(q, k, v,
                                                     is_causal=causal)
        cases.append(dict(
            shape=label, max_abs_err=err, tolerance=_tolerance(dtype)[1],
            ms=time_ms(run), device_us=device_us(run, KERNEL_SYMBOLS["mha"]),
            host_us=host_us(run),
            plain_ms=time_ms(lambda: mha.mha_torch(q, k, v, causal=causal)),
            **library(lib), library_call="F.scaled_dot_product_attention",
            library_host_us=host_us(lib), bound_ms=bms, bound_by=by,
        ))
    return cases


def _gen(dev, seed: int):
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def _quant_library(xq, wq, xs, ws, has_bias: bool, epilogue: str):
    """(fn, label) of one PyTorch call computing the same product, or
    (None, None): ``torch._scaled_mm`` with row-wise scales for e4m3 with
    no epilogue (its row-wise scaling writes bf16 or fp16 only, so the
    output is rounded to bf16), ``torch._int_mm`` for the int8 product
    alone."""
    import torch

    if has_bias or epilogue != "none":
        return None, None
    w_cm = wq.t().contiguous().t()  # column-major, as cuBLASLt takes it
    if xq.dtype == torch.int8:
        return (lambda: torch._int_mm(xq, w_cm),
                "torch._int_mm (product only)")
    return (lambda: torch._scaled_mm(xq, w_cm, scale_a=xs, scale_b=ws,
                                     out_dtype=torch.bfloat16),
            "torch._scaled_mm (row-wise scales, bf16 output)")


# (label, M, K, N, epilogue, bias, precision, output dtype name); the
# first row is the blocks path's reported shape
TE_GEMM_QUANT_CASES = (
    ("256^3", 256, 256, 256, "none", False, "int8", "float32"),
    ("256^3", 256, 256, 256, "relu", True, "int8", "float32"),
    ("256^3", 256, 256, 256, "softmax", False, "int8", "float32"),
    ("256^3", 256, 256, 256, "none", False, "fp8", "float32"),
    ("256^3", 256, 256, 256, "relu", True, "fp8", "float32"),
    ("256^3", 256, 256, 256, "softmax", False, "fp8", "float32"),
    ("deeprx block conv2", 28672, 288, 32, "none", False, "int8",
     "float32"),
    ("deeprx block conv2", 28672, 288, 32, "none", False, "fp8", "float32"),
    ("deeprx block conv1", 28672, 288, 32, "relu", True, "int8", "float32"),
    ("ragged silu", 777, 100, 33, "silu", True, "int8", "float32"),
    ("bf16 out", 512, 64, 128, "relu", True, "fp8", "bfloat16"),
    ("M not a multiple of 64", 1000, 288, 32, "none", False, "int8",
     "float32"),
    ("256^3", 256, 256, 256, "softmax", True, "fp8", "float32"),
    ("softmax N=300", 512, 64, 300, "softmax", True, "int8", "float32"),
    ("softmax N=300", 512, 64, 300, "softmax", False, "fp8", "bfloat16"),
)
# a wide softmax row adds te_gemm.cu's second pass
TE_GEMM_QUANT_SYMBOLS = ("te_gemm_quant_kernel", "row_softmax_kernel")


def check_te_gemm_quant(dev) -> list:
    import torch

    from repro_torch.kernels import te_gemm

    cases = []
    for label, m, k, n, epi, has_bias, prec, odt in TE_GEMM_QUANT_CASES:
        out_dtype = getattr(torch, odt)
        gen = _gen(dev, m + 7 * k + 13 * n)
        x = torch.randn(m, k, generator=gen, device=dev)
        w = torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)
        b = (0.1 * torch.randn(n, generator=gen, device=dev)
             if has_bias else None)
        codes = te_gemm.quantize_gemm_operands(x, w, prec)
        run = lambda: te_gemm.te_gemm_quantized(*codes, b, epilogue=epi,
                                                out_dtype=out_dtype)
        twin = lambda: te_gemm.te_gemm_quantized_torch(
            *codes, b, epilogue=epi, out_dtype=out_dtype)
        got, want = run(), twin()
        torch.cuda.synchronize()
        name = f"te_gemm_quant[{label} {prec} {epi}]"
        exact = bool(torch.equal(got, want))
        if prec == "int8" and epi in ("none", "relu") \
                and out_dtype == torch.float32:
            check(exact, f"{name} is not bit-exact against its twin")
            tol = "bit-exact (int32 product, the twin's dequant order)"
            err = 0.0
        else:
            err = _hold(name, got, want, out_dtype)
            tol = _tolerance(out_dtype)[1]
        nbytes = (m * k + k * n + 4 * (m + n) + (4 * n if has_bias else 0)
                  + m * n * got.element_size())
        bms, by = bound(nbytes, 2.0 * m * n * k, "int8")
        lib, lib_label = _quant_library(*codes, has_bias, epi)
        cases.append(dict(
            shape=f"{label} ({m}x{k})@({k}x{n}) {epi}"
                  f"{' +bias' if has_bias else ''} {prec} -> {odt}",
            max_abs_err=err, tolerance=tol, bit_exact=exact,
            ms=time_ms(run),
            device_us=device_us(run, TE_GEMM_QUANT_SYMBOLS),
            host_us=host_us(run),
            plain_ms=time_ms(twin), **library(lib), library_call=lib_label,
            library_host_us=None if lib is None else host_us(lib),
            bound_ms=bms, bound_by=by,
        ))
    return cases


# (BH, Sq, Sk, D, causal, precision, output dtype name); the first row is
# the blocks path's reported shape
MHA_QUANT_CASES = (
    (4, 256, 256, 64, True, "int8", "float32"),
    (4, 256, 256, 64, True, "fp8", "float32"),
    (32, 64, 64, 16, False, "int8", "float32"),
    (32, 64, 64, 16, False, "fp8", "float32"),
    (8, 200, 200, 128, True, "int8", "float32"),
    (4, 70, 130, 32, False, "fp8", "float32"),
    (16, 256, 256, 64, False, "int8", "bfloat16"),
    (4, 128, 128, 48, True, "int8", "float32"),   # D zero-padded to 64
    (8, 64, 64, 80, False, "fp8", "float32"),     # D zero-padded to 128
    (4, 128, 128, 256, False, "int8", "float32"),
    (4, 128, 128, 384, True, "int8", "float32"),  # two output slabs of D
)


def check_mha_quant(dev) -> list:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import mha

    cases = []
    for bh, sq, sk, d, causal, prec, odt in MHA_QUANT_CASES:
        out_dtype = getattr(torch, odt)
        gen = _gen(dev, bh * sq + d)
        q = torch.randn(bh, sq, d, generator=gen, device=dev)
        k, v = (torch.randn(bh, sk, d, generator=gen, device=dev)
                for _ in range(2))
        codes = mha.quantize_mha_operands(q, k, v, prec)
        run = lambda: mha.mha_quantized(*codes, causal=causal,
                                        out_dtype=out_dtype)
        twin = lambda: mha.mha_quantized_torch(*codes, causal=causal,
                                               out_dtype=out_dtype)
        label = (f"({bh}, {sq}, {sk}, {d}) "
                 f"{'causal' if causal else 'full'} {prec} -> {odt}")
        got = run()
        err = _hold(f"mha_quant[{label}]", got, twin(), out_dtype)
        nbytes = (bh * d * (sq + 2 * sk) + 12 * bh
                  + bh * sq * d * got.element_size())
        bms, by = bound(nbytes, _attention_flops(bh, sq, sk, d, causal),
                        "int8")
        # the yardstick: one SDPA call on the codes widened to fp32, the
        # scales folded into q and v outside the timed call (SDPA's causal
        # mask is top-left aligned: q_pos >= k_pos, the reference's)
        qq, kq, vq, qs, ks, vs = codes
        qf = qq.float() * (qs * ks * d ** -0.5)[..., None]
        kf = kq.float()
        vf = vq.float() * vs[..., None]
        lib = lambda: F.scaled_dot_product_attention(
            qf, kf, vf, is_causal=causal, scale=1.0)
        cases.append(dict(
            shape=label, max_abs_err=err, tolerance=_tolerance(out_dtype)[1],
            ms=time_ms(run),
            device_us=device_us(run, KERNEL_SYMBOLS["mha_quant"]),
            host_us=host_us(run), plain_ms=time_ms(twin), **library(lib),
            library_call="F.scaled_dot_product_attention (attention on the "
                         "widened codes)",
            library_host_us=host_us(lib), bound_ms=bms, bound_by=by,
        ))
    return cases


# (label, M, K, N, bias, dtype name); the first row is the paper's FC
# block, the blocks path's shape
FC_SOFTMAX_CASES = (
    ("paper FC block", 512, 512, 512, True, "float32"),
    ("reference test", 256, 384, 512, True, "float32"),
    ("reference test", 128, 128, 512, True, "float32"),
    ("ragged", 37, 45, 333, True, "float32"),
    ("no bias", 512, 512, 100, False, "float32"),
    ("paper FC block bf16", 512, 512, 512, True, "bfloat16"),
    ("a cluster of one", 512, 512, 64, True, "float32"),
    ("ragged bf16 (K not TMA-aligned)", 37, 45, 333, True, "bfloat16"),
    ("row wider than a cluster", 512, 128, 600, True, "float32"),
)
# a row wider than a cluster holds runs on te_gemm.cu's two passes
FC_SOFTMAX_SYMBOLS = ("fc_softmax_kernel",) + TE_GEMM_SYMBOLS


def check_fc_softmax(dev) -> list:
    import torch

    from repro_torch.kernels import fc_softmax

    cases = []
    for label, m, k, n, has_bias, dt in FC_SOFTMAX_CASES:
        dtype = getattr(torch, dt)
        gen = _gen(dev, m + 3 * k + 5 * n)
        x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
        w = (torch.randn(k, n, generator=gen, device=dev)
             / math.sqrt(k)).to(dtype)
        b = ((0.1 * torch.randn(n, generator=gen, device=dev)).to(dtype)
             if has_bias else None)
        run = lambda: fc_softmax.fc_softmax(x, w, b)
        twin = lambda: fc_softmax.fc_softmax_torch(x, w, b)
        err = _hold(f"fc_softmax[{label} {m}x{k}x{n} {dt}]", run(), twin(),
                    dtype)
        item = x.element_size()
        nbytes = item * (m * k + k * n + m * n + (n if has_bias else 0))
        flops = 2.0 * m * n * k + 5.0 * m * n
        bms, by = bound(nbytes, flops, "fp32" if dtype == torch.float32
                        else "bf16")
        lib = ((lambda: torch.softmax(torch.addmm(b, x, w), dim=-1))
               if has_bias else
               (lambda: torch.softmax(torch.mm(x, w), dim=-1)))
        cases.append(dict(
            shape=f"{label} ({m}x{k})@({k}x{n}){' +bias' if has_bias else ''}"
                  f" {dt}", max_abs_err=err, tolerance=_tolerance(dtype)[1],
            ms=time_ms(run),
            device_us=device_us(run, FC_SOFTMAX_SYMBOLS),
            host_us=host_us(run), plain_ms=time_ms(twin), **library(lib),
            library_call="torch.softmax(torch.addmm(...)) (two calls)",
            library_host_us=host_us(lib), bound_ms=bms, bound_by=by,
        ))
    return cases


def _dw_operands(dev, b: int, h: int, w: int, c: int, f: int, dtype):
    import torch

    gen = _gen(dev, b + h * w + c + f)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    return (r(b, h + 2, w + 2, c).to(dtype), 0.2 * r(3, 3, c),
            r(c, f) / math.sqrt(c), 1.0 + 0.1 * r(f), 0.1 * r(f))


# (label, B, H, W, C, F, dtype name); the first row is the paper's block,
# the blocks path's shape (a cluster of 8 slabs of 64 channels)
DWCONV_CASES = (
    ("paper block", 1, 32, 16, 512, 512, "float32"),
    ("reference test", 2, 16, 8, 128, 128, "float32"),
    ("reference test", 2, 32, 16, 256, 128, "float32"),
    ("ragged", 3, 5, 7, 70, 100, "float32"),
    ("paper block bf16", 1, 32, 16, 512, 512, "bfloat16"),
    ("F=768 (a cluster of 6)", 1, 16, 16, 256, 768, "float32"),
    ("F=1536 (two passes)", 1, 16, 16, 256, 1536, "float32"),
    ("F=8200 (two passes)", 1, 16, 16, 256, 8200, "float32"),
    ("F=12288 bf16 (two passes)", 1, 8, 8, 64, 12288, "bfloat16"),
)
# the tile pass and, above F = 1024, the row-wise LayerNorm pass
DWCONV_SYMBOLS = ("dwconv_block_kernel_tile", "dwconv_block_kernel_norm")


def _dw_bytes_flops(x, b, h, w, c, f, out_item) -> tuple:
    nbytes = (x.element_size() * x.numel() + 4 * (9 * c + c * f + 2 * f)
              + out_item * b * h * w * f)
    flops = b * h * w * (18.0 * c + 2.0 * c * f + 8.0 * f)
    return nbytes, flops


def check_dwconv_block(dev) -> list:
    import torch

    from repro_torch.kernels import dwconv_block

    cases = []
    for label, b, h, w, c, f, dt in DWCONV_CASES:
        dtype = getattr(torch, dt)
        args = _dw_operands(dev, b, h, w, c, f, dtype)
        run = lambda: dwconv_block.dwconv_block(*args)
        twin = lambda: dwconv_block.dwconv_block_torch(*args)
        got = run()
        err = _hold(f"dwconv_block[{label} {b}x{h}x{w}x{c}->{f} {dt}]", got,
                    twin(), dtype)
        check(bool((got >= 0).all()), f"dwconv_block[{label}] not ReLU'd")
        nbytes, flops = _dw_bytes_flops(args[0], b, h, w, c, f,
                                        got.element_size())
        bms, by = bound(nbytes, flops, "fp32" if dtype == torch.float32
                        else "bf16")
        cases.append(dict(
            shape=f"{label} B={b} {h}x{w}x{c} -> {f} {dt}", max_abs_err=err,
            tolerance=_tolerance(dtype)[1], ms=time_ms(run),
            device_us=device_us(run, DWCONV_SYMBOLS),
            host_us=host_us(run), plain_ms=time_ms(twin), **library(None),
            bound_ms=bms, bound_by=by,
        ))
    return cases


# ---------------------------------------------------------------------------
# phase 4: the closed loop through the kernels
# ---------------------------------------------------------------------------

# each path: (label, ladder, receiver, options, TTIs, the kernels it runs)
PATHS = (
    ("siso-coded classical", "siso-coded", "classical", {"fused": True}, 50,
     ("ls_che", "mmse_detect_demap", "ldpc_decode")),
    ("mimo2x2-coded classical", "mimo2x2-coded", "classical",
     {"fused": True}, 10, ("ls_che", "mmse_detect_demap", "ldpc_decode")),
    ("siso-coded cevit", "siso-coded", "cevit", {"fused_rx": True}, 20,
     ("te_gemm", "mha", "mmse_detect_demap", "ldpc_decode")),
    ("siso-coded deeprx", "siso-coded", "deeprx", {}, 20,
     ("te_gemm", "ldpc_decode")),
    ("mimo4x4-mu classical+sic", "mimo4x4-qam16-mu-snr18", "classical",
     {"fused": True, "sic": True}, 10,
     ("ls_che", "sic_detect_demap", "ldpc_decode")),
    ("siso-coded classical int8", "siso-coded", "classical",
     {"fused": True, "precision": "int8"}, 20,
     ("ls_che", "mmse_detect_demap", "ldpc_decode_q")),
)
# kernels a path must not launch at all
FORBIDDEN = {"siso-coded classical int8": ("ldpc_decode",)}
PROFILED = ("siso-coded classical", "siso-coded cevit", "siso-coded deeprx",
            "mimo4x4-mu classical+sic", "siso-coded classical int8")


def drive(ladder: str, n_ticks: int, dev, receiver: str = "classical",
          options=None) -> tuple:
    """One closed-loop run served through the executable registry (every
    rung's CUDA graph captured before the first TTI, in a registry of the
    path's own), with the launch counts zeroed just before it and read
    just after; returns (scheduler, report, launches)."""
    from repro_torch.kernels import _build
    from repro_torch.serve import ExecRegistry, SlotScheduler

    sch = SlotScheduler(ladder, receiver=receiver,
                        options={"fused": True} if options is None
                        else options, n_users=8,
                        batch_size=8, arrival_rate=0.8, max_retx=2, seed=0,
                        prebuild=True, registry=ExecRegistry(), device=dev)
    _build.reset_launches()
    rep = sch.run(n_ticks)
    launches = dict(_build.launches)
    return sch, rep, launches


def captured_steps(sch) -> list:
    """Every captured step a scheduler or engine serves through: a
    single-cell scheduler's per-rung runners, or a mesh's (group, rung,
    bucket) steps and, on a supervisor, its degradation steps (each step
    once: groups that degrade at one rung scenario and lane bucket share
    the registry's one fp32 unfused step)."""
    if hasattr(sch, "runners"):
        return [st for r in sch.runners for st in r._steps.values()]
    steps = [st for g in sch.groups for st in _flat(g._execs.values())]
    steps += _flat(getattr(sch, "_ref_execs", {}).values())
    return list({id(st): st for st in steps}.values())


def _flat(shard_steps) -> list:
    """A mesh's cached steps (one tuple a (group, rung, bucket): a step a
    grid entry) as one list."""
    return [st for steps in shard_steps for st in steps]


def derived_launches(sch):
    """Each kernel's launches as the registry accounts them: every
    captured step's launches times its replays so far (a Counter)."""
    want = collections.Counter()
    for st in captured_steps(sch):
        want.update({k: n * st.replays
                     for k, n in st.launch_delta.items()})
    return want


def check_replay_launches(sch, launches: dict) -> dict:
    """Every rung served by one captured graph, and (a cross-check of the
    bookkeeping, not evidence that a kernel ran: see
    :func:`trace_replayed_ticks`) the path's launch counts each step's
    captured launches times its replays; returns the replays per rung."""
    replays = {}
    for scn, runner in zip(sch.rungs, sch.runners):
        steps = list(runner._steps.values())
        check(len(steps) == 1 and all(st.graph is not None for st in steps),
              f"{scn.name}: not served by one captured graph")
        replays[scn.name] = sum(st.replays for st in steps)
    want = derived_launches(sch)
    check(dict(+want) == {k: n for k, n in launches.items() if n},
          f"launches {launches} != captures x replays {dict(want)}")
    return replays


def trace_replayed_ticks(sch, label: str, needs: tuple,
                         run=None, prepare=None) -> dict:
    """The measured evidence that a path's replayed graphs ran its
    kernels: :func:`profile_window` over ``run`` (default: 10 steady
    ticks of ``sch``), after ``prepare`` (an engine's new traffic) each
    time, taken again (up to :data:`TRACE_TRIES` times) while a kernel of
    ``needs`` is missing from the trace.  Fails unless the window
    captured no step and replayed graphs, each kernel of ``needs``
    appears in the trace at least once and at most as often as the
    replays in the window account for (a launch outside a graph would
    exceed that), and no kernel of :data:`FORBIDDEN` appears."""
    ticks = 10 if run is None else None
    if run is None:
        run = lambda: [sch.tick() for _ in range(ticks)]  # noqa: E731
    for _ in range(TRACE_TRIES):
        if prepare is not None:
            prepare()
        prof = profile_window(sch, run, ticks)
        traced = prof["traced_launches"]
        derived = prof["derived_launches"]
        if all(traced.get(k, 0) for k in needs):
            break
    check(prof["captures_in_window"] == 0,
          f"{label}: {prof['captures_in_window']} steps captured in the "
          "traced window")
    check(bool(derived), f"{label}: the traced window replayed no graph")
    for k in needs:
        check(0 < traced.get(k, 0) <= derived.get(k, 0),
              f"{label}: {KERNEL_SYMBOLS[k]} traced {traced.get(k, 0)} "
              f"times in a window whose replays account for "
              f"{derived.get(k, 0)}")
    for k in FORBIDDEN.get(label, ()):
        check(traced.get(k, 0) == 0,
              f"{label}: {KERNEL_SYMBOLS[k]} traced {traced.get(k)} times")
    return prof


def check_conservation(sch, rep) -> None:
    loop = sch.loop
    queued = [j.job_id for u in loop.users for j in u.backlog]
    check(sorted(loop.finalized_jobs + queued)
          == list(range(loop._job_ids.n)), "job conservation broken")
    check(rep.n_arrivals == loop._job_ids.n, "arrival count mismatch")
    for f in ("first_tx_bler", "residual_bler", "mean_harq_rounds",
              "goodput_bits_per_tti", "energy_uj_per_slot",
              "gops_per_watt"):
        v = getattr(rep, f)
        check(v is not None and math.isfinite(v), f"report {f}={v}")


def _fresh_batch(scn, dev) -> dict:
    """Eight fresh first-transmission slots of ``scn`` on ``dev``, with the
    zeroed combining prior a new HARQ process stages (the served schema)."""
    import numpy as np

    from repro_torch.phy import coding
    from repro_torch.serve import runtime

    factory = runtime.TorchSlotFactory(dev)
    slots = []
    for i in range(8):
        slot = factory(100 + i, scn, 1, rv=0)
        slot["prior_llr"] = np.zeros(
            (1, coding.codewords_per_slot(scn), scn.code.n_mother),
            np.float32)
        slots.append(slot)
    return runtime.stack_slots(slots)


def _served_batch(sch, dev) -> tuple:
    """One fresh batch of the lowest rung served by graph replay, held bit
    for bit to the eager ``pipeline.run`` of the same batch: (the batch on
    the CPU, the replayed state, the rung)."""
    import torch

    scn = sch.rungs[0]
    batch = _fresh_batch(scn, dev)
    runner = sch.runners[0]
    got = {k: v.clone() if isinstance(v, torch.Tensor) else v
           for k, v in runner._step(batch).items()}
    eager = runner.pipeline.run(batch)
    torch.cuda.synchronize()
    for k, v in eager.items():
        if isinstance(v, torch.Tensor):
            check(torch.equal(got[k], v),
                  f"{runner.pipeline.name}: replayed {k} differs from the "
                  "eager run of the same batch")
    keys = [k for k in ("h_hat", "x_hat", "nv_eff", "llr", "cw_llr")
            if k in got]
    for k in keys:
        check(bool(torch.isfinite(torch.view_as_real(got[k])
                                  if got[k].is_complex() else got[k])
                   .all()), f"non-finite {k}")
    cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v
           for k, v in batch.items()}
    return cpu, got, scn


def _median_ms(fn, reps: int = 20) -> float:
    """Median host ms of ``fn()`` closed by a device synchronize."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def registry_vs_eager(sch, dev) -> dict:
    """One padded batch of the lowest rung: the registry's window (staging
    copies, replay, synchronize) against the eager ``pipeline.run`` of the
    same batch, median host ms of 20 each, turn by turn."""
    batch = _fresh_batch(sch.rungs[0], dev)
    runner = sch.runners[0]
    registry = [_median_ms(lambda: runner._step(batch), 10)]
    eager = [_median_ms(lambda: runner.pipeline.run(batch), 10)]
    eager.append(_median_ms(lambda: runner.pipeline.run(batch), 10))
    registry.append(_median_ms(lambda: runner._step(batch), 10))
    return {"registry_batch_ms": statistics.fmean(registry),
            "eager_batch_ms": statistics.fmean(eager)}


def host_split(sch, dev, n_ticks: int = 10) -> dict:
    """Where a served tick's host time goes (printed, not gated): over
    ``n_ticks`` ticks, the tick wall, the registry windows and slot
    generation (``CellLoop.make_slot``); on one padded batch, each stage's
    ``apply`` run eagerly (host ms, no synchronize: the launch cost the
    graph removes), and the host reads after a replay: the metrics
    (``BatchRunner.run_batch``) and the HARQ feedback's ``crc_ok`` and
    ``cw_llr`` (``SlotScheduler.tick``)."""
    import torch

    from repro_torch.phy import link

    loop = sch.loop
    make_slot = loop.make_slot
    slot_s = [0.0]

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return make_slot(*a, **kw)
        finally:
            slot_s[0] += time.perf_counter() - t0

    loop.make_slot = timed
    window0 = sum(r.wall_s for r in sch.runners)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for _ in range(n_ticks):
            sch.tick()
        torch.cuda.synchronize()
    finally:
        del loop.make_slot
    wall = time.perf_counter() - t0
    window = sum(r.wall_s for r in sch.runners) - window0

    runner = sch.runners[0]
    batch = _fresh_batch(sch.rungs[0], dev)
    stage_ms = {st.name: [] for st in runner.pipeline.stages}
    with torch.no_grad():
        for _ in range(6):
            state = dict(batch)
            torch.cuda.synchronize()
            for st in runner.pipeline.stages:
                t1 = time.perf_counter()
                state = st.apply(state)
                stage_ms[st.name].append((time.perf_counter() - t1) * 1e3)
    stage_ms = {k: statistics.median(v[1:]) for k, v in stage_ms.items()}
    state = runner._step(batch)
    scn = runner.pipeline.scenario
    metrics_ms = _median_ms(lambda: {
        k: v.cpu().numpy() for k, v in link.slot_metrics(
            state, scn, per_slot=True).items()})
    feedback_ms = _median_ms(lambda: (state["crc_ok"].cpu().numpy(),
                                      state["cw_llr"].cpu().numpy()))
    return {
        "ticks": n_ticks, "tick_ms": wall / n_ticks * 1e3,
        "registry_window_ms_per_tick": window / n_ticks * 1e3,
        "make_slot_ms_per_tick": slot_s[0] / n_ticks * 1e3,
        "eager_stage_host_ms": stage_ms,
        "eager_host_ms": sum(stage_ms.values()),
        "metrics_read_ms": metrics_ms, "feedback_read_ms": feedback_ms,
    }


def check_neural_batch_against_twins(sch, dev, receiver: str,
                                     options: dict) -> dict:
    """A served batch of a neural receiver against its plain twins on the
    CPU with the same weights: LLR signs >= 99.9%, values within rtol 1e-3
    and atol 1e-5 * max|LLR|, CRC flags equal."""
    import torch

    from repro_torch.common.params import tree_map
    from repro_torch.phy import link

    cpu, got, scn = _served_batch(sch, dev)
    weights = tree_map(lambda t: t.cpu(), sch.runners[0].pipeline.params)
    want = link.build_pipeline(receiver, scn, params=weights, device="cpu",
                               **options).run(cpu)
    llr, llr_t = got["llr"].cpu(), want["llr"]
    agree = float(((llr > 0) == (llr_t > 0)).float().mean())
    check(agree >= 0.999, f"served {receiver} batch: LLR sign agreement "
          f"{agree}")
    err = float((llr - llr_t).abs().max())
    check(torch.allclose(llr, llr_t, rtol=1e-3,
                         atol=1e-5 * float(llr_t.abs().max())),
          f"served {receiver} batch: LLRs disagree (max err {err})")
    check(torch.equal(got["crc_ok"].cpu(), want["crc_ok"]),
          f"served {receiver} batch: CRC flags differ")
    return {"llr_sign_agree": agree, "llr_max_abs_err": err,
            "bler": float((~got["crc_ok"]).float().mean())}


def check_batch_against_twins(sch, dev, options: dict) -> dict:
    """Serve one fresh batch of the lowest rung on the kernels and the same
    batch on the plain twins (CPU): outputs finite, decode identical."""
    import torch

    from repro_torch.phy import link

    cpu, got, scn = _served_batch(sch, dev)
    want = link.build_classical(scn, device="cpu", **options).run(cpu)
    for k in ("crc_ok", "info_bits_hat", "decode_iters"):
        check(torch.equal(got[k].cpu(), want[k]),
              f"served batch: {k} differs between kernels and twins")
    flips = int(((got["llr"].cpu() > 0) != (want["llr"] > 0)).sum())
    check(flips <= 2, f"served batch: {flips} LLR hard-bit flips")
    return {"llr_flips": flips,
            "bler": float((~got["crc_ok"]).float().mean())}


def sic_vs_lmmse(sch, dev) -> dict:
    """CRC pass rate of one fresh MU batch through the SIC and the
    joint-LMMSE fused receivers (printed, not gated)."""
    import torch

    from repro_torch.phy import link

    scn = sch.rungs[0]
    batch = _fresh_batch(scn, dev)
    sic = sch.runners[0].pipeline.run(batch)
    joint = link.build_classical(scn, fused=True, device=dev).run(batch)
    torch.cuda.synchronize()
    return {"sic_crc_pass": float(sic["crc_ok"].float().mean()),
            "lmmse_crc_pass": float(joint["crc_ok"].float().mean())}


# ---------------------------------------------------------------------------
# phase 4b: multi-cell serving, lanes folded into the kernels' batch axis
# ---------------------------------------------------------------------------

def _mesh_specs_siso() -> list:
    """An urban cluster pooling 8 co-sited cells, two of them hot."""
    from repro_torch.serve import closed_cell

    return [closed_cell(f"cell{i}", "siso-coded", n_users=8,
                        arrival_rate=3.0 if i < 2 else 0.8,
                        snr_db=8.0 + 0.5 * i, fused=True)
            for i in range(8)]


def _mesh_specs_mu() -> list:
    """Four MU-MIMO cells coupled as co-channel neighbours, each at its own
    transmit power, so each lane has its own noise variance."""
    from repro_torch.serve import closed_cell

    return [closed_cell(f"cell{i}", "mimo4x4-qam16-mu-snr18", n_users=4,
                        arrival_rate=0.8, tx_power_db=-3.0 * i,
                        coupling_db=-25.0, fused=True, sic=True)
            for i in range(4)]


# each mesh path: (label, cells, scheduler arguments, TTIs, the kernels it
# runs); the first must hand users over
MESH_PATHS = (
    ("mesh siso-coded classical 8 cells", _mesh_specs_siso,
     dict(batch_size=8, max_batches_per_tick=1, deadline_ttis=4,
          max_retx=2, seed=0), 20,
     ("ls_che", "mmse_detect_demap", "ldpc_decode")),
    ("mesh MU SIC coupled 4 cells", _mesh_specs_mu,
     dict(batch_size=8, max_retx=2, seed=0), 10,
     ("ls_che", "sic_detect_demap", "ldpc_decode")),
)
MESH_HANDOVER = "mesh siso-coded classical 8 cells"
MESH_OPEN = "mesh open loop 4 cells (CellMeshEngine)"
MESH_OPEN_NEEDS = ("ls_che", "mmse_detect_demap")


def drive_mesh(specs: list, kw: dict, n_ticks: int, dev) -> tuple:
    """One mesh closed loop served through its own registry (every (group,
    rung, lane bucket) step a tick can emit captured before the first
    TTI, and none after), with the launch counts zeroed just before it
    and read just after; returns (scheduler, report, launches)."""
    from repro_torch.kernels import _build
    from repro_torch.serve import ExecRegistry, MeshSlotScheduler

    sch = MeshSlotScheduler(specs, prebuild=True, registry=ExecRegistry(),
                            device=dev, **kw)
    prebuilt = len(captured_steps(sch))
    check(prebuilt == sum(len(g.rungs) * len(sch._capture_buckets(g))
                          for g in sch.groups),
          f"{prebuilt} steps prebuilt")
    _build.reset_launches()
    rep = sch.run(n_ticks)
    check(len(captured_steps(sch)) == prebuilt,
          f"{len(captured_steps(sch)) - prebuilt} steps captured in the run")
    return sch, rep, dict(_build.launches)


def check_mesh_run(sch, rep, launches: dict, label: str,
                   needs: tuple) -> dict:
    """Jobs conserved exactly, one capture per (group, rung, bucket) step
    acquired, launches equal to captures x replays, each kernel of the
    path launched; returns the path's counts."""
    ids = sorted(sch.finalized_job_ids() + sch.queued_job_ids())
    check(ids == list(range(sch.jobs_submitted)),
          f"{label}: job conservation broken")
    check(rep.n_arrivals == sch.jobs_submitted, f"{label}: arrivals")
    for f in ("first_tx_bler", "residual_bler", "mean_harq_rounds",
              "goodput_bits_per_tti", "energy_uj_per_slot"):
        v = getattr(rep, f)
        check(v is not None and math.isfinite(v), f"{label}: {f}={v}")
    steps = captured_steps(sch)
    check(rep.executables_compiled == len(steps) == len(sch.registry)
          and rep.cache_hits == 0
          and all(st.graph is not None for st in steps),
          f"{label}: {rep.executables_compiled} captures for "
          f"{len(steps)} steps acquired")
    want = derived_launches(sch)
    check(dict(+want) == {k: n for k, n in launches.items() if n},
          f"{label}: launches {launches} != captures x replays "
          f"{dict(want)}")
    for k in needs:
        check(launches.get(k, 0) > 0, f"{k} never launched on {label}")
    return {"captures": len(steps), "steps": rep.n_steps,
            "ticks": rep.n_ticks, "replays_per_tick":
            rep.n_steps / rep.n_ticks, "filler_lanes": rep.n_filler_lanes,
            "handovers": rep.handovers, "jobs_shed": rep.jobs_shed,
            "steady_tick_ms": rep.steady_tick_s * 1e3,
            "first_tick_ms": rep.first_tick_s * 1e3}


def check_mesh_lanes(sch, label: str, max_ticks: int = 10) -> dict:
    """One served mesh bucket of at least two real lanes, recorded as the
    scheduler served it, against the single-cell registry step of the same
    rung on each real lane's slots: CRC flags, payload bits, iteration
    counts and LLRs bit for bit, h_hat at rtol 1e-4."""
    import torch

    from repro_torch.serve.exec_registry import slot_schema
    from repro_torch.serve.runtime import BATCHED_KEYS

    orig, rec = sch._dispatch, {}

    def record(gi, mcs, lanes, staged, stats, prefetch=None):
        first = not rec and len(lanes) >= 2
        (shard,) = staged  # one device: one shard
        inputs = ({k: v.clone() for k, v in shard.staged.items()}
                  if first else None)
        nxt = orig(gi, mcs, lanes, staged, stats, prefetch)
        if first:
            key = (mcs, sch._bucket(len(lanes)), slot_schema(shard.staged))
            (step,) = sch.groups[gi]._execs[key]
            out = step.out
            rec.update(gi=gi, mcs=mcs, n=len(lanes), inputs=inputs,
                       out={k: v.clone() for k, v in out.items()
                            if isinstance(v, torch.Tensor)})
        return nxt

    sch._dispatch = record
    try:
        for _ in range(max_ticks):
            sch.tick()
            if rec:
                break
    finally:
        del sch._dispatch
    check(bool(rec), f"{label}: no bucket of two real lanes in "
          f"{max_ticks} ticks")
    g = sch.groups[rec["gi"]]
    nv = rec["inputs"]["noise_var"][: rec["n"]]
    check(len(set(nv.tolist())) > 1, f"{label}: the recorded lanes share "
          "one noise variance")
    worst = 0.0
    for lane in range(rec["n"]):
        batch = {k: (v[lane] if k in BATCHED_KEYS or k == "noise_var"
                     else v) for k, v in rec["inputs"].items()}
        one = sch.registry.acquire_pipeline_step(
            g.pipelines[rec["mcs"]], batch, batch=sch.batch_size)
        want = one(batch)
        torch.cuda.synchronize()
        for k in ("crc_ok", "info_bits_hat", "decode_iters", "llr"):
            check(torch.equal(rec["out"][k][lane], want[k]),
                  f"{label}: lane {lane} {k} differs from the single-cell "
                  "step on its slots")
        got_h, want_h = rec["out"]["h_hat"][lane], want["h_hat"]
        check(torch.allclose(got_h, want_h, rtol=1e-4, atol=1e-6),
              f"{label}: lane {lane} h_hat beyond rtol 1e-4")
        worst = max(worst, float((got_h - want_h).abs().max()))
    return {"lanes_compared": rec["n"], "rung": g.rungs[rec["mcs"]].name,
            "noise_var": nv.tolist(), "h_hat_max_abs_err": worst}


# the fleet of examples/phy_multicell_serve.py (paired scenarios: 2-lane
# shape groups) and its uneven traffic, downtown-a the hot cell
MESH_FLEET = (("downtown-a", "siso-qam16-snr12"),
              ("downtown-b", "siso-qam16-snr12"),
              ("stadium-a", "mimo2x2-qam16-snr16"),
              ("stadium-b", "mimo2x2-qam16-snr16"))
MESH_TRAFFIC = {"downtown-a": 16, "downtown-b": 4, "stadium-a": 4,
                "stadium-b": 4}


def drive_mesh_open(dev) -> tuple:
    """The open-loop engine over the four-cell fleet with the fused
    kernels: every slot served, launches equal to captures x replays, each
    kernel of the path launched; then the same traffic from other seeds
    under a CUPTI trace (:func:`trace_replayed_ticks`); returns (report,
    launches, summary, trace)."""
    from repro_torch.kernels import _build
    from repro_torch.serve import CellMeshEngine, ExecRegistry, cell

    eng = CellMeshEngine([cell(n, scn, fused=True) for n, scn in MESH_FLEET],
                         batch_size=4, registry=ExecRegistry(), device=dev)
    reqs = eng.submit_traffic(0, MESH_TRAFFIC)
    _build.reset_launches()
    rep = eng.run()
    launches = dict(_build.launches)
    check(rep.n_slots == sum(MESH_TRAFFIC.values())
          and all(r.done for rs in reqs.values() for r in rs),
          f"{MESH_OPEN}: {rep.n_slots} slots served")
    check(all(r.ber is not None and math.isfinite(r.ber)
              for r in rep.cells.values()), f"{MESH_OPEN}: a cell's BER")
    steps = captured_steps(eng)
    check(rep.executables_compiled == len(steps) == len(eng.groups),
          f"{MESH_OPEN}: {rep.executables_compiled} captures")
    want = derived_launches(eng)
    check(dict(+want) == {k: n for k, n in launches.items() if n},
          f"{MESH_OPEN}: launches {launches} != captures x replays")
    for k in MESH_OPEN_NEEDS:
        check(launches.get(k, 0) > 0, f"{k} never launched on {MESH_OPEN}")
    summary = {
        "steps": rep.n_steps, "stolen_lanes": rep.n_stolen,
        "padded": rep.n_padded, "steady_step_ms": rep.steady_tick_s * 1e3,
        "ber": rep.ber}
    seeds = iter(range(1, TRACE_TRIES + 1))
    prof = trace_replayed_ticks(
        eng, MESH_OPEN, MESH_OPEN_NEEDS, run=eng.run,
        prepare=lambda: eng.submit_traffic(next(seeds), MESH_TRAFFIC))
    return rep, launches, summary, prof


# ---------------------------------------------------------------------------
# phase 4d: the mesh paths over a (cell, batch) grid of several entries
# ---------------------------------------------------------------------------

GRID = "grid"
GRID_SHAPES = ((4, 1), (2, 2))
SUP_GRID_SHAPE = (2, 1)
# report fields that follow the grid (the lane buckets are multiples of its
# cell axis), besides the wall-clock ones
GRID_FIELDS = ("mesh_shape", "n_filler_lanes")


def grid_mesh(shape: tuple, devices: list):
    """A ``CellMesh`` of ``shape`` over ``devices`` (repeated to fill it)."""
    import numpy as np

    from repro_torch.launch.mesh import CellMesh

    n = shape[0] * shape[1]
    arr = np.empty(n, dtype=object)
    arr[:] = [devices[i % len(devices)] for i in range(n)]
    return CellMesh(arr.reshape(shape))


def trajectory(sch, rep, faults: bool = False) -> dict:
    """What a grid run must share with the one-device run: the report
    outside its wall-clock and grid fields (and, with ``faults``, its
    fault fields), every cell's tick log, the finalized and queued ids."""
    import dataclasses

    d = _strip_report(rep, faults)
    for k in GRID_FIELDS:
        d.pop(k)
    return {"report": d,
            "ticks": [[dataclasses.asdict(t) for t in loop.tick_log]
                      for loop in sch.loops],
            "finalized": sch.finalized_job_ids(),
            "queued": sch.queued_job_ids()}


def _replays(sch) -> int:
    return sum(st.replays for st in captured_steps(sch))


def check_grid_lanes(sch, one, label: str, max_ticks: int = 10) -> dict:
    """One served grid bucket of at least two real lanes, every shard's
    inputs and outputs recorded as the scheduler served it and put back in
    lane order, against the one-device scheduler ``one``'s lane step of
    the same (group, rung, bucket) on the whole stack: CRC flags, payload
    bits, iteration counts, LLRs and combined LLRs bit for bit (the
    largest ``h_hat`` difference printed)."""
    import torch

    from repro_torch.serve.exec_registry import slot_schema
    from repro_torch.serve.runtime import BATCHED_KEYS

    orig, rec = sch._dispatch, {}

    def record(gi, mcs, lanes, staged, stats, prefetch=None):
        first = not rec and len(lanes) >= 2
        inputs = ([{k: v.clone() for k, v in sh.staged.items()}
                   for sh in staged] if first else None)
        nxt = orig(gi, mcs, lanes, staged, stats, prefetch)
        if first:
            key = (mcs, sch._bucket(len(lanes)), slot_schema(staged[0].staged))
            outs = [{k: v.clone() for k, v in st.out.items()
                     if isinstance(v, torch.Tensor)}
                    for st in sch.groups[gi]._execs[key]]
            rec.update(gi=gi, mcs=mcs, n=len(lanes), shards=list(staged),
                       inputs=inputs, outs=outs,
                       bucket=sch._bucket(len(lanes)))
        return nxt

    sch._dispatch = record
    try:
        for _ in range(max_ticks):
            sch.tick()
            if rec:
                break
    finally:
        del sch._dispatch
    check(bool(rec), f"{label}: no bucket of two real lanes in "
          f"{max_ticks} ticks")

    def whole(parts, key, dev):
        """Shards' ``key`` put back as one (lanes, batch, ...) stack."""
        rows = {}
        for sh, part in zip(rec["shards"], parts):
            v = part[key].to(dev)
            for i, lane in enumerate(range(sh.lanes.start, sh.lanes.stop)):
                rows.setdefault(lane, {})[sh.slots.start] = v[i]
        return torch.stack([torch.cat([r[s] for s in sorted(r)])
                            for _, r in sorted(rows.items())])

    dev = one.device
    first = rec["inputs"][0]
    inputs = {}
    for k in first:
        if k in BATCHED_KEYS:
            inputs[k] = whole(rec["inputs"], k, dev)
        elif k == "noise_var":
            inputs[k] = torch.cat([x[k].to(dev) for sh, x in
                                   zip(rec["shards"], rec["inputs"])
                                   if sh.slots.start == 0])
        else:
            inputs[k] = first[k].to(dev)
    g1 = one.groups[rec["gi"]]
    step = one.registry.acquire_pipeline_step(
        g1.pipelines[rec["mcs"]], inputs, batch=one.batch_size,
        lanes=rec["bucket"])
    want = step(inputs)
    torch.cuda.synchronize()
    for k in ("crc_ok", "info_bits_hat", "decode_iters", "llr", "cw_llr"):
        got = whole(rec["outs"], k, dev)
        check(got.shape == want[k].shape and torch.equal(got, want[k]),
              f"{label}: the grid's {k} differs from the one-device lane "
              "step's on the same lanes")
    got_h = whole(rec["outs"], "h_hat", dev)
    return {"lanes": rec["bucket"], "real_lanes": rec["n"],
            "shards": len(rec["shards"]),
            "rung": g1.rungs[rec["mcs"]].name,
            "h_hat_max_abs_err": float((got_h - want["h_hat"]).abs().max())}


def drive_grid_mesh(label: str, specs, kw: dict, n_ticks: int, needs: tuple,
                    mesh, one: dict, dev) -> tuple:
    """One mesh path on ``mesh``: every (group, rung, lane bucket, grid
    entry) step captured before the first TTI, the launch counts zeroed
    just before the run and read just after, the run's trajectory equal to
    the one-device run's (``one``), a bucket's lanes equal to the
    one-device lane step's, ten replayed ticks under CUPTI; returns
    (launches, traced launches, what to print)."""
    from repro_torch.kernels import _build
    from repro_torch.serve import ExecRegistry, MeshSlotScheduler

    wall = {}
    t0 = time.perf_counter()
    sch = MeshSlotScheduler(specs(), mesh=mesh, prebuild=True,
                            registry=ExecRegistry(), device=dev, **kw)
    wall["build_and_capture_s"] = time.perf_counter() - t0
    prebuilt = len(captured_steps(sch))
    check(prebuilt == mesh.size * sum(
        len(g.rungs) * len(sch._capture_buckets(g)) for g in sch.groups)
        and all(len(sts) == mesh.size for g in sch.groups
                for sts in g._execs.values()),
          f"{label}: {prebuilt} steps prebuilt")
    t0 = time.perf_counter()
    _build.reset_launches()
    rep = sch.run(n_ticks)
    launches = dict(_build.launches)
    wall["run_s"] = time.perf_counter() - t0
    replays = _replays(sch)
    counts = check_mesh_run(sch, rep, launches, label, needs)
    check(len(captured_steps(sch)) == prebuilt,
          f"{label}: {len(captured_steps(sch)) - prebuilt} steps captured "
          "in the run")
    check(trajectory(sch, rep) == one["trajectory"],
          f"{label}: the trajectory differs from the one-device run's")
    t0 = time.perf_counter()
    lanes = check_grid_lanes(sch, one["sch"], label)
    wall["lanes_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prof = trace_replayed_ticks(sch, label, needs)
    wall["trace_s"] = time.perf_counter() - t0
    out = {"mesh_shape": list(rep.mesh_shape),
           "steady_tick_ms": counts["steady_tick_ms"],
           "one_device_steady_tick_ms": one["counts"]["steady_tick_ms"],
           "replays_per_tick": replays / rep.n_ticks,
           "one_device_replays_per_tick": one["replays"] / n_ticks,
           "buckets_per_tick": counts["replays_per_tick"],
           "captures_per_tick": 0.0, "captures_before_first_tti": prebuilt,
           "filler_lanes": rep.n_filler_lanes,
           "one_device_filler_lanes": one["counts"]["filler_lanes"],
           "device_idle_share": prof["device_idle_share"],
           "one_device_idle_share": one["idle"],
           "traced_wall_ms_per_tick": prof["wall_ms"] / prof["ticks"],
           "lanes_vs_one_device": lanes, "wall": wall}
    return launches, prof["traced_launches"], out


def drive_grid_supervised(dev, devices: list, clean: dict) -> dict:
    """Phase 4c's canonical fault schedule (run 2) on a (2, 1) grid at lane
    bucket 2, the launch counts zeroed just before and read just after:
    the counts equal the plan's, and the trajectory equals phase 4c's
    clean one-device run's."""
    from repro_torch.kernels import _build
    from repro_torch.serve import ExecRegistry, FixedBuckets, Supervisor

    label = f"{SUP} {GRID} {SUP_GRID_SHAPE}"
    t0 = time.perf_counter()
    mesh = grid_mesh(SUP_GRID_SHAPE, devices)
    sup = Supervisor(_sup_specs(), mesh=mesh, prebuild=True,
                     registry=ExecRegistry(), device=dev,
                     bucket_policy=FixedBuckets((SUP_GRID_SHAPE[0],)),
                     fault_plan=clean["plan"], checkpoint_every=1, **SUP_KW)
    pre = {id(st) for st in captured_steps(sup)}
    _build.reset_launches()
    rep = sup.run(clean["ticks"])
    launches = dict(_build.launches)
    check_supervised_run(sup, rep, launches, pre, label)
    check(fault_counts(rep) == clean["counts"],
          f"{label}: fault counts {fault_counts(rep)}, want "
          f"{clean['counts']}")
    check(trajectory(sup, rep, faults=True) == clean["trajectory"],
          f"{label}: the trajectory differs from the clean run's")
    return {"mesh_shape": list(rep.mesh_shape), "faults": fault_counts(rep),
            "degradation_steps": sum(len(s) for s in
                                     sup._ref_execs.values()),
            "steady_tick_ms": rep.steady_tick_s * 1e3,
            "one_device_steady_tick_ms": clean["steady_tick_ms"],
            "launches": launches, "wall_s": time.perf_counter() - t0}


def drive_grids(dev, one: dict, clean: dict) -> tuple:
    """Phase 4d: each mesh path of phase 4b on the grids
    :data:`GRID_SHAPES`, then the supervised cluster on
    :data:`SUP_GRID_SHAPE`: over cuda:0 repeated on one card, and also
    over the distinct cards where there are several.  Returns (launches by
    path, traced launches by path, needs by path, what to print)."""
    import torch

    n_cards = torch.cuda.device_count()
    layouts = [("one card", [torch.device("cuda", 0)])]
    if n_cards >= 2:
        layouts.append((f"{n_cards} cards",
                        [torch.device("cuda", i) for i in range(n_cards)]))
    by_path, traced, needs_by, rows = {}, {}, {}, {}
    t0 = time.perf_counter()
    for where, devices in layouts:
        for label, specs, kw, n_ticks, needs in MESH_PATHS:
            for shape in GRID_SHAPES:
                path = f"{label} {GRID} {shape} on {where}"
                launches, tr, row = drive_grid_mesh(
                    path, specs, kw, n_ticks, needs,
                    grid_mesh(shape, devices), one[label], dev)
                by_path[path], traced[path], needs_by[path] = \
                    launches, tr, needs
                rows[path] = row
        rows[f"{SUP} {GRID} {SUP_GRID_SHAPE} on {where}"] = \
            drive_grid_supervised(dev, devices, clean)
    rows["phase 4d wall_s"] = time.perf_counter() - t0
    rows["cards"] = ("distinct cards and cuda:0 repeated" if n_cards >= 2
                     else "one card visible: every grid entry repeated "
                     "cuda:0; placement on distinct cards not run")
    return by_path, traced, needs_by, rows


# ---------------------------------------------------------------------------
# phase 4c: supervised fault-tolerant serving
# ---------------------------------------------------------------------------

SUP = "supervised mesh 4 cells (fp32 + int8)"
SUP_LADDER = "siso-coded"
SUP_NEEDS = ("ls_che", "mmse_detect_demap", "ldpc_decode", "ldpc_decode_q")
SUP_KW = dict(batch_size=8, deadline_ttis=4, max_retx=2, seed=0)
# a step's lanes at one rung: at most the group's 2 cells (8 users a cell
# at one SNR fill one batch of 8 per rung)
SUP_LANE_BUCKETS = (1, 2)
INT8_CELLS = (2, 3)
# report fields that follow the wall clock or the capture history, and
# the fault fields (tests/test_supervisor.py's sets)
WALL_FIELDS = ("wall_s", "slots_per_sec", "goodput_bits_per_sec",
               "compile_time_s", "executables_compiled", "cache_hits",
               "first_tick_s", "steady_tick_s")
FAULT_MESH_FIELDS = ("faults_injected", "step_retries", "degraded_batches",
                     "quarantined_batches", "batches_deferred",
                     "ticks_over_budget", "cell_quarantines", "crashes",
                     "recoveries", "jobs_failed")
FAULT_CELL_FIELDS = ("faults", "degraded_batches", "quarantined_batches",
                     "quarantine_ticks", "crashes", "jobs_failed")
# the single-cell supervised runner's case
SUP_RUNNER_SCENARIO = "siso-qam16-r12-snr15"


def _sup_specs() -> list:
    """A co-sited cluster of 4 cells: cells 0-1 on the fused fp32 chain,
    cells 2-3 on the fused int8 chain, which must survive a fault by
    falling back to the fp32 chain."""
    from repro_torch.serve import closed_cell

    return [closed_cell(f"cell{i}", SUP_LADDER, n_users=8, arrival_rate=0.8,
                        snr_db=8.0 + 0.5 * i, fused=True,
                        **({"precision": "int8"} if i in INT8_CELLS else {}))
            for i in range(4)]


def _strip_report(rep, faults: bool) -> dict:
    """A report as a dict without its wall-clock fields (and, with
    ``faults``, without its fault fields)."""
    import dataclasses

    d = dataclasses.asdict(rep)
    for k in WALL_FIELDS + (FAULT_MESH_FIELDS if faults else ()):
        d.pop(k)
    for c in d["cells"].values():
        for k in WALL_FIELDS + (FAULT_CELL_FIELDS if faults else ()):
            c.pop(k)
    return d


def _record(sch) -> dict:
    """Record as ``sch`` serves: each dispatch (its tick, its order in the
    tick, group, rung, cells and, on a supervisor, the seconds since the
    tick began), each served lane's CRC flags by (tick, cell) and, on a
    supervisor, each checkpoint save's seconds."""
    log = {"dispatch": [], "crc": {}, "checkpoint_s": []}
    dispatch, feedback = sch._dispatch, sch._feedback
    if hasattr(sch, "_save_checkpoint"):
        save = sch._save_checkpoint

        def timed_save(step: int) -> None:
            t0 = time.perf_counter()
            save(step)
            log["checkpoint_s"].append(time.perf_counter() - t0)

        sch._save_checkpoint = timed_save

    def record_dispatch(gi, mcs, lanes, staged, stats, prefetch=None):
        log["dispatch"].append({
            "tick": sch.now,
            "seq": sum(d["tick"] == sch.now for d in log["dispatch"]),
            "gi": gi, "mcs": mcs, "cells": [l.cell_idx for l in lanes],
            "since_tick_s": (time.perf_counter() - sch._tick_t0
                             if hasattr(sch, "_tick_t0") else None)})
        return dispatch(gi, mcs, lanes, staged, stats, prefetch)

    def record_feedback(lanes, mcs, crc_ok, cw_llr, stats):
        for li, lane in enumerate(lanes):
            log["crc"][(sch.now, lane.cell_idx)] = crc_ok[li].tolist()
        return feedback(lanes, mcs, crc_ok, cw_llr, stats)

    sch._dispatch, sch._feedback = record_dispatch, record_feedback
    return log


def drive_supervised(cls, n_ticks: int, dev, record: bool = False,
                     **kw) -> tuple:
    """One run of the 4-cell cluster under ``cls`` (``MeshSlotScheduler``
    or ``Supervisor`` with ``kw``), every (group, rung, bucket) step
    captured before the first TTI in a registry of its own, launch counts
    zeroed just before the run and read just after; returns (scheduler,
    report, launches, ids of the prebuilt steps, the record or None)."""
    from repro_torch.kernels import _build
    from repro_torch.serve import ExecRegistry, FixedBuckets

    sch = cls(_sup_specs(), prebuild=True, registry=ExecRegistry(),
              bucket_policy=FixedBuckets(SUP_LANE_BUCKETS), device=dev,
              **SUP_KW, **kw)
    prebuilt = {id(st) for st in captured_steps(sch)}
    check(len(prebuilt) == sum(len(g.rungs) * len(sch._capture_buckets(g))
                               for g in sch.groups),
          f"{SUP}: {len(prebuilt)} steps prebuilt")
    log = _record(sch) if record else None
    _build.reset_launches()
    rep = sch.run(n_ticks)
    return sch, rep, dict(_build.launches), prebuilt, log


def check_supervised_run(sch, rep, launches: dict, prebuilt: set,
                         label: str) -> None:
    """Jobs conserved exactly (finalized + queued + failed == submitted),
    one capture per step acquired (the prebuilt ones and each
    degradation step captured in the run), and launches equal to the
    captures x replays plus the eager warm-up of each step captured in the
    run."""
    failed = sch.failed_job_ids() if hasattr(sch, "failed_job_ids") else []
    ids = sorted(sch.finalized_job_ids() + sch.queued_job_ids() + failed)
    check(ids == list(range(sch.jobs_submitted)),
          f"{label}: job conservation broken")
    check(rep.jobs_failed == len(failed), f"{label}: jobs_failed")
    steps = captured_steps(sch)
    check(rep.executables_compiled == len(steps) == len(sch.registry)
          and all(st.graph is not None for st in steps),
          f"{label}: {rep.executables_compiled} captures for {len(steps)} "
          "steps acquired")
    want = derived_launches(sch)
    for st in steps:
        if id(st) not in prebuilt:
            want.update(st.warmup_launches)
    check(dict(+want) == {k: n for k, n in launches.items() if n},
          f"{label}: launches {launches} != captures x replays + the "
          f"warm-ups of steps captured in the run {dict(want)}")


def fault_counts(rep) -> dict:
    return {k: getattr(rep, k) for k in FAULT_MESH_FIELDS}


def _same_trajectory(sch, rep, base, base_rep, label: str) -> None:
    """``sch``'s run equal to the clean ``base`` run: the report outside
    its wall-clock and fault fields, every cell's tick log, and the
    finalized and queued job ids."""
    import dataclasses

    check(_strip_report(rep, True) == _strip_report(base_rep, True),
          f"{label}: the report differs from the clean run's")
    for a, b in zip(sch.loops, base.loops):
        check([dataclasses.asdict(t) for t in a.tick_log]
              == [dataclasses.asdict(t) for t in b.tick_log],
              f"{label}: {a.name}'s tick log differs from the clean run's")
    check(sch.finalized_job_ids() == base.finalized_job_ids()
          and sch.queued_job_ids() == base.queued_job_ids(),
          f"{label}: job ids differ from the clean run's")


def _drain(sch, max_ticks: int = 64) -> int:
    """Stop arrivals, lift the batch cap and the watchdog, tick until the
    backlog is empty; returns the ticks taken."""
    for loop in sch.loops:
        loop.arrival_rate = 0.0
        loop.max_batches_per_tick = None
    sch.watchdog_s = None
    for n in range(max_ticks):
        if sch.backlog == 0:
            return n
        sch.tick()
    check(False, f"{SUP}: the mesh did not drain (backlog {sch.backlog})")


def check_supervised_runner(dev) -> dict:
    """The single-cell guard: one batch of 8 ``siso-qam16-r12-snr15``
    slots on the fused int8 chain, ``inf`` in one slot's ``y_time``, served
    by ``SupervisedBatchRunner`` with the launch counts zeroed just before
    and read just after: one degraded batch, rerun once on the fp32
    unfused reference step, whose decoder is the fp32 one (the int8 chain
    has none)."""
    from repro_torch.kernels import _build
    from repro_torch.phy import link, scenarios
    from repro_torch.serve import (
        ExecRegistry, SlotRequest, SupervisedBatchRunner,
    )
    from repro_torch.serve.runtime import TorchSlotFactory

    scn = scenarios.get_scenario(SUP_RUNNER_SCENARIO)
    rx = link.build_pipeline("classical", scn, device=dev, fused=True,
                             precision="int8")
    factory = TorchSlotFactory(dev)
    slots = [factory(300 + i, scn, 1) for i in range(8)]
    slots[3]["y_time"] = slots[3]["y_time"].clone()
    slots[3]["y_time"][0, 0] = float("inf")
    reqs = [SlotRequest(user_id=i, slot=s) for i, s in enumerate(slots)]
    runner = SupervisedBatchRunner(rx, 8, registry=ExecRegistry())
    runner.warmup(reqs)
    (primary,) = runner._steps.values()
    _build.reset_launches()
    runner.run_batch(reqs)
    launches = dict(_build.launches)
    check(runner.degraded_batches == 1 and runner.retries == 0,
          f"supervised runner: {runner.degraded_batches} degraded, "
          f"{runner.retries} retries")
    (ref,) = runner._ref_execs.values()
    check("ldpc_decode" not in primary.launch_delta
          and ref.launch_delta == {"ldpc_decode": 1} and ref.replays == 1,
          f"supervised runner: primary launches {dict(primary.launch_delta)}"
          f", reference {dict(ref.launch_delta)} x {ref.replays}")
    want = collections.Counter(primary.launch_delta)
    want.update(ref.launch_delta)
    want.update(ref.warmup_launches)
    check(launches == dict(want),
          f"supervised runner: launches {launches} != {dict(want)}")
    return {"degraded_batches": runner.degraded_batches,
            "fp32_decoder_replays": ref.replays,
            "fp32_decoder_warmup_launches":
                ref.warmup_launches.get("ldpc_decode", 0),
            "launches": launches, "primary": rx.name,
            "reference": runner._ref.name}


def trace_degraded_dispatch(sup, gi8: int, max_ticks: int = 10) -> dict:
    """The CUPTI evidence that the degradation route launches the fp32
    decoder: tick ``sup`` until the int8 group ``gi8`` dispatches a bucket,
    inject a NaN burst into that bucket's first lane, and trace that one
    dispatch (its degradation step acquired just before, so the window
    captures nothing; :data:`TRACE_LEAD_LAUNCHES` small kernels and a pause
    first, since the start of a trace can miss launches), retaken on a
    later bucket (up to :data:`TRACE_TRIES` times) while a kernel of
    :data:`SUP_NEEDS` is missing. Fails unless the lane degraded, the
    degradation step replayed once, each kernel appears at least once and
    at most as often as the window's replays account for, and the fp32
    decoder exactly as often as the degradation step replayed (the int8
    group's own steps launch only ``ldpc_decode_q``)."""
    import torch

    from repro_torch.serve import FaultEvent, FaultInjector, FaultPlan

    inner = sup._dispatch
    traces: list = []
    armed = [False]

    def dispatch(gi, mcs, lanes, staged, stats, prefetch=None):
        if not armed[0] or gi != gi8:
            return inner(gi, mcs, lanes, staged, stats, prefetch)
        armed[0] = False
        bucket = sup._bucket(len(lanes))
        (ref,) = sup._ref_step(gi, mcs, bucket, staged)
        check(all("ldpc_decode" not in st.launch_delta
                  for st in _flat(sup.groups[gi]._execs.values())),
              f"{SUP}: an int8 step launches the fp32 decoder")
        sup.injector = FaultInjector(FaultPlan([FaultEvent(
            "nan_llr", tick=sup.now, seq=sup._seq,
            cell=lanes[0].cell_idx)]))
        replays0, degraded0 = ref.replays, sup.degraded_batches
        nxt = []

        def run():
            # late in a process a new trace can drop its first records:
            # small launches and a pause take them
            one = torch.ones(1, device=sup.device)
            for _ in range(TRACE_LEAD_LAUNCHES):
                one.add_(1)
            torch.cuda.synchronize()
            time.sleep(0.05)
            nxt.append(inner(gi, mcs, lanes, staged, stats, prefetch))

        traced = profile_window(sup, run, None)
        traced["degradation_replays"] = ref.replays - replays0
        traced["degraded"] = sup.degraded_batches - degraded0
        traced["step"] = [gi, mcs, bucket]
        traces.append(traced)
        return nxt[0]

    label = f"{SUP} degraded dispatch"
    sup._dispatch = dispatch
    for _ in range(TRACE_TRIES):
        armed[0] = True
        for _ in range(max_ticks):
            sup.tick()
            if not armed[0]:
                break
        check(not armed[0], f"{label}: the int8 group dispatched nothing "
              f"in {max_ticks} ticks")
        if all(traces[-1]["traced_launches"].get(k, 0) for k in SUP_NEEDS):
            break
    sup._dispatch = inner
    traced = dict(traces[-1], tries=len(traces))
    check(traced["captures_in_window"] == 0,
          f"{label}: a step was captured in the traced window")
    check(traced["degraded"] == 1 and traced["degradation_replays"] == 1,
          f"{label}: {traced['degraded']} lanes degraded, the degradation "
          f"step replayed {traced['degradation_replays']} times")
    got, want = traced["traced_launches"], traced["derived_launches"]
    for k in SUP_NEEDS:
        check(0 < got.get(k, 0) <= want.get(k, 0),
              f"{label}: {KERNEL_SYMBOLS[k]} traced {got.get(k, 0)} times "
              f"in a window whose replays account for {want.get(k, 0)} "
              f"(each try's traced launches: "
              f"{[t['traced_launches'] for t in traces]})")
    check(got["ldpc_decode"] == want["ldpc_decode"]
          == traced["degradation_replays"],
          f"{label}: {KERNEL_SYMBOLS['ldpc_decode']} traced "
          f"{got['ldpc_decode']} times, the degradation step replayed "
          f"{traced['degradation_replays']}")
    return traced


def drive_supervised_paths(dev) -> tuple:
    """Phase 4c: the 4-cell cluster in five runs (see the module doc);
    returns (the launches of the transparent-fault run, the CUPTI traces
    of its clean ticks and of a degraded dispatch, what to print, run 2's
    plan and clean trajectory for phase 4d)."""
    from repro_torch.kernels import _build
    from repro_torch.serve import (
        FaultEvent, FaultPlan, MeshSlotScheduler, Supervisor,
    )

    out = {}
    t0 = time.perf_counter()
    # the clean run: 10 TTIs for run 1, then 10 more for run 2
    base, base_rep10, base_launches, base_pre, log = drive_supervised(
        MeshSlotScheduler, 10, dev, record=True)
    check_supervised_run(base, base_rep10, base_launches, base_pre,
                         f"{SUP} clean")

    # run 1: zero faults, against the unsupervised mesh of the same seed,
    # in the order unsupervised, supervised, supervised, unsupervised, so
    # that a cost paid by whichever run comes first shows in both pairs
    steady_ms = {"unsupervised 1": base_rep10.steady_tick_s * 1e3}
    for name in ("supervised 1", "supervised 2", "unsupervised 2"):
        cls = MeshSlotScheduler if name.startswith("un") else Supervisor
        kw = {} if cls is MeshSlotScheduler else {
            "fault_plan": FaultPlan.none()}
        sch0, rep0, launches0, pre0, _ = drive_supervised(cls, 10, dev,
                                                          **kw)
        label = f"{SUP} zero-fault, {name}"
        check_supervised_run(sch0, rep0, launches0, pre0, label)
        check(_strip_report(rep0, False) == _strip_report(base_rep10, False),
              f"{label}: the report differs from the first unsupervised "
              "run's")
        if cls is Supervisor:
            check(not any(fault_counts(rep0).values())
                  and not sch0._ref_execs and sch0.injector.total == 0,
                  f"{label}: counted {fault_counts(rep0)}")
            faults0, summary0 = fault_counts(rep0), rep0.summary()
        steady_ms[name] = rep0.steady_tick_s * 1e3
        del sch0
    out["run 1 zero-fault"] = {
        "faults": faults0, "steady_tick_ms_in_run_order": steady_ms,
        "wall_s_with_the_clean_runs": time.perf_counter() - t0,
        "summary": summary0}
    t0 = time.perf_counter()
    _build.reset_launches()
    base.run(10)
    base_rep = base.report()
    base_launches = collections.Counter(base_launches)
    base_launches.update(_build.launches)
    check_supervised_run(base, base_rep, dict(base_launches), base_pre,
                         f"{SUP} clean")

    # run 2: the reference's canonical schedule (benchmarks/bench_faults.py
    # canonical_plan) on 4 cells, stragglers left out: a NaN burst on an
    # int8 cell, a corrupted slot on an fp32 cell, one retried step error,
    # a crash under per-tick checkpoints; seq addresses the bucket that
    # holds the target cell in the clean run
    def seq_of(tick: int, cell: int) -> int:
        return next(d["seq"] for d in log["dispatch"]
                    if d["tick"] == tick and cell in d["cells"])

    corrupted = ((1, INT8_CELLS[0]), (2, 1))
    plan = FaultPlan([
        FaultEvent("nan_llr", tick=1, seq=seq_of(*corrupted[0]),
                   cell=corrupted[0][1]),
        FaultEvent("corrupt_slot", tick=2, seq=seq_of(*corrupted[1]),
                   cell=corrupted[1][1]),
        FaultEvent("cell_crash", tick=3, cell=INT8_CELLS[1]),
        FaultEvent("step_error", tick=4, seq=0),
    ])
    sup, rep, launches, pre, slog = drive_supervised(
        Supervisor, 20, dev, record=True, fault_plan=plan,
        checkpoint_every=1)
    label = f"{SUP} transparent faults"
    check_supervised_run(sup, rep, launches, pre, label)
    for tick, cell in corrupted:
        got, want = slog["crc"][(tick, cell)], log["crc"][(tick, cell)]
        if got != want:
            print(f"{label}: degraded lane of cell {cell} at tick {tick}: "
                  f"CRC flags {got}, the clean run's {want}", flush=True)
        check(got == want, f"{label}: a degraded lane's CRC flags differ "
              "from the clean run's")
    check(slog["crc"] == log["crc"],
          f"{label}: served CRC flags differ from the clean run's")
    _same_trajectory(sup, rep, base, base_rep, label)
    counts = fault_counts(rep)
    check(counts == dict(faults_injected=len(plan), step_retries=1,
                         degraded_batches=len(corrupted),
                         quarantined_batches=0, batches_deferred=0,
                         ticks_over_budget=0, cell_quarantines=0,
                         crashes=1, recoveries=1, jobs_failed=0),
          f"{label}: fault counts {counts}")
    # what phase 4d holds the (2, 1) grid's run of the same plan to
    clean = {"plan": plan, "ticks": 20, "counts": counts,
             "trajectory": trajectory(base, base_rep, faults=True),
             "steady_tick_ms": rep.steady_tick_s * 1e3}
    # one degradation step per degraded (group, rung, lane bucket), each
    # captured once per (rung scenario, bucket): both groups' fp32 unfused
    # chain is the same step
    want_ref = {(d["gi"], d["mcs"], sup._bucket(len(d["cells"])))
                for d in slog["dispatch"]
                if any((d["tick"], c) in corrupted for c in d["cells"])}
    chains = {(sup.groups[gi].rungs[mcs].name, b) for gi, mcs, b in want_ref}
    check(set(sup._ref_execs) == want_ref
          and len(captured_steps(sup)) == len(pre) + len(chains),
          f"{label}: degradation steps {sorted(sup._ref_execs)}, want "
          f"{sorted(want_ref)}, {len(captured_steps(sup))} captures")
    # the int8 group launches the fp32 decoder only through its
    # degradation step, and at least once
    gi8 = sup.groups.index(sup._group_of[INT8_CELLS[0]])
    ref8 = [st for (gi, _, _), sts in sup._ref_execs.items() if gi == gi8
            for st in sts]
    check(all("ldpc_decode" not in st.launch_delta
              for st in _flat(sup.groups[gi8]._execs.values()))
          and all(set(st.launch_delta) == {"ldpc_decode"}
                  for st in _flat(sup._ref_execs.values()))
          and sum(st.replays for st in ref8) >= 1,
          f"{label}: the int8 group's fp32 decoder ran outside its "
          "degradation step, or not at all")
    since = collections.defaultdict(float)
    for d in slog["dispatch"]:
        since[d["tick"]] = max(since[d["tick"]], d["since_tick_s"])
    to_last_dispatch = max(since.values())
    out["run 2 transparent faults"] = {
        "plan": repr(plan), "faults": fault_counts(rep),
        "degradation_steps": sorted(sup._ref_execs),
        "int8_fp32_decoder_replays": sum(st.replays for st in ref8),
        "steady_tick_ms": rep.steady_tick_s * 1e3,
        "unsupervised_steady_tick_ms": base_rep.steady_tick_s * 1e3,
        "tick_start_to_last_dispatch_ms_max": to_last_dispatch * 1e3,
        "checkpoint_save_ms_median":
            statistics.median(slog["checkpoint_s"]) * 1e3,
        "captures_s": rep.compile_time_s,
        "captures": rep.executables_compiled,
        "wall_s": time.perf_counter() - t0,
        "summary": rep.summary()}

    # run 4: ten more clean ticks of run 2's supervisor under a CUPTI
    # trace; they capture nothing
    t0 = time.perf_counter()
    prof = trace_replayed_ticks(sup, SUP, SUP_NEEDS)
    out["run 4 traced ticks"] = {
        "wall_s": time.perf_counter() - t0,
        "device_idle_share": prof["device_idle_share"],
        "wall_ms_per_tick": prof["wall_ms"] / prof["ticks"],
        "captures": len(captured_steps(sup)),
        "prebuilt": len(pre)}
    # then one int8 bucket degraded under a CUPTI trace of its dispatch
    t0 = time.perf_counter()
    deg = trace_degraded_dispatch(sup, gi8)
    out["run 4 traced degraded dispatch"] = {
        "wall_s": time.perf_counter() - t0,
        "device_idle_share": deg["device_idle_share"],
        "traced_launches": deg["traced_launches"],
        "degradation_replays": deg["degradation_replays"],
        "tries": deg["tries"]}
    del sup, base

    # run 3: three stacked step errors on one bucket (quarantined with
    # max_step_retries=2), a straggler several times the watchdog's margin
    # past the budget, a crash against a stale checkpoint
    t0 = time.perf_counter()
    watchdog_s = 3.0 * to_last_dispatch
    straggle_s = 3.0 * watchdog_s
    plan3 = FaultPlan(
        [FaultEvent("step_error", tick=2, seq=0)] * 3
        + [FaultEvent("straggler", tick=5, seq=0, magnitude=straggle_s),
           FaultEvent("cell_crash", tick=8, cell=0)])
    sup3, rep3, launches3, pre3, _ = drive_supervised(
        Supervisor, 12, dev, fault_plan=plan3, checkpoint_every=3,
        max_step_retries=2, watchdog_s=watchdog_s)
    label = f"{SUP} escalation + watchdog + stale checkpoint"
    check_supervised_run(sup3, rep3, launches3, pre3, label)
    counts = fault_counts(rep3)
    check(rep3.faults_injected == len(plan3) and rep3.step_retries == 2
          and rep3.quarantined_batches > 0 and rep3.ticks_over_budget == 1
          and rep3.batches_deferred > 0 and rep3.crashes == 1
          and rep3.recoveries == 1 and rep3.jobs_shed == 0,
          f"{label}: fault counts {counts}, shed {rep3.jobs_shed}")
    drained = _drain(sup3)
    rep3d = sup3.report()
    check_supervised_run(sup3, rep3d, dict(_build.launches), pre3, label)
    check(rep3d.backlog_left == 0 and rep3d.harq_open == 0
          and sorted(sup3.finalized_job_ids() + sup3.failed_job_ids())
          == list(range(sup3.jobs_submitted)),
          f"{label}: drained to backlog {rep3d.backlog_left}, "
          f"{rep3d.harq_open} HARQ open")
    out["run 3 escalation"] = {
        "watchdog_ms": watchdog_s * 1e3, "straggler_ms": straggle_s * 1e3,
        "faults": counts, "drain_ticks": drained,
        "wall_s": time.perf_counter() - t0,
        "steady_tick_ms": rep3.steady_tick_s * 1e3,
        "summary": rep3d.summary()}
    del sup3

    # run 5: the single-cell runner
    t0 = time.perf_counter()
    out["run 5 SupervisedBatchRunner"] = check_supervised_runner(dev)
    out["run 5 SupervisedBatchRunner"]["wall_s"] = time.perf_counter() - t0
    return launches, prof, deg, out, clean


# ---------------------------------------------------------------------------
# phase 5: the paper's compute blocks and the quantized ops
# ---------------------------------------------------------------------------

BLOCKS = "fig10 blocks + quantized ops"
# the kernels the blocks path runs: the concurrent plans' fused kernels,
# the FC sequential plan's GEMM, and the quantized ops
BLOCKS_NEEDS = ("fc_softmax", "dwconv_block", "mha", "te_gemm",
                "te_gemm_quant", "mha_quant")
# each block: (label, plan name, reference gate between its two plans)
FIG10 = (
    ("FC + softmax (512x512)@(512x512)", "fc_softmax",
     dict(rtol=2e-4, atol=1e-5)),
    ("dwconv block (1, 34, 18, 512) -> 512", "dwconv",
     dict(rtol=5e-4, atol=5e-4)),
    ("MHA (4, 128, 128) causal", "mha", dict(rtol=2e-5, atol=2e-5)),
)


def _blocks_operands(dev) -> dict:
    import torch

    gen = _gen(dev, 10)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    return {
        "fc_softmax": (r(512, 512), r(512, 512) / math.sqrt(512),
                       0.1 * r(512)),
        "dwconv": _dw_operands(dev, 1, 32, 16, 512, 512, torch.float32),
        "mha": (r(4, 128, 128), r(4, 128, 128), r(4, 128, 128)),
        # (x, w, bias): 256^3, and DeepRx's block conv as a quantized
        # receiver would run it
        "gemm": [(r(256, 256), r(256, 256) / 16.0, 0.1 * r(256)),
                 (r(28672, 288), r(288, 32) / math.sqrt(288),
                  0.1 * r(32))],
        # (q, k, v, causal)
        "attention": [(r(4, 256, 64), r(4, 256, 64), r(4, 256, 64), True),
                      (r(32, 64, 16), r(32, 64, 16), r(32, 64, 16),
                       False)],
    }


def drive_blocks(dev, ops_in: dict) -> tuple:
    """The blocks path once, with the launch counts zeroed just before and
    read just after: each block's two plans, then every quantized op at
    int8 and fp8.  Returns (plan outputs, quantized outputs, launches)."""
    import torch

    from repro_torch.core import pool
    from repro_torch.kernels import _build, ops

    _build.reset_launches()
    plans = {}
    for _, block, _ in FIG10:
        kw = {"causal": True} if block == "mha" else {}
        plans[block] = tuple(getattr(pool, f"{block}_{plan}")(
            *ops_in[block], **kw) for plan in ("sequential", "concurrent"))
    quantized = []
    for prec in ("int8", "fp8"):
        for x, w, b in ops_in["gemm"]:
            quantized.append((("gemm", prec, x, w, b),
                              ops.te_gemm_quant(x, w, b, precision=prec)))
        for q, k, v, causal in ops_in["attention"]:
            quantized.append((("attention", prec, q, k, v, causal),
                              ops.mha_quant(q, k, v, precision=prec,
                                            causal=causal)))
    torch.cuda.synchronize()
    return plans, quantized, dict(_build.launches)


def check_blocks(ops_in: dict, plans: dict, quantized: list) -> dict:
    """Each block's plans agree within the reference's gate and with the
    plain twins; each quantized op agrees with its twin (the int8 GEMM
    bit for bit)."""
    import torch

    from repro_torch.kernels import dwconv_block, fc_softmax, mha, te_gemm

    twins = {"fc_softmax": fc_softmax.fc_softmax_torch,
             "dwconv": dwconv_block.dwconv_block_torch,
             "mha": lambda q, k, v: mha.mha_torch(q, k, v, causal=True)}
    errs = {}
    for label, block, gate in FIG10:
        seq, con = plans[block]
        check(bool(torch.isfinite(con).all()), f"{label}: non-finite")
        check(torch.allclose(seq, con, **gate),
              f"{label}: sequential and concurrent plans disagree "
              f"(max err {float((seq - con).abs().max())})")
        errs[block] = _hold(label, con, twins[block](*ops_in[block]),
                            torch.float32)
    for (kind, prec, *args), got in quantized:
        if kind == "gemm":
            x, w, b = args
            want = te_gemm.te_gemm_quant_torch(x, w, b, precision=prec)
            if prec == "int8":
                check(torch.equal(got, want), f"ops.te_gemm_quant int8 "
                      f"{tuple(x.shape)}x{tuple(w.shape)} not bit-exact")
            label = f"te_gemm_quant {prec} {tuple(x.shape)}@{tuple(w.shape)}"
        else:
            q, k, v, causal = args
            want = mha.mha_quant_torch(q, k, v, precision=prec,
                                       causal=causal)
            label = f"mha_quant {prec} {tuple(q.shape)}"
        errs[label] = _hold(label, got, want, torch.float32)
    return errs


# ---------------------------------------------------------------------------
# phase 6: training CE-ViT through the kernels
# ---------------------------------------------------------------------------

TRAIN = "cevit training"
TRAIN_NEEDS = ("te_gemm", "mha")
TRAIN_STEPS = 500
TRAIN_BATCH = 32
TRAIN_SNR_DB = 0.0
TRAIN_TRACE_STEPS = 10
# a step's forward: embed, 4 x (wqkv, wo, w1, w2) and head on te_gemm, one
# mha a layer; the backward is torch ops
TRAIN_PER_STEP = {"te_gemm": 18, "mha": 4}


class _TwinsInModels:
    """Within the block, CE-ViT's GEMMs and attention run the plain twins
    (autograd through torch ops) on the card: the gradient check's
    reference."""

    def __enter__(self):
        from repro_torch.kernels import mha, te_gemm
        from repro_torch.phy import models

        self.saved = models.te_gemm, models.mha
        models.te_gemm, models.mha = te_gemm.te_gemm_torch, mha.mha_torch

    def __exit__(self, *exc):
        from repro_torch.phy import models

        models.te_gemm, models.mha = self.saved


def _train_setup(dev, seed: int) -> tuple:
    """(config, seeded full-width weights, the slot generator, a batch
    source drawing the example's slots from it)."""
    from repro_torch.phy import models, ofdm
    from repro_torch.train import neural_receiver as nr

    cfg = models.CEViTConfig()
    gen = ofdm.make_generator(seed, dev)
    params = models.init_cevit(gen, cfg)
    return cfg, params, lambda i: ofdm.make_slot(gen, nr.GRID, TRAIN_BATCH,
                                                 TRAIN_SNR_DB)


def check_training_gradients(dev) -> dict:
    """One step's loss and every gradient leaf through the kernels against
    autograd through the twins, on the card, the same batch and weights:
    loss rtol 1e-4, each leaf's largest difference at most 1e-3 of that
    leaf's largest |g|."""
    import torch

    from repro_torch.common.params import tree_leaves
    from repro_torch.kernels import _build
    from repro_torch.train import neural_receiver as nr

    cfg, params, source = _train_setup(dev, 1)
    feats, h_true, _ = nr.make_batch(source(0), nr.GRID,
                                     nr.pilot_subcarriers(nr.GRID, dev), 1.0)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def step():
        loss = nr.loss_fn(params, cfg, feats, h_true)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    n0 = dict(_build.launches)
    loss, grads = step()
    launched = {k: _build.launches[k] - n0.get(k, 0) for k in TRAIN_NEEDS}
    check(launched == TRAIN_PER_STEP,
          f"{TRAIN}: a gradient step launched {launched}")
    with _TwinsInModels():
        loss_t, grads_t = step()
    rel = [float((a - b).abs().max()) / float(b.abs().max())
           for a, b in zip(grads, grads_t)]
    check(abs(loss - loss_t) <= 1e-4 * abs(loss_t),
          f"{TRAIN}: loss {loss} through the kernels, {loss_t} through the "
          "twins")
    check(max(rel) <= 1e-3, f"{TRAIN}: a gradient leaf differs by "
          f"{max(rel):.3g} of its largest |g| (limit 1e-3)")
    return {"loss_kernels": loss, "loss_twins": loss_t, "leaves": len(rel),
            "worst_leaf_rel_err": max(rel),
            "tolerance": "loss rtol 1e-4; each leaf max|diff| <= 1e-3 "
                         "max|g|"}


def trace_training(params, cfg, source) -> dict:
    """The measured evidence that training ran the kernels:
    :data:`TRAIN_TRACE_STEPS` more steps under a CUPTI trace, which must
    hold exactly
    :data:`TRAIN_PER_STEP` launches of each kernel a step (a trace that
    recorded fewer is taken again, up to :data:`TRACE_TRIES` times); the
    host wall, device busy time, idle share and device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train import neural_receiver as nr

    want = {k: n * TRAIN_TRACE_STEPS for k, n in TRAIN_PER_STEP.items()}
    for _ in range(TRACE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            nr.train(params, cfg, TRAIN_TRACE_STEPS, source)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = _device_events(prof)
        traced = {k: sum(1 for name, _ in events if pat in name)
                  for k, pat in KERNEL_SYMBOLS.items()}
        if all(traced[k] >= n for k, n in want.items()):
            break
    for k, n in want.items():
        check(traced[k] == n, f"{TRAIN}: {KERNEL_SYMBOLS[k]} traced "
              f"{traced[k]} times in {TRAIN_TRACE_STEPS} steps, not {n}")
    check(not any(n for k, n in traced.items() if k not in want),
          f"{TRAIN}: other ported kernels traced: {traced}")
    by_name: dict = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "steps": TRAIN_TRACE_STEPS, "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "device_events": len(events),
        "traced_launches": {k: n for k, n in traced.items() if n},
        "ported_kernels_ms": {k: sum(us for name, us in by_name.items()
                                     if KERNEL_SYMBOLS[k] in name) / 1e3
                              for k in want},
        "top_device_ms": [(name[:60], us / 1e3) for name, us in top],
    }


def drive_training(dev) -> tuple:
    """The training path once at full width (:class:`CEViTConfig`'s
    default on the example's 128-subcarrier grid, batch 32, 0 dB), with
    the launch counts zeroed just before and read just after: exactly
    :data:`TRAIN_PER_STEP` a step.  Then CE-ViT must beat LS on a
    held-out batch, and a traced window of more steps must show the
    kernels.  Returns (launches, summary, trace)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.phy import ofdm
    from repro_torch.train import neural_receiver as nr

    cfg, params, source = _train_setup(dev, 0)
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = nr.train(params, cfg, TRAIN_STEPS, source).tolist()
    wall_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    for k, n in TRAIN_PER_STEP.items():
        check(launches.get(k, 0) == n * TRAIN_STEPS,
              f"{TRAIN}: {k} launched {launches.get(k, 0)} times in "
              f"{TRAIN_STEPS} steps, not {n} a step")
    check(sum(launches.values()) == sum(TRAIN_PER_STEP.values())
          * TRAIN_STEPS, f"{TRAIN}: other kernels launched: {launches}")
    check(all(math.isfinite(x) for x in losses), f"{TRAIN}: loss not finite")
    held_out = ofdm.make_slot(ofdm.make_generator(nr.EVAL_SEED, dev),
                              nr.GRID, TRAIN_BATCH, TRAIN_SNR_DB)
    mse = nr.evaluate(params, cfg, held_out)
    check(mse["cevit"] < mse["ls"], f"{TRAIN}: CE-ViT's held-out MSE "
          f"{mse['cevit']} is not below LS's {mse['ls']}")
    summary = {
        "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "snr_db": TRAIN_SNR_DB,
        "wall_s": wall_s, "ms_per_step": wall_s / TRAIN_STEPS * 1e3,
        "loss_at_step": {i: losses[i] for i in
                         (*range(0, TRAIN_STEPS, 100), TRAIN_STEPS - 1)},
        "held_out_mse": mse,
    }
    return launches, summary, trace_training(params, cfg, source)


# ---------------------------------------------------------------------------
# phase 7: the autotuner over the kernels' own launch choices
# ---------------------------------------------------------------------------

TUNE = "autotune"
TUNE_ITERS = 10  # timed calls a candidate in each tuner's search


def _tune_gemm_case(dev, label: str, m: int, k: int, n: int, dt: str):
    """``te_gemm`` (float32 / bfloat16) or ``te_gemm_quant`` (int8 /
    float8_e4m3fn codes) at (m, k) @ (k, n), epilogue none: every
    candidate and the public wrapper against the twin, fp32 at rtol 1e-4,
    bf16 at one bf16 step, int8 bit for bit, e4m3 at the fp32 gate."""
    import torch

    from repro_torch.kernels import quant, te_gemm, tune

    dtype = getattr(torch, dt)
    gen = _gen(dev, m + 7 * k + 13 * n)
    x = torch.randn(m, k, generator=gen, device=dev)
    w = torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)
    if dtype in (torch.float32, torch.bfloat16):
        x, w = x.to(dtype), w.to(dtype)
        run = lambda c=None: te_gemm.te_gemm(x, w, choice=c)
        want = te_gemm.te_gemm_torch(x, w)
        hold = lambda got: _hold(f"{TUNE} te_gemm[{label} {dt}]", got, want,
                                 dtype)
        counter, symbols, tol = "te_gemm", TE_GEMM_SYMBOLS, \
            _tolerance(dtype)[1]
    else:
        prec = quant.precision_of_dtype(dtype)
        run = lambda c=None: te_gemm.te_gemm_quant(x, w, precision=prec,
                                                   choice=c)
        want = te_gemm.te_gemm_quant_torch(x, w, precision=prec)
        if prec == "int8":
            def hold(got):
                check(torch.equal(got, want), f"{TUNE} te_gemm[{label} "
                      f"{dt}] is not bit-exact against its twin")
                return 0.0
            tol = "bit-exact (int32 product, the twin's dequant order)"
        else:
            hold = lambda got: _hold(f"{TUNE} te_gemm[{label} {dt}]", got,
                                     want, torch.float32)
            tol = _tolerance(torch.float32)[1]
        counter, symbols = "te_gemm_quant", TE_GEMM_QUANT_SYMBOLS
    return dict(
        label=f"te_gemm {label} ({m}x{k})@({k}x{n}) {dt}", counter=counter,
        symbols=symbols, tolerance=tol, run=run, hold=hold,
        candidates=te_gemm.block_shape_candidates(m, n, k, dtype),
        heuristic=te_gemm.pick_block_shape(m, n, k, dtype),
        tune=lambda t: tune.autotune_gemm(m, n, k, dtype, iters=TUNE_ITERS,
                                          device=dev, timings=t))


def _tune_mha_case(dev, bh: int, sq: int, sk: int, d: int, causal: bool):
    import torch

    from repro_torch.kernels import _build, mha, tune

    gen = _gen(dev, bh * sq + d)
    q, k, v = (torch.randn(bh, s, d, generator=gen, device=dev)
               for s in (sq, sk, sk))
    label = f"({bh}, {sq}, {sk}, {d}) {'causal' if causal else 'full'}"
    want = mha.mha_torch(q, k, v, causal=causal)
    return dict(
        label=f"mha {label} float32", counter="mha",
        symbols=KERNEL_SYMBOLS["mha"], tolerance=_tolerance(torch.float32)[1],
        run=lambda c=None: mha.mha(q, k, v, causal=causal, choice=c),
        hold=lambda got: _hold(f"{TUNE} mha[{label}]", got, want,
                               torch.float32),
        candidates=mha.cluster_candidates(bh, sq, sk, d, causal),
        heuristic=mha.pick_cluster(bh, sq, sk, d, causal, torch.float32,
                                   _build.sm_count(
                                       torch.cuda.current_device())),
        tune=lambda t: tune.autotune_mha(bh, sq, sk, d, causal=causal,
                                         iters=TUNE_ITERS, device=dev,
                                         timings=t))


def _tune_demap_case(dev, name: str, args: tuple, sic: bool):
    """Joint or SIC detect + demap: every candidate bit for bit against
    the twin (every tile runs each RE's chain in the same order)."""
    import torch

    from repro_torch.kernels import rx_fused, tune

    y, h, nv, modem = args
    b, n_sym, n_sc, n_rx = y.shape
    n_tx = h.shape[-1]
    nb = modem.bits_per_symbol // 2
    kernel = rx_fused.sic_detect_demap if sic else rx_fused.mmse_detect_demap
    twin = (rx_fused.sic_detect_demap_torch if sic
            else rx_fused.mmse_detect_demap_torch)
    want = twin(*args)
    op = "sic" if sic else "detect"

    def hold(got):
        check(all(torch.equal(a, w) for a, w in zip(got, want)),
              f"{TUNE} {op}[{name}] is not bit-exact to its twin")
        return 0.0

    counter = "sic_detect_demap" if sic else "mmse_detect_demap"
    return dict(
        label=f"{op} {name} B={b}", counter=counter,
        symbols=KERNEL_SYMBOLS[counter],
        tolerance="bit-exact (x_hat, nv_eff and LLRs equal)",
        run=lambda c=None: kernel(*args, choice=c), hold=hold,
        candidates=rx_fused.subcarrier_tile_candidates(sic, n_rx, n_tx, nb),
        heuristic=rx_fused.pick_subcarrier_tile(sic, n_sym, n_sc, n_rx, n_tx,
                                                nb),
        tune=lambda t: (tune.autotune_rx_sic if sic
                        else tune.autotune_rx_detect)(
            b, n_sym, n_sc, n_rx, n_tx, modem, iters=TUNE_ITERS,
            device=dev, timings=t))


def _tune_ldpc_case(dev, precision):
    """Both decoders at r12 over 216 codewords at +3 dB: every candidate's
    posteriors and iteration counts bit for bit against the twin.  The
    tuner times the fp32 decoder; both read its winner."""
    import torch

    from repro_torch.kernels import ldpc, tune
    from repro_torch.phy import coding

    code = coding.make_code("r12")
    llr = _code_llrs(code, 216, 3.0, dev)
    want = ldpc.ldpc_decode_torch(llr, code, precision=precision)
    dp = precision or "fp32"

    def hold(got):
        check(torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]),
              f"{TUNE} ldpc {dp}: posteriors or iteration counts differ")
        return 0.0

    counter = "ldpc_decode_q" if precision else "ldpc_decode"
    return dict(
        label=f"ldpc_decode {dp} r12 +3dB 216cw", counter=counter,
        symbols=KERNEL_SYMBOLS[counter],
        tolerance="posteriors and iteration counts exact",
        run=lambda c=None: ldpc.ldpc_decode(llr, code, precision=precision,
                                            choice=c), hold=hold,
        candidates=ldpc.segment_candidates(code),
        heuristic=ldpc.pick_segment(code),
        tune=lambda t: tune.autotune_ldpc(216, code, iters=TUNE_ITERS,
                                          device=dev, timings=t))


def _tune_ls_case(dev, name: str):
    import torch

    from repro_torch.kernels import rx_fused, tune
    from repro_torch.phy import coding, ofdm, scenarios

    scn = scenarios.get_scenario(name)
    g = scn.grid
    y = _grid_y(coding.make_coded_slot(ofdm.make_generator(1, dev), scn, 8))
    op = torch.from_numpy(rx_fused.make_ls_interp_operator(
        g.n_subcarriers, g.n_tx, g.pilot_stride,
        ofdm.pilot_sequence_np(g))).to(dev)
    args = (y, g.pilot_symbols, g.pilot_stride, op)
    want = rx_fused.ls_che_torch(*args)

    def hold(got):
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
              f"{TUNE} ls_che[{name}] disagrees with its twin ({err})")
        return err

    b, n_sc, n_rx = y.shape[0], g.n_subcarriers, g.n_rx
    return dict(
        label=f"ls_che {name} B={b}", counter="ls_che",
        symbols=KERNEL_SYMBOLS["ls_che"], tolerance="rtol 1e-5, atol 1e-6",
        run=lambda c=None: rx_fused.ls_che(*args, choice=c), hold=hold,
        candidates=rx_fused.threads_per_output_candidates(b * n_rx),
        heuristic=rx_fused.pick_threads_per_output(
            n_sc, n_rx, g.n_tx, op.shape[1], b * n_rx),
        tune=lambda t: tune.autotune_rx_ls_che(
            b, g.n_symbols, n_sc, n_rx, g.n_tx, g.pilot_stride,
            g.pilot_symbols, iters=TUNE_ITERS, device=dev, timings=t))


def _tune_cases(dev):
    """Phase 7's cases at the main paths' shapes: te_gemm at DeepRx's
    block conv (fp32, bf16, int8, e4m3) and CE-ViT's training wqkv; mha at
    CE-ViT's (32, 64, 64, 16) and (16, 256, 256, 64) causal; detect at
    SISO-16QAM and 4x8-64QAM; SIC at the MU grid and 8x6 (all B = 8);
    both decoders at r12 over 216 codewords; ls_che at the three grids."""
    from repro_torch.phy import ofdm, scenarios

    for dt in ("float32", "bfloat16", "int8", "float8_e4m3fn"):
        yield _tune_gemm_case(dev, "deeprx block conv2", 28672, 288, 32, dt)
    yield _tune_gemm_case(dev, "training wqkv", 1024, 128, 384, "float32")
    yield _tune_mha_case(dev, 32, 64, 64, 16, False)
    yield _tune_mha_case(dev, 16, 256, 256, 64, True)
    demap = dict(_demap_inputs(dev))
    for name in ("siso-qam16-r12-snr15", "mimo4x8-qam64-snr24"):
        yield _tune_demap_case(dev, name, demap[name], sic=False)
    mu = scenarios.get_scenario("mimo4x4-qam16-mu-snr18")
    slot = mu.make_batch(ofdm.make_generator(2, dev), 8)
    yield _tune_demap_case(dev, mu.name, (
        _grid_y(slot), slot["h"][:, 0].contiguous(), slot["noise_var"],
        mu.modem), sic=True)
    yield _tune_demap_case(dev, "8x6-qam16", demap["8x6-qam16 (no instance)"],
                           sic=True)
    yield _tune_ldpc_case(dev, None)
    yield _tune_ldpc_case(dev, "int8")
    for name in ("siso-qam16-r12-snr15", "mimo2x2-qam16-r12-snr17",
                 "mimo4x4-qam16-mu-snr18"):
        yield _tune_ls_case(dev, name)


def drive_autotune(dev) -> list:
    """Phase 7: each case's every candidate against the twin at the row's
    tolerance, its device us (CUPTI), the heuristic's choice; then the
    op's tuner once (CUDA events, the median of :data:`TUNE_ITERS` calls a
    candidate), its winner stored in the run's cache; then the public
    wrapper, with no choice, must launch the winner (its launch record)
    and still equal the twin.  The int8 decoder reuses the fp32 one's
    winner (one key, as in the reference)."""
    from repro_torch.kernels import _build

    rows, winners = [], {}
    cases = list(_tune_cases(dev))  # every heuristic read before any store
    for case in cases:
        cands = {}
        for c in case["candidates"]:
            err = case["hold"](case["run"](c))
            check(_build.launch_choices[case["counter"]] == c,
                  f"{TUNE} {case['label']}: launched "
                  f"{_build.launch_choices[case['counter']]}, not {c}")
            cands[c] = {"max_abs_err": err, "device_us": device_us(
                lambda: case["run"](c), case["symbols"])}
        check(case["heuristic"] in cands, f"{TUNE} {case['label']}: the "
              f"heuristic {case['heuristic']} is not a candidate")
        timings = {}
        key = case["counter"].replace("ldpc_decode_q", "ldpc_decode")
        if key == "ldpc_decode" and key in winners:
            winner = winners[key]
        else:
            winner = case["tune"](timings)
            winners[key] = winner
        check(winner in cands, f"{TUNE} {case['label']}: winner {winner} "
              "is not a candidate")
        err = case["hold"](case["run"]())
        check(_build.launch_choices[case["counter"]] == winner,
              f"{TUNE} {case['label']}: the wrapper launched "
              f"{_build.launch_choices[case['counter']]}, not the stored "
              f"winner {winner}")
        rows.append({
            "case": case["label"], "tolerance": case["tolerance"],
            "candidates": {str(c): v for c, v in cands.items()},
            "tuner_event_us": {str(c): us for c, us in timings.items()},
            "heuristic": str(case["heuristic"]), "winner": str(winner),
            "heuristic_device_us": cands[case["heuristic"]]["device_us"],
            "winner_device_us": cands[winner]["device_us"],
            "wrapper_launched": str(_build.launch_choices[case["counter"]]),
            "wrapper_max_abs_err": err,
        })
    return rows


# ---------------------------------------------------------------------------
# phase 8: the LM model zoo (repro_torch.configs, repro_torch.models)
# ---------------------------------------------------------------------------

LM = "lm zoo"
LM_SMOKE_BATCH, LM_SMOKE_SEQ, LM_SMOKE_DECODE = 2, 17, 4
# card against CPU at fp32 (TF32 off): |card - cpu| <= rtol |cpu| + atol x
# max |cpu|.  The card's exp, rsqrt and tanh differ from the CPU's by an
# ulp or two, and each arch amplifies that by its own conditioning (one
# ulp of weight noise moves the smoke logits by 4e-6 to 3e-5 of their
# largest value, whisper-tiny's most; tests/_lm_parity.py), so atol is
# 5e-5 of max where the CPU tests hold the port to the reference at
# 1e-5, and 5e-4 for whisper-tiny (1e-4 there)
LM_RTOL, LM_ATOL = 1e-4, 5e-5
LM_ATOL_BY_ARCH = {"whisper-tiny": 5e-4}
# one model per family at its published width, batch 2: (arch, layers kept
# (None: all of them), text tokens of the prompt); pixtral's prompt adds
# its 1024 stub image tokens, whisper's encoder its 1500 stub frames
LM_FULL = (("llama3-8b", None, 256), ("moonshot-v1-16b-a3b", 4, 256),
           ("pixtral-12b", 4, 256), ("zamba2-7b", None, 256),
           ("rwkv6-1.6b", None, 256), ("whisper-tiny", None, 64))
LM_BATCH = 2
LM_WARM_STEPS = 2  # untimed decode steps ahead of the timed ones
LM_DECODE_STEPS = 16
LM_TRACED_STEPS = 10
# a stack of random layers is chaotic: rounding differences between the
# prefill and decode paths grow with depth, about tenfold a layer past
# the second in llama3-8b at full width (the schema's "scaled" init
# takes the second-to-last dim as the fan-in, the head count for wq and
# wk, so the scores are large and the softmax nearly one-hot), in the
# reference too (16 layers
# of llama3 at width 256 miss the check in both packages:
# tests/test_torch_models.py::
# test_consistency_error_grows_with_depth_in_both_packages).  These
# models are held to the check at the first depth listed (zamba2: one
# super-block and a tail layer); the others and the full depth are
# printed
LM_CONSISTENCY_LAYERS = {"llama3-8b": (2, 4, 8), "zamba2-7b": (7, 12, 24)}
# (d) serving through ServeEngine: launch/serve.py's workload (8 requests,
# prompts of 4-32 tokens from default_rng(0), batch 4, 16 new tokens,
# max_len 256 past the prompt's stub image tokens), decode one CUDA graph
LM_SERVE_REQUESTS, LM_SERVE_BATCH, LM_SERVE_NEW, LM_SERVE_LEN = 8, 4, 16, 256
LM_GRAPH_STEPS = 16  # timed replays of the captured decode step


def _lm_close(got, want, rtol: float, atol: float, what: str) -> float:
    """Elementwise ``|got - want| <= rtol |want| + atol x max |want|`` (on
    the host); returns the largest error over max |want|."""
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    check(g.shape == w.shape, f"{LM} {what}: shape {tuple(g.shape)} != "
          f"{tuple(w.shape)}")
    scale = float(w.abs().max()) or 1.0
    err = (g - w).abs()
    check(bool((err <= rtol * w.abs() + atol * scale).all()),
          f"{LM} {what}: card against CPU, max error {float(err.max()):.3g} "
          f"at scale {scale:.3g}")
    return float(err.max()) / scale


def check_lm_smoke(dev) -> dict:
    """(a) Every arch's smoke config on the card against the same module on
    the CPU, the same weights (drawn on the CPU, copied) and tokens: the
    forward logits, the prefill's and each of 4 decode steps' logits and
    every cache leaf after each.  Returns the largest error over scale by
    arch."""
    import torch

    from repro_torch.common.params import tree_map
    from repro_torch.configs import ARCH_IDS, ShapeConfig, get_smoke_config
    from repro_torch.models import get_model

    b, s, steps = LM_SMOKE_BATCH, LM_SMOKE_SEQ, LM_SMOKE_DECODE
    worst = {}
    for arch in ARCH_IDS:
        m = get_model(get_smoke_config(arch))
        gen = torch.Generator().manual_seed(0)
        p_cpu = m.init(gen)
        inputs = m.make_inputs(gen, ShapeConfig("lm", s, b, "prefill"))
        toks = torch.randint(0, m.cfg.vocab_size, (steps, b, 1),
                             generator=gen, dtype=torch.int32)
        p_dev = tree_map(lambda t: t.to(dev), p_cpu)

        def run(params, device):
            batch = {k: v.to(device) for k, v in inputs.items()}
            out = [("forward", m.forward(params, batch)[0])]
            cache = m.init_cache(b, 32, device=device)
            logits, cache = m.prefill(params, batch, cache)
            out += [("prefill", logits)] + [
                (f"prefill {k}", cache[k].clone()) for k in sorted(cache)]
            for i, t in enumerate(toks):
                logits, cache = m.decode_step(params, t.to(device), cache)
                out += [(f"decode {i}", logits)] + [
                    (f"decode {i} {k}", cache[k].clone())
                    for k in sorted(cache)]
            return out

        with torch.no_grad():
            want, got = run(p_cpu, "cpu"), run(p_dev, dev)
        errs = []
        for (what, w), (_, g) in zip(want, got):
            check(g.device.type == torch.device(dev).type,
                  f"{LM} {arch} {what} off the card")
            if what.endswith(" pos"):
                check(int(g) == int(w), f"{LM} {arch} {what}: {int(g)} != "
                      f"{int(w)}")
                continue
            errs.append(_lm_close(g, w, LM_RTOL,
                                  LM_ATOL_BY_ARCH.get(arch, LM_ATOL),
                                  f"{arch} {what}"))
        worst[arch] = max(errs)
    return worst


def _lm_events_ms(fn, reps: int) -> list:
    """Milliseconds of each of ``reps`` calls of ``fn`` by CUDA events,
    read after the last call."""
    import torch

    marks = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in marks]


def _lm_trace(run, steps: int) -> dict:
    """Host wall, device busy time and idle share over ``steps`` calls of
    ``run`` under a CUPTI trace (``profile_window``'s method; device
    activity only, which keeps the trace of thousands of launches a step
    quick to read)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = _device_events(prof)
    check(bool(events), f"{LM}: the traced decode steps hold no device "
          "event")
    busy = sum(us for _, us in events)
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "device_events_per_step": len(events) / steps}


def _lm_consistency(m, params, batch, seq: int, dev) -> float:
    """The reference test's check on the card: decode(prefill(t[:-1]),
    t[-1]) against prefill(t)'s last logits, err / scale."""
    full, _ = m.prefill(params, batch, m.init_cache(LM_BATCH, seq,
                                                    device=dev))
    pre = dict(batch, tokens=batch["tokens"][:, :-1])
    _, cache = m.prefill(params, pre, m.init_cache(LM_BATCH, seq,
                                                   device=dev))
    dec, _ = m.decode_step(params, batch["tokens"][:, -1:], cache)
    err = float((dec[:, 0] - full[:, 0]).abs().max())
    return err / (float(full.abs().max()) + 1e-6)


def _lm_model(dev, cfg, seq: int, seed: int = 0) -> tuple:
    """(model, weights drawn on the card from ``seed``, a prompt batch)."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.models import get_model

    m = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = m.init(gen)
    return m, params, m.make_inputs(gen, ShapeConfig("lm", seq, LM_BATCH,
                                                     "prefill"))


def lm_requests(vocab: int) -> list:
    """``launch/serve.py``'s requests (its ``--seed 0`` draws)."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(0)
    return [Request(prompt=rng.integers(0, vocab, size=(
        int(rng.integers(4, 32)),)).astype(np.int32),
        max_new_tokens=LM_SERVE_NEW) for _ in range(LM_SERVE_REQUESTS)]


def lm_serve_len(cfg) -> int:
    return LM_SERVE_LEN + (cfg.num_image_tokens if cfg.family == "vlm"
                           else 0)


def eager_greedy(m, params, reqs: list, max_len: int, dev) -> tuple:
    """The reference engine's batches run eagerly by this script, apart
    from the engine: left-padded prompts (token 0, no mask), zero stub
    embeddings, ``model.prefill``, then ``max(max_new_tokens)`` steps of
    record / ``model.decode_step`` / argmax.  -> (tokens per request,
    CUDA-event ms of every decode step)."""
    import torch

    cfg, b = m.cfg, LM_SERVE_BATCH
    out, step_ms = [], []
    for i in range(0, len(reqs), b):
        part = reqs[i:i + b]
        plen = max(len(r.prompt) for r in part)
        prompts = torch.zeros((b, plen), dtype=torch.int32)
        for j, r in enumerate(part):
            prompts[j, plen - len(r.prompt):] = torch.from_numpy(r.prompt)
        batch = {"tokens": prompts.to(dev)}
        if cfg.family == "audio":
            batch["audio_embeds"] = torch.zeros(
                (b, cfg.enc_ctx, cfg.d_model), dtype=cfg.dtype(), device=dev)
        elif cfg.family == "vlm":
            batch["image_embeds"] = torch.zeros(
                (b, cfg.num_image_tokens, 1024), dtype=cfg.dtype(),
                device=dev)
        logits, cache = m.prefill(params, batch,
                                  m.init_cache(b, max_len, device=dev))
        state = {"tok": torch.argmax(logits[:, -1, :], -1)[:, None].to(
            torch.int32), "rec": []}

        def step():
            state["rec"].append(state["tok"][:, 0].clone())
            logits, _ = m.decode_step(params, state["tok"], cache)
            state["tok"] = torch.argmax(logits[:, -1, :], -1)[:, None].to(
                torch.int32)

        step_ms += _lm_events_ms(step, max(r.max_new_tokens for r in part))
        rec = torch.stack(state["rec"]).cpu()
        for j, r in enumerate(part):
            out.append(rec[:r.max_new_tokens, j].tolist())
    return out, step_ms


def drive_lm_serve(m, params, dev) -> dict:
    """(d) ``ServeEngine`` on ``launch/serve.py``'s workload: (i) its
    tokens equal :func:`eager_greedy`'s token for token; (ii) one capture
    per engine and one replay a decode step (the engine's counts and the
    captured step's); (iii) a second ``generate`` under a CUPTI trace
    captures nothing.  Returns the graph's decode ms a step (CUDA events,
    median of 16 replays), the eager steps' (the same batches), generate
    tokens/s (host wall of a whole ``generate``, eager prefills
    included) and the traced ``generate``'s idle share."""
    import torch

    from repro_torch.serve import ServeEngine

    cfg = m.cfg
    max_len = lm_serve_len(cfg)
    eng = ServeEngine(m, params, batch_size=LM_SERVE_BATCH, max_len=max_len,
                      device=dev)
    t_start = t0 = time.perf_counter()
    reqs = eng.generate(lm_requests(cfg.vocab_size))  # captures
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want, eager_ms = eager_greedy(m, params, lm_requests(cfg.vocab_size),
                                  max_len, dev)
    eager_s = time.perf_counter() - t0
    for k, (r, w) in enumerate(zip(reqs, want)):
        check(r.out_tokens == w, f"{LM} {cfg.arch} (d): request {k}'s "
              f"tokens {r.out_tokens} != the eager loop's {w}")
    n_steps = LM_SERVE_NEW * math.ceil(LM_SERVE_REQUESTS / LM_SERVE_BATCH)
    check(eng.captures == 1 and eng.replays == eng.decoder.replays
          == n_steps and eng.decoder.graph is not None,
          f"{LM} {cfg.arch} (d): {eng.captures} captures, {eng.replays} / "
          f"{eng.decoder.replays} replays for {n_steps} decode steps")
    decoder = eng.decoder
    graph_ms = _lm_events_ms(decoder.replay, LM_GRAPH_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = eng.generate(lm_requests(cfg.vocab_size))
    wall_s = time.perf_counter() - t0
    check([r.out_tokens for r in again] == want,
          f"{LM} {cfg.arch} (d): a second generate differs")
    replays = eng.replays
    t0 = time.perf_counter()
    trace = _lm_trace(lambda: eng.generate(lm_requests(cfg.vocab_size)), 1)
    trace_s = time.perf_counter() - t0
    check(eng.captures == 1 and eng.decoder is decoder
          and eng.replays == replays + n_steps,
          f"{LM} {cfg.arch} (d): the traced generate captured or replayed "
          f"off count ({eng.captures} captures, "
          f"{eng.replays - replays} replays)")
    tokens = sum(len(r.out_tokens) for r in again)
    return {"serve_batch": LM_SERVE_BATCH, "serve_max_len": max_len,
            "serve_requests": LM_SERVE_REQUESTS, "serve_tokens": tokens,
            "graph_decode_ms_per_step": statistics.median(graph_ms),
            "eager_decode_ms_per_step_b4": statistics.median(eager_ms),
            "first_generate_s": first_s, "eager_loop_s": eager_s,
            "traced_generate_s": trace_s,
            "serve_wall_s": time.perf_counter() - t_start,
            "generate_tokens_per_s": tokens / wall_s,
            "generate_idle_share": trace["device_idle_share"],
            "generate_traced": trace, "captures": eng.captures,
            "replays": eng.replays}


def drive_lm_full(dev, arch: str, layers, text: int) -> dict:
    """(b) One family's model at its published width on the card, batch 2,
    weights drawn from seed 0 in its ``param_dtype``: a teacher-forced
    forward; the reference test's prefill / decode consistency in fp32
    compute (err / scale < 1e-3; at :data:`LM_CONSISTENCY_LAYERS` where
    the stack is cut for it, the full depth's error reported); for a MoE
    the no-drop identity (forward = prefill, < 1e-4); then, in the
    config's own ``compute_dtype``, the prefill and 16 greedy decode
    steps, each under ``torch.cuda.set_sync_debug_mode("error")`` (a host
    sync raises; the first 2 untimed), then 10 more under a CUPTI
    trace."""
    import torch

    from repro_torch.common.params import count_params, tree_size_bytes
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    t0 = time.perf_counter()
    published = get_config(arch)
    cfg = published if layers is None else published.replace(
        num_layers=layers)
    n_img = cfg.num_image_tokens if cfg.family == "vlm" else 0
    seq = text + n_img  # the positions a prompt fills in the cache
    f32 = {"compute_dtype": "float32"}
    free_card()
    torch.cuda.reset_peak_memory_stats()
    row = {"model": arch, "layers": cfg.num_layers,
           "published_layers": published.num_layers, "batch": LM_BATCH,
           "text_tokens": text, "image_tokens": n_img,
           "audio_frames": cfg.enc_ctx if cfg.family == "audio" else 0,
           "param_dtype": cfg.param_dtype,
           "compute_dtype": cfg.compute_dtype}
    with torch.no_grad():
        by_depth = {}
        for n in LM_CONSISTENCY_LAYERS.get(arch, ()):
            cut = _lm_model(dev, cfg.replace(num_layers=n, **f32), seq)
            by_depth[n] = _lm_consistency(*cut, seq, dev)
            del cut
            free_card()
        if by_depth:
            row["consistency_layers"] = min(by_depth)
            row["consistency_err_over_scale"] = by_depth[min(by_depth)]
        m, params, batch = _lm_model(dev, cfg, seq)
        row["params"] = count_params(m.schema())
        row["params_gb"] = tree_size_bytes(params) / 1e9

        # teacher-forced forward in the compute dtype
        logits, _ = m.forward(params, batch)
        check(tuple(logits.shape) == (LM_BATCH, text, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"{LM} {arch}: forward logits {tuple(logits.shape)} not "
              "finite or of the wrong shape")
        del logits
        row["forward_ms"] = _lm_events_ms(
            lambda: m.forward(params, batch), 1)[0]

        # the reference's consistency check, fp32 compute
        err = _lm_consistency(get_model(cfg.replace(**f32)), params,
                              batch, seq, dev)
        if by_depth:
            by_depth[cfg.num_layers] = err
            row["consistency_by_depth"] = by_depth
        else:
            row["consistency_err_over_scale"] = err
        check(row["consistency_err_over_scale"] < 1e-3,
              f"{LM} {arch}: decode/prefill mismatch "
              f"{row['consistency_err_over_scale']:.3g} (fp32 compute)")

        if cfg.family == "moe":
            nd = get_model(cfg.replace(
                capacity_factor=float(cfg.num_experts), **f32))
            fwd, _ = nd.forward(params, batch)
            pl, _ = nd.prefill(params, batch,
                               nd.init_cache(LM_BATCH, seq, device=dev))
            row["nodrop_max_abs_err"] = float(
                (pl[:, 0] - fwd[:, -1]).abs().max())
            check(row["nodrop_max_abs_err"] < 1e-4,
                  f"{LM} {arch}: no-drop forward != prefill "
                  f"({row['nodrop_max_abs_err']:.3g})")
            del fwd, pl

        # serving in the compute dtype: prefill, then greedy decode
        steps = LM_WARM_STEPS + LM_DECODE_STEPS + LM_TRACED_STEPS
        cache = m.init_cache(LM_BATCH, seq + steps + 1, device=dev)
        row["prefill_ms"] = _lm_events_ms(
            lambda: m.prefill(params, batch, cache), 1)[0]
        logits, cache = m.prefill(params, batch, cache)
        state = {"tok": logits[:, -1:].argmax(-1)}

        def step():
            out, _ = m.decode_step(params, state["tok"], cache)
            state["tok"] = out[:, -1:].argmax(-1)

        def checked_step():
            torch.cuda.set_sync_debug_mode("error")
            try:
                step()
            finally:
                torch.cuda.set_sync_debug_mode("default")

        for _ in range(LM_WARM_STEPS):
            checked_step()
        ms = _lm_events_ms(checked_step, LM_DECODE_STEPS)
        row["decode_ms_per_step"] = statistics.median(ms)
        row["decode_ms_steps"] = ms
        row["tokens_per_s"] = LM_BATCH * 1e3 / row["decode_ms_per_step"]
        row.update(_lm_trace(step, LM_TRACED_STEPS))
        check(int(cache["pos"]) == seq + steps,
              f"{LM} {arch}: cache at {int(cache['pos'])} after {steps} "
              "steps")
        del cache, state
        row.update(drive_lm_serve(m, params, dev))
    row["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    row["wall_s"] = time.perf_counter() - t0
    del m, params, batch
    free_card()
    return row


def drive_lm(dev) -> tuple:
    """Phase 8, with the kernels' launch counts zeroed just before and read
    just after: the models are plain torch (the reference computes their
    products and attention outside any Pallas kernel), so no hand-written
    kernel may launch."""
    from repro_torch.kernels import _build

    _build.reset_launches()
    t0 = time.perf_counter()
    smoke = check_lm_smoke(dev)
    smoke["wall_s"] = time.perf_counter() - t0
    rows = [drive_lm_full(dev, *spec) for spec in LM_FULL]
    launches = {k: n for k, n in _build.launches.items() if n}
    check(not launches, f"{LM}: the models launched hand-written kernels "
          f"{launches}")
    return smoke, rows


# ---------------------------------------------------------------------------
# phase 9: LM training at published width (repro_torch.train, data, optim)
# ---------------------------------------------------------------------------

LMT = "lm train"
LMT_ARCH = "smollm-360m"
LMT_BATCH, LMT_SEQ, LMT_MICRO = 8, 2048, 2
LMT_STEPS, LMT_RESUMED_STEPS, LMT_TRACED_STEPS = 20, 10, 5
LMT_LR = 1e-3
LMT_MOE = ("moonshot-v1-16b-a3b", 2, 4, 1024, 10)  # arch, layers, B, S, steps
LMT_PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s, the MFU yardstick
# (b): the reference test's step config (lr 3e-6 at step 1, so a gradient
# near 0 whose sign differs moves its parameter by at most 6e-6), held
# within 1e-4 of each leaf's largest |value| (>= ~0.1 at this width)
LMT_MB_RTOL, LMT_MB_PARAM_TOL = 1e-4, 1e-4


def _lmt_conditioned(m, params, seed: int):
    """``params`` with every leaf the schema draws ``scaled`` re-drawn
    N(0, 0.02^2) (GPT-2's init) from ``seed`` on their device.

    The schema's ``scaled`` init takes the second-to-last dim as the
    fan-in: for the attention projections that is the head count (15,
    5) or the head width (64), not d_model (960), so each layer toward
    the input multiplies the gradient, in the reference too
    (``tests/test_torch_lm_train.py::
    test_reference_init_gradient_grows_with_depth_in_both_packages``);
    at 32 layers step 0's norm is ~1e17 (``schema_init_grad_norm``).
    Clipped to norm 1, every other coordinate's gradient falls below
    Adam's eps (1e-8) and does not train: from the schema's weights the
    loss stays at ~11.0 for 30 steps at lr 2e-3, 1e-3 or 3e-4
    (``scripts/lm_train_lr.py --schema-init``).  Phase 9 (a) and (b)
    therefore start from these weights; the model, the step and the
    trainer are the reference's."""
    import torch

    from repro_torch.common.params import tree_leaves, tree_map

    gen = torch.Generator(device=tree_leaves(params)[0].device)
    gen.manual_seed(seed)
    return tree_map(
        lambda p, x: (torch.randn(x.shape, generator=gen, device=x.device)
                      .mul_(0.02).to(x.dtype) if p.init == "scaled" else x),
        m.schema(), params)


def _lmt_config(**kw):
    """lr 1e-3: at 2e-3 (the reference test's) smollm-360m's losses
    alternate by +-0.3 from step 5 on and the last 5 of 30 average only
    0.06 below the first 5; at 1e-3 they fall 0.23, 10.996 -> 10.766
    (``scripts/lm_train_lr.py``)."""
    from repro_torch.configs import TrainConfig

    return TrainConfig(learning_rate=LMT_LR, warmup_steps=5, total_steps=100,
                       **kw)


def _lmt_trace(run, steps: int) -> dict:
    """:func:`_lm_trace` of ``steps`` calls of ``run``, and the device
    time by kernel (the top 8 names, ms over the window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = _device_events(prof)
    check(bool(events), f"{LMT}: the traced steps hold no device event")
    by_name: dict = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": steps, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "device_events_per_step": len(events) / steps,
            "top_device_ms": [(n[:70], us / 1e3) for n, us in top]}


def _same_state(a, b) -> bool:
    """Every leaf of two state trees equal bit for bit."""
    import torch

    from repro_torch.common.params import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.view(torch.uint8) if x.is_floating_point() else x,
                        y.view(torch.uint8) if y.is_floating_point() else y)
        for x, y in zip(la, lb))


def drive_lm_train_lifecycle(dev) -> tuple:
    """(a) smollm-360m's published config (fp32 parameters, bf16 compute,
    ``remat="full"``), from :func:`_lmt_conditioned` weights, trains 20
    steps on ``TokenStream(49152, 8, 2048)``
    with 2 microbatches, checkpointing every 10 under ``build/``; a fresh
    ``Trainer`` resumes at step 20 with the saved state bit for bit and
    trains 10 more; every loss finite and the last 5 losses' mean below
    the first 5's (``tests/test_train.py``'s criterion).  (d) The trained
    parameters served through ``ServeEngine`` (phase 8's workload), every
    token in the vocabulary.  Then 5 more steps under a CUPTI trace.
    Returns (summary, the trained state's trace)."""
    import shutil

    import torch

    from repro_torch.common.params import count_params, tree_size_bytes
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import get_model
    from repro_torch.serve import ServeEngine
    from repro_torch.train import Trainer

    cfg = get_config(LMT_ARCH)
    m = get_model(cfg)
    stream = TokenStream(cfg.vocab_size, LMT_BATCH, LMT_SEQ, seed=0)
    ckpt = ROOT / "build" / f"lm-ckpt-{os.getpid()}"
    shutil.rmtree(ckpt, ignore_errors=True)
    tc = _lmt_config(microbatches=LMT_MICRO, checkpoint_every=10,
                     async_checkpoint=False, checkpoint_dir=str(ckpt))
    free_card()
    torch.cuda.reset_peak_memory_stats()
    log = []
    try:
        tr = Trainer(m, tc, stream, device=dev)
        state, start = tr.init_or_resume(seed=0)
        check(start == 0, f"{LMT}: a fresh run resumed at {start}")
        # the schema's own weights: step 0's gradient norm, not trained on
        _, met = tr.step_fn(state, {k: torch.from_numpy(v).to(dev)
                                    for k, v in stream.batch_at(0).items()})
        schema_gnorm = float(met["grad_norm"])
        del met
        state["params"] = _lmt_conditioned(m, state["params"], 0)
        state_bytes = tree_size_bytes(state)  # parameters and moments
        t0 = time.perf_counter()
        state, nxt, hist = tr.run(state, 0, LMT_STEPS, log_every=10,
                                  log_fn=log.append)
        run1_s = time.perf_counter() - t0
        check(nxt == LMT_STEPS and tr.ckpt.latest_step() == LMT_STEPS,
              f"{LMT}: ran to {nxt}, latest checkpoint "
              f"{tr.ckpt.latest_step()}")
        t0 = time.perf_counter()
        tr2 = Trainer(m, tc, stream, device=dev)
        state2, start2 = tr2.init_or_resume(seed=0)
        resume_s = time.perf_counter() - t0
        check(start2 == LMT_STEPS and _same_state(state2, state),
              f"{LMT}: the resumed state (step {start2}) differs from the "
              "saved one")
        del state
        t0 = time.perf_counter()
        state2, nxt2, hist2 = tr2.run(state2, start2, LMT_RESUMED_STEPS,
                                      log_every=10, log_fn=log.append)
        run2_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    losses = [float(h["loss"]) for h in hist + hist2]
    gnorms = [float(h["grad_norm"]) for h in hist + hist2]
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"{LMT}: non-finite loss or gradient norm {losses} {gnorms}")
    first, last = statistics.fmean(losses[:5]), statistics.fmean(losses[-5:])
    check(last < first, f"{LMT}: the loss did not fall ({first:.4f} -> "
          f"{last:.4f})")
    # steady steps: the first of each run builds the autograd graph's
    # workspaces; each 10th saves a checkpoint
    times = tr.step_times[1:] + tr2.step_times[1:]
    step_s = statistics.median(times)
    tokens = LMT_BATCH * LMT_SEQ
    n = count_params(m.schema())

    # (d) serve the trained parameters
    t0 = time.perf_counter()
    eng = ServeEngine(m, state2["params"], batch_size=LM_SERVE_BATCH,
                      max_len=lm_serve_len(cfg), device=dev)
    reqs = eng.generate(lm_requests(cfg.vocab_size))
    served = [t for r in reqs for t in r.out_tokens]
    check(len(served) == LM_SERVE_REQUESTS * LM_SERVE_NEW
          and all(0 <= t < cfg.vocab_size for t in served),
          f"{LMT} (d): served tokens out of the vocabulary or missing")
    del eng
    serve_s = time.perf_counter() - t0

    # the traced steps: Trainer.run of one step at a time, no checkpoint
    tr3 = Trainer(m, tc.replace(checkpoint_dir=None), stream, device=dev)
    box = {"state": state2, "step": nxt2}

    def one_step():
        box["state"], box["step"], _ = tr3.run(box["state"], box["step"], 1,
                                               log_fn=lambda *_: None)

    del state2
    t0 = time.perf_counter()
    trace = _lmt_trace(one_step, LMT_TRACED_STEPS)
    trace_s = time.perf_counter() - t0
    summary = {
        "model": LMT_ARCH, "layers": cfg.num_layers, "params": n,
        "init": "schema; scaled leaves N(0, 0.02^2) (_lmt_conditioned)",
        "schema_init_grad_norm": schema_gnorm,
        "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
        "remat": cfg.remat, "batch": LMT_BATCH, "seq": LMT_SEQ,
        "microbatches": LMT_MICRO, "steps": len(losses),
        "resumed_at": start2, "losses": losses, "grad_norms": gnorms,
        "loss_first5": first, "loss_last5": last,
        "ms_per_step": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "mfu_bf16": 6 * n * tokens / step_s / LMT_PEAK_BF16,
        "first_step_ms": tr.step_times[0] * 1e3,
        "run1_wall_s": run1_s, "resume_s": resume_s, "run2_wall_s": run2_s,
        "serve_s": serve_s, "traced_steps_s": trace_s,
        "peak_memory_gb": peak / 1e9, "state_gb": state_bytes / 1e9,
        "full_logits_fp32_gb": tokens * cfg.vocab_size * 4 / 1e9,
        "served_tokens": len(served), "log": log,
    }
    del box, tr, tr2, tr3
    free_card()
    return summary, trace


def check_lm_microbatches(dev) -> dict:
    """(b) One step at 1 and one at 4 microbatches of smollm-360m at
    published width, fp32 compute, from one state, on ``batch_at(0)``:
    the losses at rtol 1e-4, every updated parameter within 1e-4 of its
    leaf's largest |value|."""
    import torch

    from repro_torch.common.params import tree_leaves
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import get_model
    from repro_torch.train import init_state, make_train_step

    m = get_model(get_config(LMT_ARCH).replace(compute_dtype="float32"))
    state = init_state(m, torch.Generator(device=dev).manual_seed(1))
    state["params"] = _lmt_conditioned(m, state["params"], 1)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in TokenStream(
        m.cfg.vocab_size, LMT_BATCH, LMT_SEQ, seed=0).batch_at(0).items()}
    out1, m1 = make_train_step(m, TrainConfig(microbatches=1))(state, batch)
    l1 = float(m1["loss"])
    p1 = out1["params"]
    del out1, m1
    out4, m4 = make_train_step(m, TrainConfig(microbatches=4))(state, batch)
    l4 = float(m4["loss"])
    worst = max(float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(tree_leaves(out4["params"]), tree_leaves(p1)))
    check(abs(l1 - l4) <= LMT_MB_RTOL * abs(l1),
          f"{LMT} (b): loss {l1} at 1 microbatch, {l4} at 4")
    check(worst <= LMT_MB_PARAM_TOL,
          f"{LMT} (b): updated parameters differ by {worst:.3g} of a leaf's "
          "largest value")
    del state, out4, p1
    free_card()
    return {"loss_mb1": l1, "loss_mb4": l4,
            "loss_rel_err": abs(l1 - l4) / abs(l1),
            "param_err_over_leaf_max": worst}


def drive_lm_moe_train(dev) -> dict:
    """(c) moonshot-v1-16b-a3b at published width, 2 of its 48 layers, on
    ``TokenStream(163840, 4, 1024)`` for 10 steps: the MoE backward and
    the router loss; every loss, router loss and gradient norm finite."""
    import torch

    from repro_torch.common.params import count_params
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import get_model
    from repro_torch.train import Trainer

    arch, layers, b, s, steps = LMT_MOE
    cfg = get_config(arch).replace(num_layers=layers)
    m = get_model(cfg)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(m, _lmt_config(), TokenStream(cfg.vocab_size, b, s),
                 device=dev)
    # no reference to the initial state outside run(), which drops it
    # after the first step: a step holds two states (the step is
    # functional), and a third would not fit at this width
    state, _, hist = tr.run(tr.init_or_resume(seed=0)[0], 0, steps,
                            log_fn=lambda *_: None)
    keys = ("loss", "ce", "router_loss", "grad_norm")
    vals = {k: [float(h[k]) for h in hist] for k in keys}
    check(all(math.isfinite(x) for k in keys for x in vals[k]),
          f"{LMT} (c) {arch}: non-finite values {vals}")
    step_s = statistics.median(tr.step_times[1:])
    n = count_params(m.schema())
    row = {"model": arch, "layers": layers,
           "published_layers": get_config(arch).num_layers, "params": n,
           "batch": b, "seq": s, "steps": steps, **vals,
           "ms_per_step": step_s * 1e3, "tokens_per_s": b * s / step_s,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del state, tr
    free_card()
    return row


def drive_lm_train(dev) -> tuple:
    """Phase 9, with the kernels' launch counts zeroed just before and read
    just after: the reference's training step reaches no Pallas kernel,
    so no hand-written kernel may launch."""
    from repro_torch.kernels import _build

    _build.reset_launches()
    summary, trace = drive_lm_train_lifecycle(dev)
    mb = check_lm_microbatches(dev)
    moe = drive_lm_moe_train(dev)
    launches = {k: n for k, n in _build.launches.items() if n}
    check(not launches, f"{LMT}: training launched hand-written kernels "
          f"{launches}")
    return summary, trace, mb, moe


# ---------------------------------------------------------------------------
# phase 10: the sharded train and serve paths, and the roofline dry run
# (repro_torch.distributed.sharding, launch.mesh, analysis, launch.dryrun)
# ---------------------------------------------------------------------------

SHARD = "lm shard"
SHARD_ARCH = "smollm-360m"  # (a): its smoke config
SHARD_STEPS = 3
SHARD_RTOL = 1e-6
# (b): one smoke config a family
SHARD_ENGINE_ARCHS = ("llama3-8b", "pixtral-12b", "moonshot-v1-16b-a3b",
                      "zamba2-7b", "rwkv6-1.6b", "whisper-tiny")
SHARD_ENGINE_BATCH, SHARD_ENGINE_LEN, SHARD_ENGINE_NEW = 2, 48, 6
DRYRUN_TIMEOUT_S = 300

# (c) and (d) in one process of their own: the dry run's fake group is
# process-wide; argv: the decode cell's max_len, then the train cell's
# batch, seq and microbatches
_DRYRUN = r"""
import json, sys
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import dryrun
dec_len, b, s, micro = (int(x) for x in sys.argv[1:5])
# (c)'s cells keep the params' dtype of the steps phases 8 and 9 timed
own = lambda arch: {"param_dtype": get_config(arch).param_dtype}
rows = {
    "decode": dryrun.run_cell("llama3-8b", ShapeConfig("serve", dec_len, 4,
                              "decode"), False, verbose=False,
                              dims=(1, 1, 1), cfg_override=own("llama3-8b")),
    "train": dryrun.run_cell("smollm-360m", ShapeConfig("lmt", s, b,
                             "train"), False, verbose=False,
                             microbatches=micro, dims=(1, 1, 1),
                             cfg_override=own("smollm-360m")),
    "production": dryrun.run_cell("llama3-8b", "train_4k", False,
                                  verbose=False),
}
dryrun.dist.destroy_process_group()
print(json.dumps(rows, default=str))
"""


def drive_sharded(dev) -> dict:
    """(a) and (b) on a one-rank NCCL group (an in-memory store, no
    socket) and ``make_host_mesh()``'s (1, 1) mesh: (a) ``Trainer`` on
    :data:`SHARD_ARCH`'s smoke config, one state drawn on the card carried
    into both, :data:`SHARD_STEPS` steps with the state placed by
    ``param_shardings`` / ``opt_state_shardings`` against the unsharded
    ``Trainer``'s: losses and every parameter at rtol 1e-6; (b)
    ``ServeEngine`` with ``cache_shardings`` against the unsharded engine,
    one smoke config a family: tokens equal, the decode step still one
    CUDA graph over a DTensor cache.  No hand-written kernel may launch."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.common.params import tree_leaves, tree_map
    from repro_torch.configs import TrainConfig, get_smoke_config
    from repro_torch.data import TokenStream
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.train import Trainer, init_state

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    out = {}
    try:
        mesh = make_host_mesh()
        _build.reset_launches()
        t0 = time.perf_counter()
        m = get_model(get_smoke_config(SHARD_ARCH))
        tc = TrainConfig(learning_rate=1e-3, warmup_steps=1)
        stream = TokenStream(m.cfg.vocab_size, 8, 32, seed=0)
        state = init_state(m, torch.Generator(device=dev).manual_seed(0))
        quiet = lambda *a, **k: None
        pshard = shd.param_shardings(m, mesh)
        ssh = {"params": pshard, "opt": shd.opt_state_shardings(pshard, mesh)}
        plain = Trainer(m, tc, stream, device=dev)
        want, _, wh = plain.run(tree_map(torch.clone, state), 0, SHARD_STEPS,
                                log_fn=quiet)
        tr = Trainer(m, tc, stream, mesh=mesh, state_shardings=ssh,
                     device=dev)
        got, _, gh = tr.run(shd.distribute(state, ssh), 0, SHARD_STEPS,
                            log_fn=quiet)
        losses = [[float(h["loss"]) for h in hist] for hist in (wh, gh)]
        for a, b in zip(*losses):
            check(abs(a - b) <= SHARD_RTOL * abs(a), f"{SHARD} (a): sharded "
                  f"losses {losses[1]} != unsharded {losses[0]}")
        worst = 0.0
        for g, w in zip(tree_leaves(shd.full_tensor(got)), tree_leaves(want)):
            err = float(((g - w).abs() - SHARD_RTOL * w.abs()).max())
            worst = max(worst, float((g - w).abs().max()))
            check(err <= 0, f"{SHARD} (a): a parameter differs by {err:.3g} "
                  "past rtol 1e-6")
        out["trainer"] = {"model": SHARD_ARCH, "steps": SHARD_STEPS,
                          "losses_unsharded": losses[0],
                          "losses_sharded": losses[1],
                          "param_max_abs_err": worst,
                          "ms_per_step_sharded": statistics.median(
                              tr.step_times) * 1e3,
                          "ms_per_step_unsharded": statistics.median(
                              plain.step_times) * 1e3,
                          "wall_s": time.perf_counter() - t0}
        del want, got, state

        t0 = time.perf_counter()
        engines = {}
        for arch in SHARD_ENGINE_ARCHS:
            m = get_model(get_smoke_config(arch))
            params = m.init(torch.Generator(device=dev).manual_seed(0))
            max_len = SHARD_ENGINE_LEN + (m.cfg.num_image_tokens
                                          if m.cfg.family == "vlm" else 0)
            rng = np.random.default_rng(0)
            prompts = [rng.integers(0, m.cfg.vocab_size, 5 + i).astype(
                np.int32) for i in range(3)]
            reqs = lambda: [Request(p, SHARD_ENGINE_NEW) for p in prompts]
            plain = ServeEngine(m, params, SHARD_ENGINE_BATCH, max_len,
                                device=dev).generate(reqs())
            cache = m.init_cache(SHARD_ENGINE_BATCH, max_len, device="meta")
            eng = ServeEngine(m, params, SHARD_ENGINE_BATCH, max_len,
                              device=dev, cache_shardings=shd.cache_shardings(
                                  m.cfg, cache, mesh))
            got = eng.generate(reqs())
            check([r.out_tokens for r in got] == [r.out_tokens for r in plain],
                  f"{SHARD} (b) {arch}: the sharded engine's tokens differ")
            check(eng.decoder.graph is not None and eng.captures == 1
                  and type(eng.decoder.static["pos"]).__name__ == "DTensor",
                  f"{SHARD} (b) {arch}: the decode step over the DTensor "
                  "cache was not captured")
            engines[arch] = {"tokens_equal": True,
                             "replays": eng.decoder.replays}
        out["engines"] = engines
        out["engines_wall_s"] = time.perf_counter() - t0
        launches = {k: n for k, n in _build.launches.items() if n}
        check(not launches, f"{SHARD}: hand-written kernels launched "
              f"{launches}")
    finally:
        dist.destroy_process_group()
    return out


def executed_flops_ratio(row: dict, cfg) -> float:
    """A dry-run row's ideal FLOPs over the executed FLOPs of all its
    ranks, unclamped (``build_report``'s ``model_flops_ratio`` stops at 1,
    as the reference's does).  The ideal (6 or 2 x N x tokens) is taken
    less an untied input embedding table's share, which a gather reads
    and no product computes.  Above 1, the traced count missed products."""
    ideal = row["model_flops_global"]
    if not cfg.tie_embeddings:
        ideal *= 1 - cfg.vocab_size * cfg.d_model / row["n_params_active"]
    return ideal / (row["flops"] * row["chips"])


def run_dry_runs() -> dict:
    """(c) and (d) in a subprocess (see :data:`_DRYRUN`)."""
    from repro_torch.configs import get_config

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = [str(lm_serve_len(get_config("llama3-8b"))), str(LMT_BATCH),
            str(LMT_SEQ), str(LMT_MICRO)]
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", _DRYRUN, *args],
                         capture_output=True, text=True, env=env,
                         timeout=DRYRUN_TIMEOUT_S)
    check(res.returncode == 0, f"{SHARD}: the dry run failed: "
          f"{res.stderr[-3000:]}")
    rows = json.loads(res.stdout.strip().splitlines()[-1])
    for name, row in rows.items():
        check(row.get("status") == "ok", f"{SHARD} {name}: dry run "
              f"{row.get('error')}")
        terms = [row[k] for k in ("compute_s", "memory_s", "collective_s",
                                  "t_overlap_s", "t_serial_s")]
        check(all(math.isfinite(t) for t in terms),
              f"{SHARD} {name}: a roofline term is not finite {terms}")
        ratio = executed_flops_ratio(row, get_config(row["cell"].split(
            ":")[0]))
        row["executed_flops_ratio"] = ratio
        check(ratio <= 1.0, f"{SHARD} {name}: the ideal FLOPs are "
              f"{ratio:.4f} x the executed FLOPs of all ranks: the traced "
              "count missed products")
    rows["wall_s"] = time.perf_counter() - t0
    return rows


def check_calibration(dry: dict, lm_rows: list, lmt: dict) -> list:
    """(c) Each measured step beside its roofline on a (1, 1, 1) mesh:
    llama3-8b's graph decode at batch 4 (phase 8 (d)) and smollm-360m's
    train step at 8 x 2048 in 2 microbatches (phase 9 (a)).  A step faster
    than its roofline's ``t_overlap_s`` means the count is wrong: gated."""
    dec = next(r for r in lm_rows if r["model"] == "llama3-8b")
    out = []
    for name, measured_ms, mfu in (
            ("decode", dec["graph_decode_ms_per_step"], None),
            ("train", lmt["ms_per_step"], lmt["mfu_bf16"])):
        row = dry[name]
        check(measured_ms / 1e3 >= row["t_overlap_s"],
              f"{SHARD} (c) {row['cell']}: measured {measured_ms:.3f} ms "
              f"beats its roofline's {row['t_overlap_s'] * 1e3:.3f} ms")
        out.append({"cell": row["cell"], "mesh": "1x1x1",
                    "measured_ms": measured_ms,
                    "t_overlap_ms": row["t_overlap_s"] * 1e3,
                    "t_serial_ms": row["t_serial_s"] * 1e3,
                    "bottleneck": row["bottleneck"],
                    "compute_ms": row["compute_s"] * 1e3,
                    "memory_ms": row["memory_s"] * 1e3,
                    "collective_ms": row["collective_s"] * 1e3,
                    "mfu_overlap": row["mfu_overlap"], "measured_mfu": mfu,
                    "measured_over_roofline": measured_ms / 1e3
                    / row["t_overlap_s"],
                    "flops": row["flops"], "hbm_bytes": row["hbm_bytes"],
                    "param_dtype": row["param_dtype"],
                    "executed_flops_ratio": row["executed_flops_ratio"],
                    "machine": row["machine"], "trace_s": row["trace_s"]})
    return out


def device_total_us(fn, reps: int = 20) -> float:
    """Device microseconds per call of ``fn``, every kernel it launches
    summed (CUPTI): each kernel's mean over its recorded launches, times
    its launches per call (its count over the rarest kernel's, rounded),
    so a window that recorded only some calls still counts whole calls.
    An empty trace is taken again, up to :data:`TRACE_TRIES` times, then
    the case fails."""
    for _ in range(TRACE_TRIES):
        by_name: dict = {}
        for name, us in _trace(fn, reps):
            by_name.setdefault(name, []).append(us)
        if by_name:
            fewest = min(len(v) for v in by_name.values())
            return sum(statistics.fmean(v) * max(1, round(len(v) / fewest))
                       for v in by_name.values())
    check(False, f"no CUPTI event for {reps} calls in {TRACE_TRIES} traces")


def fig10(ops_in: dict) -> list:
    """The H100's Fig. 10: each block's sequential and concurrent plan,
    time per call (CUDA events) and device time (CUPTI, all kernels)."""
    from repro_torch.core import pool

    rows = []
    for label, block, _ in FIG10:
        kw = {"causal": True} if block == "mha" else {}
        row = {"block": label}
        for plan in ("sequential", "concurrent"):
            fn = getattr(pool, f"{block}_{plan}")
            call = lambda: fn(*ops_in[block], **kw)
            row[f"{plan}_ms"] = time_ms(call)
            row[f"{plan}_device_us"] = device_total_us(call)
        rows.append(row)
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | tf32 matmul=False cudnn=False",
          flush=True)

    build_s = _build.build_all()
    by_source = {k: round(v, 1) for k, v in _build.build_seconds.items()}
    print(f"build: {len(KERNELS)} kernels from {len(_build.SOURCES)} "
          f"sources in {build_s:.1f}s ({', '.join(_build.SOURCES)}); "
          f"seconds by source: {json.dumps(by_source)}", flush=True)

    # a fresh tune cache: phases 3-6 run the launch heuristics whatever
    # cache the machine holds, and phase 7 stores its winners here
    from repro_torch.kernels import tune

    cache = ROOT / "build" / f"tune-{os.getpid()}.json"
    cache.unlink(missing_ok=True)
    tune.set_cache_path(str(cache))

    results = {}
    for name, fn in (("ls_che", check_ls_che),
                     ("mmse_detect_demap", check_detect_demap),
                     ("sic_detect_demap", check_sic),
                     ("ldpc_decode", check_ldpc),
                     ("ldpc_decode_q", check_ldpc_q),
                     ("te_gemm", check_te_gemm),
                     ("mha", check_mha),
                     ("te_gemm_quant", check_te_gemm_quant),
                     ("mha_quant", check_mha_quant),
                     ("fc_softmax", check_fc_softmax),
                     ("dwconv_block", check_dwconv_block)):
        results[name] = fn(dev)
        for c in results[name]:
            lib = ("-" if c["library_ms"] is None
                   else f"{c['library_ms']:.4f}")
            lib_dus = ("-" if c["library_ms"] is None
                       else f"{c['library_device_us']:.2f}")
            dus = f"{c['device_us']:.2f}"
            print(f"kernel {name} [{c['shape']}]: kernel_ms={c['ms']:.4f} "
                  f"device_us={dus} "
                  f"plain_ms={c['plain_ms']:.4f} library_ms={lib} "
                  f"library_device_us={lib_dus} "
                  f"bound_ms={c['bound_ms']:.5f} ({c['bound_by']}) "
                  f"max_abs_err={c['max_abs_err']:.3g} "
                  f"(tolerance: {c['tolerance']})"
                  + "".join(f" {k}={c[k]}" for k in EXTRA_FIELDS if k in c),
                  flush=True)

    by_path, traced_by_path = {}, {}
    for label, ladder, receiver, options, n_ticks, needs in PATHS:
        sch, rep, launches = drive(ladder, n_ticks, dev, receiver, options)
        by_path[label] = launches
        print(f"path {label}: launches {launches}, registry steady tick "
              f"{rep.steady_tick_s * 1e3:.3f} ms, first tick "
              f"{rep.first_tick_s * 1e3:.3f} ms; captures "
              f"{rep.executables_compiled} in {rep.compile_time_s:.3f} s, "
              f"cache hits {rep.cache_hits}", flush=True)
        print(rep.summary(), flush=True)
        check_conservation(sch, rep)
        check(rep.executables_compiled == len(sch.rungs)
              and rep.compile_time_s > 0,
              f"{label}: {rep.executables_compiled} captures for "
              f"{len(sch.rungs)} rungs")
        replays = check_replay_launches(sch, launches)
        print(f"path {label}: graph replays by rung {replays}", flush=True)
        for k in needs:
            check(launches.get(k, 0) > 0, f"{k} never launched on {label}")
        for k in FORBIDDEN.get(label, ()):
            check(launches.get(k, 0) == 0,
                  f"{k} launched {launches.get(k)} times on {label}")
        prof = trace_replayed_ticks(sch, label, needs)
        traced_by_path[label] = prof["traced_launches"]
        print(f"profiled {label} ticks: {json.dumps(prof)}", flush=True)
        if receiver != "classical":
            served = check_neural_batch_against_twins(sch, dev, receiver,
                                                      options)
        else:
            served = check_batch_against_twins(sch, dev, options)
        print(f"served {label} batch vs twins: {served}", flush=True)
        if options.get("sic"):
            print(f"one MU batch, SIC vs joint LMMSE (not gated): "
                  f"{sic_vs_lmmse(sch, dev)}", flush=True)
        print(f"path {label} batch, registry vs eager: "
              f"{json.dumps(registry_vs_eager(sch, dev))}", flush=True)
        if label in PROFILED:
            print(f"host split {label} (not gated): "
                  f"{json.dumps(host_split(sch, dev))}", flush=True)

    one_device = {}  # each mesh path's run, for phase 4d's grids
    for label, specs, kw, n_ticks, needs in MESH_PATHS:
        sch, rep, launches = drive_mesh(specs(), kw, n_ticks, dev)
        by_path[label] = launches
        counts = check_mesh_run(sch, rep, launches, label, needs)
        one_device[label] = {"sch": sch, "counts": counts,
                             "trajectory": trajectory(sch, rep),
                             "replays": _replays(sch)}
        if label == MESH_HANDOVER:
            check(rep.handovers > 0, f"{label}: no user was handed over")
        print(f"path {label}: launches {launches}; {json.dumps(counts)}",
              flush=True)
        print(rep.summary(), flush=True)
        prof = trace_replayed_ticks(sch, label, needs)
        traced_by_path[label] = prof["traced_launches"]
        print(f"profiled {label} ticks: {json.dumps(prof)}", flush=True)
        print(f"path {label}: steady tick {counts['steady_tick_ms']:.3f} "
              f"ms, replays per tick {counts['replays_per_tick']:.3f}, "
              f"device idle share {prof['device_idle_share']:.4f}",
              flush=True)
        one_device[label]["idle"] = prof["device_idle_share"]
        print(f"served {label} bucket, lane by lane vs single-cell steps: "
              f"{json.dumps(check_mesh_lanes(sch, label))}", flush=True)
    rep, launches, summary, prof = drive_mesh_open(dev)
    by_path[MESH_OPEN] = launches
    traced_by_path[MESH_OPEN] = prof["traced_launches"]
    print(f"path {MESH_OPEN}: launches {launches}; {json.dumps(summary)}",
          flush=True)
    print(rep.summary(), flush=True)
    print(f"profiled {MESH_OPEN} run: {json.dumps(prof)}", flush=True)

    launches, prof, deg, runs, clean = drive_supervised_paths(dev)
    by_path[SUP] = launches
    # the clean ticks' trace and the degraded dispatch's
    traced_by_path[SUP] = dict(collections.Counter(prof["traced_launches"])
                               + collections.Counter(deg["traced_launches"]))
    print(f"path {SUP}: launches {launches} (run 2)", flush=True)
    for run, summary in runs.items():
        print(f"{SUP} {run}: {json.dumps(summary)}", flush=True)
    print(f"profiled {SUP} ticks: {json.dumps(prof)}", flush=True)
    print(f"profiled {SUP} degraded dispatch: {json.dumps(deg)}", flush=True)
    print(f"path {SUP}: steady tick "
          f"{runs['run 2 transparent faults']['steady_tick_ms']:.3f} ms, "
          f"device idle share {prof['device_idle_share']:.4f}", flush=True)

    grid_launches, grid_traced, grid_needs, grid_rows = drive_grids(
        dev, one_device, clean)
    # the mesh schedulers hold CUDA graphs and staged buffers in reference
    # cycles: free them before the LM phases' large models
    del one_device, sch, rep, clean
    free_card()
    grid_rows["card_memory_allocated_gb_after_4d"] = \
        torch.cuda.memory_allocated() / 1e9
    by_path.update(grid_launches)
    traced_by_path.update(grid_traced)
    for path, row in grid_rows.items():
        print(f"{path}: {json.dumps(row)}", flush=True)
    print(f"phase 4d ({GRID}): {grid_rows['cards']} | {nvidia_smi_line()}",
          flush=True)

    ops_in = _blocks_operands(dev)
    plans, quantized, launches = drive_blocks(dev, ops_in)
    by_path[BLOCKS] = launches
    print(f"path {BLOCKS}: launches {launches}", flush=True)
    for k in BLOCKS_NEEDS:
        check(launches.get(k, 0) > 0, f"{k} never launched on {BLOCKS}")
    print(f"{BLOCKS} vs twins, max abs err: "
          f"{json.dumps(check_blocks(ops_in, plans, quantized))}",
          flush=True)
    for row in fig10(ops_in):
        print(f"fig10 (not gated): {json.dumps(row)}", flush=True)

    print(f"{TRAIN} gradient check (CE-ViT at full width, batch "
          f"{TRAIN_BATCH}): {json.dumps(check_training_gradients(dev))}",
          flush=True)
    launches, summary, prof = drive_training(dev)
    by_path[TRAIN] = launches
    traced_by_path[TRAIN] = prof["traced_launches"]
    print(f"path {TRAIN}: launches {launches}; {json.dumps(summary)}",
          flush=True)
    print(f"profiled {TRAIN} steps: {json.dumps(prof)}", flush=True)
    print(f"path {TRAIN}: {summary['ms_per_step']:.3f} ms a step, device "
          f"idle share {prof['device_idle_share']:.4f}, held-out MSE LS "
          f"{summary['held_out_mse']['ls']:.4f} MMSE "
          f"{summary['held_out_mse']['mmse']:.4f} CE-ViT "
          f"{summary['held_out_mse']['cevit']:.4f} | {nvidia_smi_line()}",
          flush=True)

    t7 = time.perf_counter()
    for row in drive_autotune(dev):
        print(f"{TUNE} {row['case']}: heuristic {row['heuristic']} "
              f"{row['heuristic_device_us']:.2f} us, winner {row['winner']} "
              f"{row['winner_device_us']:.2f} us (device us, CUPTI); "
              f"{json.dumps(row)}", flush=True)
    print(f"{TUNE}: phase 7 wall {time.perf_counter() - t7:.1f}s, cache "
          f"{tune.get_cache().path} | {nvidia_smi_line()}", flush=True)

    t8 = time.perf_counter()
    smoke, rows = drive_lm(dev)
    print(f"{LM} (a) smoke configs, card against CPU, largest error over "
          f"scale by arch (and the check's wall): {json.dumps(smoke)}",
          flush=True)
    for row in rows:
        print(f"{LM} (b) {row['model']}: {json.dumps(row)}", flush=True)
    for row in rows:
        print(f"{LM} (d) {row['model']}: decode {row['graph_decode_ms_per_step']:.3f} "
              f"ms a step through the graph at batch {row['serve_batch']} "
              f"(eager {row['eager_decode_ms_per_step_b4']:.3f} at batch "
              f"{row['serve_batch']}, {row['decode_ms_per_step']:.3f} at "
              f"batch {LM_BATCH}), generate "
              f"{row['generate_tokens_per_s']:.1f} tokens/s, traced "
              f"generate idle {row['generate_idle_share']:.4f}", flush=True)
    print(f"{LM}: phase 8 wall {time.perf_counter() - t8:.1f}s | "
          f"{nvidia_smi_line()}", flush=True)

    t9 = time.perf_counter()
    summary, trace, mb, moe = drive_lm_train(dev)
    print(f"{LMT} (a) {LMT_ARCH}: {json.dumps(summary)}", flush=True)
    print(f"{LMT} (a) traced steps: {json.dumps(trace)}", flush=True)
    print(f"{LMT} (b) microbatches 1 vs 4, fp32: {json.dumps(mb)}",
          flush=True)
    print(f"{LMT} (c) {moe['model']}: {json.dumps(moe)}", flush=True)
    print(f"{LMT} (a) {LMT_ARCH}: {summary['ms_per_step']:.1f} ms a step, "
          f"{summary['tokens_per_s']:.0f} tokens/s, MFU "
          f"{summary['mfu_bf16']:.4f} (6 N tokens at 989 TFLOP/s bf16), "
          f"peak {summary['peak_memory_gb']:.2f} GB (state "
          f"{summary['state_gb']:.2f} GB, full fp32 logits "
          f"{summary['full_logits_fp32_gb']:.2f} GB), loss "
          f"{summary['loss_first5']:.4f} -> {summary['loss_last5']:.4f}, "
          f"traced idle {trace['device_idle_share']:.4f}; (c) router loss "
          f"{moe['router_loss'][-1]:.4g}, {moe['ms_per_step']:.1f} ms a "
          f"step | phase 9 wall {time.perf_counter() - t9:.1f}s | "
          f"{nvidia_smi_line()}", flush=True)

    t10 = time.perf_counter()
    sharded = drive_sharded(dev)
    print(f"{SHARD} (a) {json.dumps(sharded['trainer'])} | "
          f"{nvidia_smi_line()}", flush=True)
    print(f"{SHARD} (b) engines, sharded cache vs unsharded: "
          f"{json.dumps(sharded['engines'])} in "
          f"{sharded['engines_wall_s']:.1f}s | {nvidia_smi_line()}",
          flush=True)
    dry = run_dry_runs()
    for row in check_calibration(dry, rows, summary):
        print(f"{SHARD} (c) {row['cell']}: measured {row['measured_ms']:.3f} "
              f"ms a step, roofline t_overlap {row['t_overlap_ms']:.3f} ms "
              f"({row['bottleneck']}-bound), mfu_overlap "
              f"{row['mfu_overlap']:.4f}, measured MFU {row['measured_mfu']} "
              f"| {nvidia_smi_line()}; {json.dumps(row)}", flush=True)
    prod = dry["production"]
    print(f"{SHARD} (d) {prod['cell']} {prod['mesh']}: "
          f"c={prod['compute_s'] * 1e3:.3f}ms m={prod['memory_s'] * 1e3:.3f}ms "
          f"n={prod['collective_s'] * 1e3:.3f}ms -> {prod['bottleneck']} "
          f"MFU={prod['mfu_overlap'] * 100:.1f}% "
          f"useful={prod['model_flops_ratio'] * 100:.1f}% (ideal over "
          f"executed, embedding lookup aside, "
          f"{prod['executed_flops_ratio']:.4f}); collectives "
          f"{json.dumps(prod['collective_counts'])}, args "
          f"{prod['arg_bytes'] / 1e9:.2f} GB, temp "
          f"{prod['temp_bytes'] / 1e9:.2f} GB, trace_s {prod['trace_s']}, "
          f"dry-run process {dry['wall_s']:.1f}s (host work) | "
          f"{nvidia_smi_line()}", flush=True)
    print(f"{SHARD}: phase 10 wall {time.perf_counter() - t10:.1f}s | "
          f"{nvidia_smi_line()}", flush=True)

    needs_by_path = {label: needs for label, *_, needs in PATHS}
    needs_by_path.update({label: needs for label, *_, needs in MESH_PATHS})
    needs_by_path[MESH_OPEN] = MESH_OPEN_NEEDS
    needs_by_path.update(grid_needs)
    needs_by_path[SUP] = SUP_NEEDS
    needs_by_path[BLOCKS] = BLOCKS_NEEDS
    needs_by_path[TRAIN] = TRAIN_NEEDS
    kernels = []
    for name, cases in results.items():
        head = cases[0]  # the main path's shape
        first = next(label for label, needs in needs_by_path.items()
                     if name in needs)
        source, replaces = KERNELS[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/csrc/{source}",
            replaces=replaces, launches=by_path[first][name],
            launches_path=first,
            launches_by_path={label: n.get(name, 0)
                              for label, n in by_path.items()},
            launches_counted_as={
                label: ("captured launches x graph replays, plus the "
                        "eager warm-up of each step captured in the run"
                        if label == SUP
                        else "captured launches x graph replays"
                        if label in traced_by_path and label != TRAIN
                        else "wrapper calls")
                for label in by_path},
            traced_launches_by_path={
                label: n.get(name, 0)
                for label, n in traced_by_path.items()},
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
            library_device_us=head["library_device_us"],
            host_us=head.get("host_us"), cases=cases,
        ))
    line = json.dumps({"kernels": kernels})
    print(f"chip_smoke wall: {time.perf_counter() - t_start:.1f}s",
          flush=True)
    print(line, flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
