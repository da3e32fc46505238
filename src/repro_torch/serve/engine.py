"""Batched LM serving engine: prefill + greedy decode over a static-shape
cache (port of :mod:`repro.serve.engine`).

The engine serves fixed-size batches: short batches are padded with empty
rows, prompts are left-padded with token 0 (no mask), the audio and vlm
families get zero stub embeddings, and every request of a batch decodes
``max(max_new_tokens)`` steps, each keeping tokens until it has its own
``max_new_tokens``.

The reference compiles one decode executable and donates its cache.  The
port's counterpart is one :class:`~repro_torch.serve.exec_registry.
CapturedStep` per engine: ``decode_step`` plus its argmax, a CUDA graph
on the card (the eager step on the CPU), captured at the first batch and
replayed for every decode step of every batch.  Its static state is the
engine's own cache of ``(batch_size, max_len)``, which each batch resets
in place to what ``model.init_cache`` returns; the ``(B, 1)`` token
buffer, which the graph's argmax overwrites with the next token; and a
``(max_len, B)`` token record the graph writes a row of per step, read to
the host once per batch.  The prefill stays eager: its length changes per
batch, as the reference recompiles it.

``cache_shardings`` (:func:`repro_torch.distributed.sharding.
cache_shardings`) places the cache as DTensors on their mesh, and the
prefill and the decode step run under ``activation_mesh`` of that mesh
(the reference's jit propagates the cache's shardings; the port's models
read the mesh from there).  Each rank writes its own cache shard
(:func:`repro_torch.models.layers.write_cache`).  On a one-rank mesh the
decode step is captured as without a mesh: DTensor's dispatch is host
work, and no collective runs.  On a larger mesh the graph would hold each
rank's local kernels and the NCCL collectives DTensor sends on the
step's stream (the cache's ``kv_seq`` reductions, the FSDP gathers of
sharded weights); only one card has run it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models.registry import Model
from repro_torch.serve.exec_registry import CapturedStep

PyTree = Any

# the decode step's static state besides the cache
TOKEN, ROW, RECORD = "token", "row", "record"


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model: Model, params: PyTree, batch_size: int,
                 max_len: int, cache_shardings: Optional[dict] = None,
                 device: DeviceLike = None):
        self.model = model
        self.cache_shardings = cache_shardings
        self.mesh = None
        if cache_shardings is not None:
            keys = sorted(model.init_cache(batch_size, max_len,
                                           device="meta"))
            if sorted(cache_shardings) != keys:
                raise ValueError(f"cache_shardings must hold one Sharding "
                                 f"per cache entry {keys}")
            self.mesh = cache_shardings[keys[0]].mesh
        self.params = params
        self.batch_size = batch_size
        self.max_len = max_len
        self.device = resolve_device(device)
        self.decoder: Optional[CapturedStep] = None
        self.captures = 0  # decode steps captured (one per engine)
        self.replays = 0  # decode steps run, one replay each
        self._cache_keys: tuple = ()

    # -- the captured decode step -------------------------------------------
    def _check_in_place(self, cache: dict, out: dict, what: str) -> None:
        if sorted(out) != sorted(cache) or any(
                out[k] is not cache[k] for k in cache):
            raise RuntimeError(
                f"{self.model.cfg.arch}: {what} rebound a cache entry; the "
                "captured decode step needs every cache leaf written in place")

    def _decode(self, static: dict) -> dict:
        """Record the current token, decode it, write the argmax back."""
        static[RECORD].index_copy_(0, static[ROW], static[TOKEN].view(1, -1))
        static[ROW].add_(1).clamp_(max=self.max_len - 1)
        cache = {k: static[k] for k in self._cache_keys}
        with shd.activation_mesh(self.mesh):
            logits, out = self.model.decode_step(self.params, static[TOKEN],
                                                 cache)
            self._check_in_place(cache, out, "decode_step")
            L.assign(static[TOKEN], torch.argmax(
                logits[:, -1, :], dim=-1)[:, None].to(torch.int32))
        return {}

    def _new_cache(self) -> dict:
        """``model.init_cache``'s values, placed by ``cache_shardings``."""
        cache = self.model.init_cache(self.batch_size, self.max_len,
                                      device=self.device)
        if self.cache_shardings is not None:
            cache = shd.distribute(cache, self.cache_shardings)
        return cache

    def _decoder(self) -> CapturedStep:
        """The decode step, captured over a fresh cache at first use."""
        if self.decoder is None:
            b, dev = self.batch_size, self.device
            cache = self._new_cache()
            self._cache_keys = tuple(cache)
            example = {
                TOKEN: torch.zeros((b, 1), dtype=torch.int32, device=dev),
                ROW: torch.zeros((1,), dtype=torch.int64, device=dev),
                RECORD: torch.zeros((self.max_len, b), dtype=torch.int32,
                                    device=dev),
                **cache,
            }
            del cache
            self.decoder = CapturedStep(self._decode, example)
            self.captures += 1
        return self.decoder

    def reset_cache(self) -> dict:
        """The engine's cache, written in place with what
        ``model.init_cache`` returns."""
        cache = {k: self.decoder.static[k] for k in self._cache_keys}
        fresh = self.model.init_cache(self.batch_size, self.max_len,
                                      device=self.device)
        for k in self._cache_keys:
            L.assign(cache[k], fresh[k])
        return cache

    # -- serving -------------------------------------------------------------
    def generate(self, requests: list[Request], greedy: bool = True,
                 seed: int = 0) -> list[Request]:
        """Serve a list of requests in fixed-size batches.  ``greedy`` and
        ``seed`` are accepted as the reference accepts them; it has no
        sampling, and neither has the port: decoding is greedy."""
        with torch.no_grad():
            for i in range(0, len(requests), self.batch_size):
                self._serve_batch(requests[i : i + self.batch_size])
        return requests

    def _serve_batch(self, reqs: list[Request]) -> None:
        b, dev = self.batch_size, self.device
        max_new = max(r.max_new_tokens for r in reqs)
        if max_new > self.max_len:
            raise ValueError(f"{max_new} new tokens exceed the engine's "
                             f"max_len {self.max_len}")
        plen = max(len(r.prompt) for r in reqs)
        prompts = np.zeros((b, plen), np.int32)
        for j, r in enumerate(reqs):
            prompts[j, plen - len(r.prompt):] = r.prompt  # left-pad
        step = self._decoder()
        cache = self.reset_cache()
        batch = {"tokens": torch.from_numpy(prompts).to(dev)}
        cfg = self.model.cfg
        if cfg.family == "audio":  # stub frame embeddings (frontend is a stub)
            batch["audio_embeds"] = torch.zeros(
                (b, cfg.enc_ctx, cfg.d_model), dtype=cfg.dtype(), device=dev)
        elif cfg.family == "vlm":
            batch["image_embeds"] = torch.zeros(
                (b, cfg.num_image_tokens, 1024), dtype=cfg.dtype(),
                device=dev)
        static = step.static
        with shd.activation_mesh(self.mesh):
            logits, out = self.model.prefill(self.params, batch, cache)
            self._check_in_place(cache, out, "prefill")
            L.assign(static[TOKEN], torch.argmax(
                logits[:, -1, :], dim=-1)[:, None].to(torch.int32))
        static[ROW].zero_()
        for _ in range(max_new):
            step.replay()
        self.replays += max_new
        record = static[RECORD][:max_new].cpu().numpy()
        for s in range(max_new):
            for j, r in enumerate(reqs):
                if len(r.out_tokens) < r.max_new_tokens:
                    r.out_tokens.append(int(record[s, j]))
        for r in reqs:
            r.done = True
