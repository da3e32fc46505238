"""Uniform model API over all architecture families; port of
:mod:`repro.models.registry`.

``get_model(cfg)`` returns a :class:`Model` with:
  schema()                         parameter schema (init + logical axes)
  init(gen)                        parameters
  forward(params, batch)           (logits, aux) — full-sequence training fwd
  init_cache(b, s)                 serving cache (KV / SSM / RWKV states)
  prefill(params, batch, cache)    (last_logits, cache)
  decode_step(params, tok, cache)  (logits, cache)
  input_specs(shape)               ``meta`` tensors for the dry-run

The cache is a dict of the reference's keys and layouts (``k``, ``v``,
``pos``; the SSM, conv and RWKV states; whisper's ``memory``).  ``prefill``
and ``decode_step`` write it in place and return it; ``pos`` stays a
device tensor, so a decode step reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.common.params import init_params, schema_axes
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import hybrid, moe, rwkv6, transformer, whisper

Params = Any

_FAMILY = {
    "dense": transformer,
    "vlm": transformer,
    "moe": moe,
    "hybrid": hybrid,
    "ssm": rwkv6,
    "audio": whisper,
}


def _generator(gen: Optional[torch.Generator],
               device: DeviceLike) -> torch.Generator:
    """``gen``, or a generator seeded 0 on ``device`` (None -> CUDA)."""
    if gen is not None:
        return gen
    return torch.Generator(device=resolve_device(device)).manual_seed(0)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    module: Any

    def schema(self):
        return self.module.schema(self.cfg)

    def init(self, gen: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> Params:
        """Parameters drawn on ``gen``'s device (no ``gen``: a generator
        seeded 0 on ``device``, None -> CUDA)."""
        return init_params(self.schema(), _generator(gen, device))

    def param_axes(self):
        return schema_axes(self.schema())

    def forward(self, params, batch, return_hidden: bool = False):
        return self.module.forward(
            params, self.cfg, batch, return_hidden=return_hidden
        )

    def unembed(self, params, x):
        return self.module.unembed(params, x, self.cfg)

    def init_cache(self, batch_size: int, max_len: int,
                   device: DeviceLike = None):
        return self.module.init_cache(self.cfg, batch_size, max_len,
                                      resolve_device(device))

    def prefill(self, params, batch, cache):
        return self.module.prefill(params, self.cfg, batch, cache)

    def decode_step(self, params, token, cache):
        return self.module.decode_step(params, self.cfg, token, cache)

    # -- dry-run input specs -------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> dict:
        """``meta`` tensors of every model input of a shape cell."""
        b = shape.global_batch
        if shape.kind == "train":
            s = self._text_len(shape.seq_len)
            specs = {"tokens": _spec((b, s), torch.int32),
                     "labels": _spec((b, s), torch.int32)}
            self._add_modality(specs, b)
            return specs
        if shape.kind == "prefill":
            specs = {"tokens": _spec((b, self._text_len(shape.seq_len)),
                                     torch.int32)}
            self._add_modality(specs, b)
            return specs
        if shape.kind == "decode":
            return {"tokens": _spec((b, 1), torch.int32)}
        raise ValueError(shape.kind)

    def _text_len(self, seq_len: int) -> int:
        if self.cfg.family == "vlm":
            return seq_len - self.cfg.num_image_tokens
        return seq_len

    def _add_modality(self, specs: dict, b: int):
        cfg = self.cfg
        if cfg.family == "vlm":
            specs["image_embeds"] = _spec((b, cfg.num_image_tokens, 1024),
                                          cfg.dtype())
        if cfg.family == "audio":
            specs["audio_embeds"] = _spec((b, cfg.enc_ctx, cfg.d_model),
                                          cfg.dtype())

    def make_inputs(self, gen: Optional[torch.Generator], shape: ShapeConfig,
                    device: DeviceLike = None) -> dict:
        """Random inputs matching :meth:`input_specs`, drawn on ``gen``'s
        device (no ``gen``: seeded 0 on ``device``, None -> CUDA): token
        ids uniform over the vocabulary, stub embeddings standard
        normal."""
        gen = _generator(gen, device)
        out = {}
        for name, spec in self.input_specs(shape).items():
            if spec.dtype == torch.int32:
                out[name] = torch.randint(
                    0, self.cfg.vocab_size, spec.shape, generator=gen,
                    device=gen.device, dtype=torch.int32)
            else:
                out[name] = torch.randn(spec.shape, generator=gen,
                                        device=gen.device, dtype=spec.dtype)
        return out


def _spec(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILY:
        raise KeyError(f"unknown family {cfg.family}")
    return Model(cfg=cfg, module=_FAMILY[cfg.family])
