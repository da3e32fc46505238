"""Serving launcher: batched greedy generation against a chosen arch
(port of :mod:`repro.launch.serve`).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --requests 8 --new-tokens 16
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full_config else \
        get_smoke_config(args.arch)
    model = get_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    engine = ServeEngine(model, params, batch_size=args.batch,
                         max_len=args.max_len, device=dev)
    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(
            prompt=rng.integers(
                0, cfg.vocab_size, size=(int(rng.integers(4, 32)),)
            ).astype(np.int32),
            max_new_tokens=args.new_tokens,
        )
        for _ in range(args.requests)
    ]
    t0 = time.perf_counter()
    out = engine.generate(reqs)
    dt = time.perf_counter() - t0
    tok = sum(len(r.out_tokens) for r in out)
    print(f"{args.arch}: {len(reqs)} requests, {tok} tokens, "
          f"{dt:.2f}s ({tok/dt:.1f} tok/s)")


if __name__ == "__main__":
    main()
