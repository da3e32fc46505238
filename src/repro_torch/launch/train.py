"""Training launcher (port of :mod:`repro.launch.train`).

Smoke run (reduced config) on the card, or on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --steps 20 --device cpu

The reference's sharded runs (``--host-devices``, ``--mesh``, ``--mode sp |
fsdp``) need the LM sharding rules and several cards: they raise
``NotImplementedError`` (ROADMAP item 14e and item 7 part 3).
"""
import argparse

from repro_torch.configs import TrainConfig, get_config, get_smoke_config
from repro_torch.data import TokenStream
from repro_torch.models import get_model
from repro_torch.train import Trainer

_SHARDED = ("sharded training needs the LM sharding rules and several "
            "cards (ROADMAP item 14e and item 7 part 3)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--full-config", action="store_true",
                    help="published size instead of the reduced smoke config")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--host-devices", type=int, default=0,
                    help="not supported: " + _SHARDED)
    ap.add_argument("--mesh", default=None, help="not supported: " + _SHARDED)
    ap.add_argument("--mode", default="base",
                    choices=["base", "sp", "fsdp"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    if args.host_devices or args.mesh or args.mode != "base":
        raise NotImplementedError(_SHARDED)

    cfg = get_config(args.arch) if args.full_config else \
        get_smoke_config(args.arch)
    model = get_model(cfg)
    tc = TrainConfig(
        learning_rate=args.lr, total_steps=args.steps,
        microbatches=args.microbatches, checkpoint_dir=args.checkpoint_dir,
    )
    stream = TokenStream(cfg.vocab_size, args.batch, args.seq, seed=0)
    trainer = Trainer(model, tc, stream, device=args.device)
    trainer.install_signal_handlers()
    state, start = trainer.init_or_resume()
    state, end, hist = trainer.run(state, start, args.steps)
    print(f"done: steps {start}..{end}, "
          f"loss {float(hist[0]['loss']):.4f} -> {float(hist[-1]['loss']):.4f}")


if __name__ == "__main__":
    main()
