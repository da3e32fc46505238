"""Losses and gradient norms of smollm-360m trained at its published
width on one CUDA card, per learning rate: the runs behind the choice of
``chip_smoke.py`` phase 9 (a)'s starting weights and learning rate.

    python scripts/lm_train_lr.py --steps 30 --lr 2e-3 1e-3 3e-4 [--schema-init]

Each run is a ``Trainer`` over ``TokenStream(49152, 8, 2048, seed=0)`` in
2 microbatches, ``warmup_steps=5``, ``total_steps=100``, TF32 off, from
``init_or_resume(seed=0)``: the schema's own weights with
``--schema-init``, else with the ``scaled`` leaves re-drawn N(0, 0.02^2)
(``chip_smoke._lmt_conditioned``).  Prints, per learning rate, the mean
of the first and last 5 losses, every loss and every gradient norm, then
the card's name and power limit.
"""
import argparse
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lr", type=float, nargs="+", default=[1e-3])
    ap.add_argument("--schema-init", action="store_true")
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import get_model
    from repro_torch.train import Trainer

    if not torch.cuda.is_available():
        print("lm_train_lr: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    m = get_model(get_config("smollm-360m"))
    stream = TokenStream(m.cfg.vocab_size, 8, 2048, seed=0)
    for lr in args.lr:
        tr = Trainer(m, TrainConfig(learning_rate=lr, warmup_steps=5,
                                    total_steps=100, microbatches=2),
                     stream, device=dev)
        state, _ = tr.init_or_resume(seed=0)
        if not args.schema_init:
            state["params"] = chip_smoke._lmt_conditioned(
                m, state["params"], 0)
        state, _, hist = tr.run(state, 0, args.steps,
                                log_fn=lambda *_: None)
        losses = [float(h["loss"]) for h in hist]
        print(f"lr {lr} first5 {statistics.fmean(losses[:5]):.4f} last5 "
              f"{statistics.fmean(losses[-5:]):.4f} losses "
              f"{[round(x, 4) for x in losses]}", flush=True)
        print(f"   grad norms {[f'{float(h['grad_norm']):.3g}' for h in hist]}"
              f" ms a step {statistics.median(tr.step_times[1:]) * 1e3:.1f}",
              flush=True)
        del state, tr
        torch.cuda.empty_cache()
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
