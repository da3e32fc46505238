"""Host microseconds per call of the quantized GEMM's and the fused FC +
softmax's kernel wrappers, and of one PyTorch call that computes the same
function, on one CUDA card.

    python scripts/host_us.py [--src SRC_DIR]

``--src`` is the ``src`` directory of the checkout whose ``repro_torch``
is measured (default: this one's), so two commits compare in one run on
one card.  Each callable runs 1000 times in chunks of 100, the host
clock read before the card is synchronised, and the median of the
chunks' means is kept (``chip_smoke.host_us``): the enqueue cost per
call.  The shapes are the blocks path's: 256^3
int8 codes with epilogue none, and the paper's 512^3 fp32 FC block with
a bias.  Prints one JSON line per callable, then the card's name and
power limit.
"""
import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("host_us: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import chip_smoke
    from repro_torch.kernels import fc_softmax, te_gemm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randn(256, 256, generator=gen, device=dev)
    w = torch.randn(256, 256, generator=gen, device=dev) / 16.0
    xq, wq, xs, ws = te_gemm.quantize_gemm_operands(x, w, "int8")
    w_cm = wq.t().contiguous().t()
    fx = torch.randn(512, 512, generator=gen, device=dev)
    fw = torch.randn(512, 512, generator=gen, device=dev) / 22.6
    fb = 0.1 * torch.randn(512, generator=gen, device=dev)
    calls = {
        "te_gemm_quantized_cuda": lambda: te_gemm.te_gemm_quantized_cuda(
            xq, wq, xs, ws),
        "te_gemm_quantized": lambda: te_gemm.te_gemm_quantized(
            xq, wq, xs, ws),
        "torch._int_mm": lambda: torch._int_mm(xq, w_cm),
        "fc_softmax_cuda": lambda: fc_softmax.fc_softmax_cuda(fx, fw, fb),
        "fc_softmax": lambda: fc_softmax.fc_softmax(fx, fw, fb),
        "torch.softmax(torch.addmm)": lambda: torch.softmax(
            torch.addmm(fb, fx, fw), dim=-1),
    }
    for name, fn in calls.items():
        print(json.dumps({"call": name, "src": args.src,
                          "host_us": chip_smoke.host_us(fn)}), flush=True)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
