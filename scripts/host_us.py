"""Host microseconds per call of the kernel wrappers of LS-CHE, the TE
GEMM, the quantized GEMM, the fused FC + softmax, flash attention,
detect + demap and the LDPC decoder, and of one PyTorch call that
computes the same function where there is one, on one CUDA card.

    python scripts/host_us.py [--src SRC_DIR]

``--src`` is the ``src`` directory of the checkout whose ``repro_torch``
is measured (default: this one's), so two commits compare in one run on
one card.  Each callable runs 1000 times in chunks of 100, the host
clock read before the card is synchronised, and the median of the
chunks' means is kept (``chip_smoke.host_us``): the enqueue cost per
call.  The shapes: LS-CHE on the SISO grid at batch 8 (yardstick
``torch.einsum`` on the averaged comb), the TE GEMM at DeepRx's block
conv (28,672 x 288 -> 32, fp32, bias; ``torch.addmm``) and CE-ViT's
wqkv (512 x 64 -> 192, fp32; ``torch.mm``), the blocks path's 256^3
int8 codes with epilogue none, the paper's 512^3 fp32 FC block with
a bias, CE-ViT's (32, 64, 64, 16) attention (``F.scaled_dot_product_
attention``), detect + demap on the SISO grid at batch 8 and the r12
decoder over 216 codewords at +3 dB.  A tree with launch pickers
(``repro_torch.kernels.tune``) also gets each picker's own host us at
those shapes, the Python a wrapper adds per call to choose its launch
(100,000 calls, the best of five runs: the least the host's noise
leaves).  Prints one JSON line per callable, then the card's name and
power limit.
"""
import argparse
import importlib.util
import json
import pathlib
import sys
import timeit

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
    import torch.nn.functional as F

    from repro_torch.kernels import fc_softmax, ldpc, mha, rx_fused, te_gemm
    from repro_torch.phy import coding, ofdm, scenarios

    dev = torch.device("cuda")
    scn = scenarios.get_scenario("siso-qam16-r12-snr15")
    g = scn.grid
    y = chip_smoke._grid_y(coding.make_coded_slot(
        ofdm.make_generator(1, dev), scn, 8))
    op = torch.from_numpy(rx_fused.make_ls_interp_operator(
        g.n_subcarriers, g.n_tx, g.pilot_stride,
        ofdm.pilot_sequence_np(g))).to(dev)
    ls_args = (y, g.pilot_symbols, g.pilot_stride, op)
    comb = rx_fused._comb_extract(y, g.pilot_symbols, g.pilot_stride,
                                  g.n_tx).mean(dim=1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cx = torch.randn(28672, 288, generator=gen, device=dev)
    cw = torch.randn(288, 32, generator=gen, device=dev) / 17.0
    cb = 0.1 * torch.randn(32, generator=gen, device=dev)
    vx = torch.randn(512, 64, generator=gen, device=dev)
    vw = torch.randn(64, 192, generator=gen, device=dev) / 8.0
    x = torch.randn(256, 256, generator=gen, device=dev)
    w = torch.randn(256, 256, generator=gen, device=dev) / 16.0
    xq, wq, xs, ws = te_gemm.quantize_gemm_operands(x, w, "int8")
    w_cm = wq.t().contiguous().t()
    fx = torch.randn(512, 512, generator=gen, device=dev)
    fw = torch.randn(512, 512, generator=gen, device=dev) / 22.6
    fb = 0.1 * torch.randn(512, generator=gen, device=dev)
    q, k, v = (torch.randn(32, 64, 16, generator=gen, device=dev)
               for _ in range(3))
    slot = scn.make_batch(ofdm.make_generator(2, dev), 8)
    demap = (chip_smoke._grid_y(slot), slot["h"][:, 0].contiguous(),
             slot["noise_var"], scn.modem)
    code = coding.make_code("r12")
    llr = chip_smoke._code_llrs(code, 216, 3.0, dev)
    calls = {
        "ls_che_cuda": lambda: rx_fused.ls_che_cuda(*ls_args),
        "ls_che": lambda: rx_fused.ls_che(*ls_args),
        "torch.einsum (ls_che)": lambda: torch.einsum("btpr,tps->bsrt",
                                                      comb, op),
        "te_gemm_cuda (deeprx conv)": lambda: te_gemm.te_gemm_cuda(cx, cw,
                                                                   cb),
        "te_gemm (deeprx conv)": lambda: te_gemm.te_gemm(cx, cw, cb),
        "torch.addmm (deeprx conv)": lambda: torch.addmm(cb, cx, cw),
        "te_gemm (cevit wqkv)": lambda: te_gemm.te_gemm(vx, vw),
        "torch.mm (cevit wqkv)": lambda: torch.mm(vx, vw),
        "te_gemm_quantized_cuda": lambda: te_gemm.te_gemm_quantized_cuda(
            xq, wq, xs, ws),
        "te_gemm_quantized": lambda: te_gemm.te_gemm_quantized(
            xq, wq, xs, ws),
        "torch._int_mm": lambda: torch._int_mm(xq, w_cm),
        "fc_softmax_cuda": lambda: fc_softmax.fc_softmax_cuda(fx, fw, fb),
        "fc_softmax": lambda: fc_softmax.fc_softmax(fx, fw, fb),
        "torch.softmax(torch.addmm)": lambda: torch.softmax(
            torch.addmm(fb, fx, fw), dim=-1),
        "mha (cevit)": lambda: mha.mha(q, k, v, causal=False),
        "F.scaled_dot_product_attention (cevit)": lambda:
            F.scaled_dot_product_attention(q, k, v),
        "mmse_detect_demap (siso B=8)": lambda: rx_fused.mmse_detect_demap(
            *demap),
        "ldpc_decode (r12 216cw)": lambda: ldpc.ldpc_decode(llr, code),
    }
    for name, fn in calls.items():
        print(json.dumps({"call": name, "src": args.src,
                          "host_us": chip_smoke.host_us(fn)}), flush=True)
    if importlib.util.find_spec("repro_torch.kernels.tune") is not None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        pickers = {
            "te_gemm.pick_block_shape (deeprx conv)":
                lambda: te_gemm.pick_block_shape(28672, 32, 288),
            "mha.pick_cluster (cevit)": lambda: mha.pick_cluster(
                32, 64, 64, 16, False, torch.float32, sms),
            "rx_fused.pick_subcarrier_tile (siso)":
                lambda: rx_fused.pick_subcarrier_tile(False, 14, 256, 1, 1,
                                                      2),
            "ldpc.pick_segment (r12)": lambda: ldpc.pick_segment(code, 12,
                                                                  5),
        }
        for name, fn in pickers.items():
            us = min(timeit.repeat(fn, number=100_000, repeat=5)) * 10
            print(json.dumps({"call": name, "src": args.src,
                              "host_us": us}), flush=True)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
