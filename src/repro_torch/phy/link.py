"""Receiver-pipeline subsystem (port of :mod:`repro.phy.link`): the
classical receiver (joint MMSE or SIC) and the two neural ones (DeepRx,
CE-ViT), which serve their network through the TE GEMM and flash-MHA
kernels.  Every ``build_*`` takes a precision policy: ``int8``/``fp8`` serve
the LLR plane on the fixed int8 grid and decode on the saturating int8
datapath.

A :class:`ReceiverPipeline` is a chain of :class:`RxStage`\\ s threading a
slot dict through eager PyTorch (no CUDA graphs yet).  Each stage names the
TensorPool engine that does its work and carries the reference's cycle
estimator, so TTI and energy reports are the reference's numbers.

A slot's ``noise_var`` holds one value, or one per lane of a multi-cell
step whose lanes are folded into the batch axis (every stage that reads
it reads row ``b``'s lane value: ``rx_fused.noise_var_rows``).

Pipelines hold their static operators (interpolation operator, pilot
sequence and masks, data-RE indices) and the neural receivers' weights on
the device they were built for; ``device=None`` means CUDA.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.common import params as _params
from repro_torch.core import pool
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import quant, rx_fused
from repro_torch.phy import classical, coding, models, ofdm
from repro_torch.phy.scenarios import LinkScenario

_C16 = 4  # bytes per complex64 element when streamed as 2 x fp16


@dataclasses.dataclass(frozen=True)
class RxStage:
    """One receiver stage: compute-class + apply + cycle estimator."""
    name: str
    compute: str  # dominant engine: "TE" | "PE" | "DMA"
    apply: Callable[[dict], dict]
    cycles: Optional[Callable[[], pool.BlockCycles]] = None


def _sum_cycles(cs) -> pool.BlockCycles:
    cs = list(cs)
    return pool.BlockCycles(
        te_cycles=sum(c.te_cycles for c in cs),
        pe_cycles=sum(c.pe_cycles for c in cs),
        dma_cycles=sum(c.dma_cycles for c in cs),
    )


class ReceiverPipeline:
    """A named chain of RxStages over the unified link-slot schema.

    ``run`` executes the chain eagerly on the slot's device; the cycle
    methods report the TensorPool budget without running anything.
    """

    def __init__(self, name: str, stages: list, scenario: LinkScenario,
                 params=None, precision: str = "fp32",
                 device: DeviceLike = None):
        self.name = name
        self.stages = tuple(stages)
        self.scenario = scenario
        self.params = params  # the neural receivers' weights, else None
        # numeric policy of the served datapath; the energy model prices
        # TE MACs and operand traffic at it
        self.precision = quant.resolve_precision(precision)
        self.device = resolve_device(device)

    def run(self, slot: dict) -> dict:
        """End-to-end receive over a batch of slots."""
        with torch.no_grad():
            state = dict(slot)
            for st in self.stages:
                state = st.apply(state)
        return state

    # -- TensorPool budget ------------------------------------------------
    def stage_cycles(self) -> dict:
        return {
            st.name: st.cycles() for st in self.stages
            if st.cycles is not None
        }

    def total_cycles(self) -> pool.BlockCycles:
        return _sum_cycles(
            st.cycles() for st in self.stages if st.cycles is not None
        )

    def tti_report(self, batch: int = 1, clock_hz: float = 1e9,
                   tti_s: float = 1e-3) -> dict:
        """Per-engine ms and the 1 ms TTI utilization for ``batch`` slots."""
        tot = self.total_cycles()
        to_ms = lambda cyc: batch * cyc / clock_hz * 1e3
        conc_ms = to_ms(tot.concurrent())
        return {
            "te_ms": to_ms(tot.te_cycles),
            "pe_ms": to_ms(tot.pe_cycles),
            "dma_ms": to_ms(tot.dma_cycles),
            "sequential_ms": to_ms(tot.sequential),
            "concurrent_ms": conc_ms,
            "tti_utilization": conc_ms / (tti_s * 1e3),
            "fits_tti": bool(conc_ms <= tti_s * 1e3),
        }

    def energy_report(self, clock_hz: float = 1e9):
        """Per-slot modeled EnergyReport at this pipeline's precision."""
        from repro_torch.analysis import costmodel

        return costmodel.pipeline_energy(self, clock_hz=clock_hz)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def slot_metrics(state: dict, scenario: LinkScenario,
                 per_slot: bool = False) -> dict:
    """BER / channel-MSE / EVM / BLER / decode effort from a finished
    pipeline state (tensors; ``per_slot=True`` gives (B,) tensors)."""
    def red(x):
        return dict(dim=tuple(range(1, x.ndim))) if per_slot else {}

    data_mask = state.get("data_mask")  # (n_sym, n_sc)
    if data_mask is None:
        dev = next(v.device for v in state.values()
                   if isinstance(v, torch.Tensor))
        data_mask = ~torch.any(
            ofdm.link_pilot_masks(scenario.grid, dev), dim=0
        )
    out = {}
    if "llr" in state and "bits" in state:
        hard = (state["llr"] > 0).to(torch.int32)
        err = (hard != state["bits"]).to(torch.float32)
        m = data_mask[None, :, :, None, None].to(torch.float32)
        denom = torch.sum(m.expand(err.shape), **red(err))
        out["ber"] = torch.sum(err * m, **red(err)) / denom
    h_est = state.get("h_hat", state.get("h_ls"))
    if h_est is not None and "h" in state:
        h_bar = torch.mean(state["h"], dim=1)  # (B, n_sc, n_rx, n_tx)
        e = torch.abs(h_est - h_bar) ** 2
        out["che_mse"] = torch.mean(e, **red(e))
    if "x_hat" in state and "x" in state:
        e = torch.abs(state["x_hat"] - state["x"]) ** 2
        m = data_mask[None, :, :, None].to(torch.float32)
        denom = torch.sum(m.expand(e.shape), **red(e))
        out["evm"] = torch.sum(e * m, **red(e)) / denom
    if "info_bits_hat" in state and "info_bits" in state:
        blk = torch.any(
            state["info_bits_hat"] != state["info_bits"], dim=-1
        ).to(torch.float32)  # (B, C)
        out["bler"] = torch.mean(blk, **red(blk))
        it = state["decode_iters"].to(torch.float32)
        out["decode_iters"] = torch.mean(it, **red(it))
    return out


# ---------------------------------------------------------------------------
# Stage factories (cycle models are the reference's, per slot)
# ---------------------------------------------------------------------------

def _grid_bytes(cfg: ofdm.GridConfig, per_re: int = 1) -> float:
    return cfg.n_symbols * cfg.n_subcarriers * per_re * _C16


def cfft_stage(cfg: ofdm.GridConfig) -> RxStage:
    def apply(state):
        state["y"] = classical.cfft_auto(state["y_time"], axis=2)
        return state

    def cycles():
        flops = (cfg.n_symbols * cfg.n_rx
                 * 5.0 * cfg.fft_size * math.log2(cfg.fft_size))
        return pool.BlockCycles(
            te_cycles=0.0,
            pe_cycles=pool.pe_cycles(flops, ipc=0.7),
            dma_cycles=pool.dma_cycles(2 * _grid_bytes(cfg, cfg.n_rx)),
        )

    return RxStage("cfft", "PE", apply, cycles)


def ls_che_stage(cfg: ofdm.GridConfig, fused: bool = False,
                 device: DeviceLike = None) -> RxStage:
    """LS CHE on the staggered DMRS combs; ``fused=True`` runs the fused
    comb-extract + interpolation-GEMM kernel (:func:`rx_fused.ls_che`)."""
    dev = resolve_device(device)
    seq = ofdm.pilot_sequence(cfg, dev)
    n_sc, n_psym = cfg.n_subcarriers, len(cfg.pilot_symbols)
    if fused:
        op = torch.from_numpy(rx_fused.make_ls_interp_operator(
            n_sc, cfg.n_tx, cfg.pilot_stride, ofdm.pilot_sequence_np(cfg)
        )).to(dev)
        n_p = op.shape[1]

        def apply(state):
            state["h_ls"] = rx_fused.ls_che(
                state["y"], cfg.pilot_symbols, cfg.pilot_stride, op
            )
            return state

        def cycles():
            macs = 4.0 * cfg.n_rx * cfg.n_tx * n_p * n_sc
            flops = 2.0 * n_psym * cfg.n_tx * n_p * cfg.n_rx
            return pool.BlockCycles(
                te_cycles=pool.te_cycles(macs, utilization=0.67),
                pe_cycles=pool.pe_cycles(flops, ipc=0.7),
                dma_cycles=pool.dma_cycles(
                    n_psym * n_sc * cfg.n_rx * _C16
                    + n_sc * cfg.n_rx * cfg.n_tx * _C16
                ),
            )

        return RxStage("ls_che_fused", "TE", apply, cycles)

    masks = ofdm.link_pilot_masks(cfg, dev)

    def apply(state):
        state["h_ls"] = classical.ls_channel_estimate_link(
            state["y"], seq, masks, cfg.pilot_stride
        )
        return state

    def cycles():
        flops = (n_psym * cfg.n_subcarriers * cfg.n_rx * 10.0
                 + cfg.n_subcarriers * cfg.n_rx * cfg.n_tx * 8.0)
        return pool.BlockCycles(
            te_cycles=0.0,
            pe_cycles=pool.pe_cycles(flops, ipc=0.6),
            dma_cycles=pool.dma_cycles(
                _grid_bytes(cfg, cfg.n_rx)
                + cfg.n_subcarriers * cfg.n_rx * cfg.n_tx * _C16
            ),
        )

    return RxStage("ls_che", "PE", apply, cycles)


def mmse_che_stage(cfg: ofdm.GridConfig, corr_len: float = 16.0) -> RxStage:
    """Wiener smoothing of the LS estimate per antenna pair."""

    def apply(state):
        state["h_hat"] = classical.mmse_smooth_link(
            state["h_ls"], state["noise_var"], corr_len=corr_len
        )
        return state

    def cycles():
        n_sc = cfg.n_subcarriers
        flops = 8.0 * n_sc * n_sc * cfg.n_rx * cfg.n_tx
        return pool.BlockCycles(
            te_cycles=0.0,
            pe_cycles=pool.pe_cycles(flops, ipc=0.77),
            dma_cycles=pool.dma_cycles(
                2 * n_sc * cfg.n_rx * cfg.n_tx * _C16
            ),
        )

    return RxStage("mmse_che", "PE", apply, cycles)


def _broadcast_h(h_est, n_sym):
    b, n_sc, n_rx, n_tx = h_est.shape
    return h_est[:, None].expand(b, n_sym, n_sc, n_rx, n_tx).reshape(
        b * n_sym, n_sc, n_rx, n_tx
    )


def detect_demap_stage(cfg: ofdm.GridConfig, modem: ofdm.Modem,
                       precision: Optional[str] = None) -> RxStage:
    """Fused equalize -> demap (:func:`rx_fused.mmse_detect_demap`);
    quantized precisions emit LLRs on the int8 grid."""

    def apply(state):
        h_est = state.get("h_hat", state.get("h_ls"))
        x_hat, nv_eff, llr = rx_fused.mmse_detect_demap(
            state["y"], h_est, state["noise_var"], modem,
            precision=precision,
        )
        state["x_hat"], state["nv_eff"], state["llr"] = x_hat, nv_eff, llr
        return state

    def cycles():
        t, r = cfg.n_tx, cfg.n_rx
        lvl = 2 ** (modem.bits_per_symbol // 2)
        per_re = (8.0 * (t * t * r + t ** 3 + t * r) + t * lvl * 8.0)
        flops = cfg.n_symbols * cfg.n_subcarriers * per_re
        return pool.BlockCycles(
            te_cycles=0.0,
            pe_cycles=pool.pe_cycles(flops, ipc=0.8),
            dma_cycles=pool.dma_cycles(
                _grid_bytes(cfg, cfg.n_rx)
                + cfg.n_subcarriers * cfg.n_rx * cfg.n_tx * _C16
                + _grid_bytes(cfg, cfg.n_tx * modem.bits_per_symbol // 2)
            ),
        )

    return RxStage("detect_demap_fused", "PE", apply, cycles)


def sic_demap_stage(cfg: ofdm.GridConfig, modem: ofdm.Modem,
                    precision: Optional[str] = None) -> RxStage:
    """Fused SIC equalize -> demap (:func:`rx_fused.sic_detect_demap`),
    the MU-MIMO near-far receiver: ``n_tx`` cancellation stages, each a
    shrinking solve over the streams not cancelled yet, a hard
    re-modulation and a residual subtraction, in index order (the MU-MIMO
    scenarios register their users strongest-first).  ``precision`` as in
    :func:`detect_demap_stage`."""

    def apply(state):
        h_est = state.get("h_hat", state.get("h_ls"))
        x_hat, nv_eff, llr = rx_fused.sic_detect_demap(
            state["y"], h_est, state["noise_var"], modem,
            precision=precision,
        )
        state["x_hat"], state["nv_eff"], state["llr"] = x_hat, nv_eff, llr
        return state

    def cycles():
        t, r = cfg.n_tx, cfg.n_rx
        lvl = 2 ** (modem.bits_per_symbol // 2)
        # shrinking gram+solve+rhs per stage (sizes t..1), one stream
        # demapped per stage, plus the hard-remod cancellation
        solve = sum(8.0 * (m * m * r + m ** 3 + m * r)
                    for m in range(1, t + 1))
        per_re = solve + t * lvl * 8.0 + (t - 1) * 8.0 * r
        flops = cfg.n_symbols * cfg.n_subcarriers * per_re
        return pool.BlockCycles(
            te_cycles=0.0,
            pe_cycles=pool.pe_cycles(flops, ipc=0.8),
            dma_cycles=pool.dma_cycles(
                _grid_bytes(cfg, cfg.n_rx)
                + cfg.n_subcarriers * cfg.n_rx * cfg.n_tx * _C16
                + _grid_bytes(cfg, cfg.n_tx * modem.bits_per_symbol // 2)
            ),
        )

    return RxStage("sic_demap_fused", "PE", apply, cycles)


def detect_stage(cfg: ofdm.GridConfig, fused: bool = False,
                 modem: Optional[ofdm.Modem] = None,
                 precision: Optional[str] = None) -> RxStage:
    """MIMO-MMSE detection; ``fused=True`` (requires ``modem``) returns
    the combined :func:`detect_demap_stage`, so builders then skip
    :func:`demod_stage`."""
    if fused:
        if modem is None:
            raise ValueError("fused detect+demap needs the modem")
        return detect_demap_stage(cfg, modem, precision=precision)

    def apply(state):
        h_est = state.get("h_hat", state.get("h_ls"))
        b, n_sym, n_sc, n_rx = state["y"].shape
        yf = state["y"].reshape(b * n_sym, n_sc, n_rx)
        x_hat, nv_eff = classical.mimo_mmse_detect_ext(
            yf, _broadcast_h(h_est, n_sym), state["noise_var"]
        )
        state["x_hat"] = x_hat.reshape(b, n_sym, n_sc, cfg.n_tx)
        state["nv_eff"] = nv_eff.reshape(b, n_sym, n_sc, cfg.n_tx)
        return state

    def cycles():
        t, r = cfg.n_tx, cfg.n_rx
        per_re = 8.0 * (t * t * r + t ** 3 + t * r)
        flops = cfg.n_symbols * cfg.n_subcarriers * per_re
        return pool.BlockCycles(
            te_cycles=0.0,
            pe_cycles=pool.pe_cycles(flops, ipc=0.59),
            dma_cycles=pool.dma_cycles(
                _grid_bytes(cfg, cfg.n_rx) + _grid_bytes(cfg, cfg.n_tx)
            ),
        )

    return RxStage("mmse_detect", "PE", apply, cycles)


def demod_stage(cfg: ofdm.GridConfig, modem: ofdm.Modem,
                precision: Optional[str] = None) -> RxStage:
    def apply(state):
        llr = modem.demod_llr(state["x_hat"], state["nv_eff"])
        if quant.is_quantized(precision):
            llr = quant.fake_quant_llr(llr, precision)
        state["llr"] = llr
        return state

    def cycles():
        lvl = 2 ** (modem.bits_per_symbol // 2)
        flops = (cfg.n_symbols * cfg.n_subcarriers * cfg.n_tx
                 * lvl * 8.0)
        return pool.BlockCycles(
            te_cycles=0.0,
            pe_cycles=pool.pe_cycles(flops, ipc=0.6),
            dma_cycles=pool.dma_cycles(
                _grid_bytes(cfg, cfg.n_tx * modem.bits_per_symbol // 2)
            ),
        )

    return RxStage("llr_demod", "PE", apply, cycles)


def decode_stage(scenario: LinkScenario, *, max_iters: int = 12,
                 alpha: float = 0.8,
                 precision: Optional[str] = None) -> RxStage:
    """CRC + LDPC decode of the slot's transport blocks (the saturating
    int8 decoder for ``precision="int8"|"fp8"``).  HARQ state rides in the
    slot: ``rv`` (B,) and ``prior_llr`` (B, C, n_mother), when present,
    pick each slot's RV window and accumulate the prior."""
    code = scenario.code
    if code is None:
        raise ValueError(f"{scenario.name} has no channel code")
    n_cw = coding.codewords_per_slot(scenario)

    def apply(state):
        state.update(
            coding.decode_blocks(
                scenario, state["llr"], max_iters=max_iters, alpha=alpha,
                rv=state.get("rv"), prior_llr=state.get("prior_llr"),
                precision=precision,
            )
        )
        return state

    def cycles():
        n_edges = sum(len(e) for e in code.layers())
        iters_budget = max_iters / 2.0
        sweep_flops = n_cw * iters_budget * n_edges * code.z * 8.0
        syndrome_flops = n_cw * iters_budget * n_edges * code.z * 2.0
        crc_macs = n_cw * code.k_info * code.crc_bits
        return pool.BlockCycles(
            te_cycles=pool.te_cycles(crc_macs, utilization=0.67),
            pe_cycles=pool.pe_cycles(sweep_flops + syndrome_flops, ipc=0.7),
            dma_cycles=pool.dma_cycles(
                n_cw * code.n_mother * 4.0 + n_cw * code.k / 8.0
            ),
        )

    return RxStage("ldpc_decode", "PE", apply, cycles)


def llr_quant_stage(precision: str) -> RxStage:
    """Round-trip the LLR plane through the precision's grid
    (:func:`quant.fake_quant_llr`), after receivers that emit LLRs directly
    (DeepRx), so the decoder sees the grid a quantized demapper would hand
    it.  Elementwise work with no cost model of its own, as in the
    reference."""
    p = quant.resolve_precision(precision)

    def apply(state):
        state["llr"] = quant.fake_quant_llr(state["llr"], p)
        return state

    return RxStage(f"llr_quant@{p}", "PE", apply, None)


# -- neural stages ----------------------------------------------------------

def deeprx_stage(cfg: ofdm.GridConfig, modem: ofdm.Modem, params,
                 dcfg: models.DeepRxConfig,
                 device: DeviceLike = None) -> RxStage:
    """The DeepRx conv receiver: grid features -> LLRs (B, n_sym, n_sc,
    n_tx, bits)."""
    dev = resolve_device(device)
    union = torch.any(ofdm.link_pilot_masks(cfg, dev), dim=0)
    pm_plane = union[None, :, :, None].to(torch.float32)
    nb = modem.bits_per_symbol

    def apply(state):
        y = state["y"]  # (B, n_sym, n_sc, n_rx)
        b, n_sym, n_sc, _ = y.shape
        h_ls = state["h_ls"].reshape(b, 1, n_sc, -1).expand(
            b, n_sym, n_sc, -1)  # (n_rx, n_tx) flattened, n_tx fastest
        pm = pm_plane.expand(b, n_sym, n_sc, 1)
        nv = rx_fused.noise_var_rows(state["noise_var"], b).to(
            torch.float32).reshape(-1, 1, 1, 1).expand(b, n_sym, n_sc, 1)
        feats = torch.cat(
            [y.real, y.imag, h_ls.real, h_ls.imag, pm, nv], dim=-1,
        ).to(torch.float32)
        llr = models.deeprx_apply(params, dcfg, feats)
        state["llr"] = llr.reshape(b, n_sym, n_sc, cfg.n_tx, nb)
        return state

    def cycles():
        grid = cfg.n_symbols * cfg.n_subcarriers
        c = dcfg.channels
        macs = grid * (9.0 * dcfg.in_features * c
                       + dcfg.blocks * 2 * 9.0 * c * c
                       + c * dcfg.bits_per_re)
        relu_elems = grid * c * (1 + 2 * dcfg.blocks)
        pbytes = 2 * _params.count_params(params)  # priced at fp16
        return pool.BlockCycles(
            te_cycles=pool.te_cycles(macs, utilization=0.67),
            pe_cycles=pool.pe_elem_cycles(relu_elems, "relu"),
            dma_cycles=pool.dma_cycles(
                pbytes + _grid_bytes(cfg, dcfg.in_features)
                + _grid_bytes(cfg, dcfg.bits_per_re)
            ),
        )

    return RxStage("deeprx", "TE", apply, cycles)


def cevit_che_stage(cfg: ofdm.GridConfig, params, mcfg: models.CEViTConfig,
                    device: DeviceLike = None) -> RxStage:
    """CE-ViT channel estimation: each (rx, tx) pair's LS estimate over
    the subcarriers -> the refined ``h_hat`` (B, n_sc, n_rx, n_tx)."""
    dev = resolve_device(device)
    comb_tx = torch.any(ofdm.link_pilot_masks(cfg, dev), dim=1)  # (n_tx, n_sc)
    pair_flags = comb_tx.to(torch.float32).repeat(cfg.n_rx, 1)  # n_tx fastest

    def apply(state):
        h_ls = state["h_ls"]  # (B, n_sc, n_rx, n_tx)
        b, n_sc, n_rx, n_tx = h_ls.shape
        pairs = torch.movedim(h_ls, 1, -1).reshape(b * n_rx * n_tx, n_sc)
        flags = pair_flags.repeat(b, 1)  # (B*n_rx*n_tx, n_sc)
        nv = rx_fused.noise_var_rows(state["noise_var"], pairs.shape[0]).to(
            torch.float32).reshape(-1, 1).expand(pairs.shape)
        feats = torch.stack([pairs.real, pairs.imag, flags, nv], dim=-1)
        h_hat = models.cevit_apply(params, mcfg, feats)
        state["h_hat"] = torch.movedim(h_hat.reshape(b, n_rx, n_tx, n_sc),
                                       -1, 1)
        return state

    def cycles():
        n_tok = cfg.n_subcarriers // mcfg.patch
        pairs = cfg.n_rx * cfg.n_tx
        per_layer = pool.mha_block_cycles(mcfg.heads, n_tok, mcfg.d_model)
        mlp_macs = 2.0 * n_tok * mcfg.d_model * mcfg.d_ff
        pin = mcfg.patch * mcfg.in_features
        embed_macs = n_tok * pin * mcfg.d_model
        head_macs = n_tok * mcfg.d_model * mcfg.patch * 2
        ln_elems = mcfg.layers * 2 * n_tok * mcfg.d_model
        gelu_elems = mcfg.layers * n_tok * mcfg.d_ff
        one_pair = _sum_cycles(
            [per_layer] * mcfg.layers
            + [pool.BlockCycles(
                te_cycles=pool.te_cycles(
                    mcfg.layers * mlp_macs + embed_macs + head_macs,
                    utilization=0.67,
                ),
                pe_cycles=(pool.pe_elem_cycles(ln_elems, "layernorm")
                           + pool.pe_elem_cycles(gelu_elems, "relu")),
                dma_cycles=pool.dma_cycles(2 * cfg.n_subcarriers * _C16),
            )]
        )
        return pool.BlockCycles(
            te_cycles=pairs * one_pair.te_cycles,
            pe_cycles=pairs * one_pair.pe_cycles,
            dma_cycles=pairs * one_pair.dma_cycles,
        )

    return RxStage("cevit_che", "TE", apply, cycles)


# ---------------------------------------------------------------------------
# Pipeline builders
# ---------------------------------------------------------------------------

def _precision_tag(precision: str) -> str:
    return f"@{precision}" if quant.is_quantized(precision) else ""


def build_classical(scenario: LinkScenario, *, mmse_smooth: bool = True,
                    fused: bool = False, sic: bool = False,
                    precision: Optional[str] = None,
                    device: DeviceLike = None, **_) -> ReceiverPipeline:
    """CFFT -> LS CHE [-> Wiener CHE] -> MIMO-MMSE detect -> LLR demod
    [-> CRC+LDPC decode].

    ``fused=True`` serves LS CHE and detect+demap through the hand-written
    kernels of :mod:`repro_torch.kernels.rx_fused`; the decode stage runs
    the LDPC kernel either way.  ``sic=True`` replaces the joint detect +
    demap with the fused SIC stage (:func:`sic_demap_stage`), the MU-MIMO
    near-far receiver; SIC is always fused, and ``fused`` then controls
    only LS CHE.  ``precision="int8"|"fp8"`` serves the LLR plane on the
    int8 grid and decodes on the saturating int8 datapath.
    """
    p = quant.resolve_precision(precision)
    dev = resolve_device(device)
    cfg, modem = scenario.grid, scenario.modem
    stages = [cfft_stage(cfg), ls_che_stage(cfg, fused=fused, device=dev)]
    if mmse_smooth:
        stages.append(mmse_che_stage(cfg))
    if sic:
        stages.append(sic_demap_stage(cfg, modem, precision=p))
    elif fused:
        stages.append(detect_stage(cfg, fused=True, modem=modem,
                                   precision=p))
    else:
        stages += [detect_stage(cfg), demod_stage(cfg, modem, precision=p)]
    if scenario.code is not None:
        stages.append(decode_stage(scenario, precision=p))
    tag = ("+sic" if sic else "") + ("+fused" if fused else "")
    return ReceiverPipeline(
        f"classical{tag}{_precision_tag(p)}/{scenario.name}", stages,
        scenario, precision=p, device=dev,
    )


def _neural_params(params, schema, seed: int, dev: torch.device):
    """The caller's weights (checked against the schema) or the port's own
    initialisation on ``dev``, drawn from ``seed``."""
    if params is None:
        return _params.init_params(schema, ofdm.make_generator(seed, dev))
    _params.check_shapes(schema, params)
    return params


def build_deeprx(scenario: LinkScenario, *, params=None, channels: int = 32,
                 blocks: int = 2, seed: int = 0,
                 precision: Optional[str] = None, device: DeviceLike = None,
                 **_) -> ReceiverPipeline:
    """CFFT -> LS CHE -> DeepRx conv receiver (grid features -> LLRs)
    [-> CRC+LDPC decode].

    ``params=None`` draws the port's own weights from ``seed`` (the
    reference's distribution, not its numbers: carry its arrays across
    with :func:`models.deeprx_params_from_numpy` for those).  The network
    always runs through the TE GEMM kernel on the card; the reference's
    ``fused`` switch (a TPU tiling fallback) is accepted and ignored.
    Quantized precisions round the network's output LLR plane onto the
    int8 grid (``llr_quant_stage``; the network stays fp32) and decode on
    the int8 datapath."""
    p = quant.resolve_precision(precision)
    dev = resolve_device(device)
    cfg, modem = scenario.grid, scenario.modem
    dcfg = models.DeepRxConfig(
        channels=channels, blocks=blocks,
        bits_per_re=cfg.n_tx * modem.bits_per_symbol,
        in_features=2 * cfg.n_rx + 2 * cfg.n_rx * cfg.n_tx + 2,
    )
    params = _neural_params(params, models.deeprx_schema(dcfg), seed, dev)
    stages = [
        cfft_stage(cfg), ls_che_stage(cfg, device=dev),
        deeprx_stage(cfg, modem, params, dcfg, device=dev),
    ]
    if quant.is_quantized(p):
        stages.append(llr_quant_stage(p))
    if scenario.code is not None:
        stages.append(decode_stage(scenario, precision=p))
    return ReceiverPipeline(
        f"deeprx{_precision_tag(p)}/{scenario.name}", stages, scenario,
        params=params, precision=p, device=dev,
    )


def build_cevit(scenario: LinkScenario, *, params=None, d_model: int = 64,
                heads: int = 4, layers: int = 2, d_ff: int = 128,
                patch: int = 4, fused_rx: bool = False,
                seed: int = 0, precision: Optional[str] = None,
                device: DeviceLike = None, **_) -> ReceiverPipeline:
    """CFFT -> LS CHE -> CE-ViT CHE -> MIMO-MMSE detect -> LLR demod
    [-> CRC+LDPC decode].

    The network always runs through the TE GEMM and flash-MHA kernels on
    the card (the reference's ``fused`` switch is accepted and ignored, as
    in :func:`build_deeprx`); ``fused_rx`` serves the detect+demap tail
    through the fused detect+demap kernel.  ``params`` and ``seed`` as in
    :func:`build_deeprx`.  Quantized precisions serve the detect+demap
    tail's LLRs on the int8 grid and decode on the int8 datapath."""
    p = quant.resolve_precision(precision)
    dev = resolve_device(device)
    cfg, modem = scenario.grid, scenario.modem
    mcfg = models.CEViTConfig(
        d_model=d_model, heads=heads, layers=layers, d_ff=d_ff, patch=patch
    )
    params = _neural_params(params, models.cevit_schema(mcfg), seed, dev)
    stages = [
        cfft_stage(cfg), ls_che_stage(cfg, device=dev),
        cevit_che_stage(cfg, params, mcfg, device=dev),
    ]
    if fused_rx:
        stages.append(detect_stage(cfg, fused=True, modem=modem,
                                   precision=p))
    else:
        stages += [detect_stage(cfg), demod_stage(cfg, modem, precision=p)]
    if scenario.code is not None:
        stages.append(decode_stage(scenario, precision=p))
    return ReceiverPipeline(
        f"cevit{_precision_tag(p)}/{scenario.name}", stages, scenario,
        params=params, precision=p, device=dev,
    )


PIPELINE_BUILDERS: dict = {
    "classical": build_classical,
    "deeprx": build_deeprx,
    "cevit": build_cevit,
}


def build_pipeline(kind: str, scenario: LinkScenario,
                   **kw) -> ReceiverPipeline:
    if kind not in PIPELINE_BUILDERS:
        raise KeyError(
            f"unknown receiver {kind!r}; have {sorted(PIPELINE_BUILDERS)}"
        )
    return PIPELINE_BUILDERS[kind](scenario, **kw)
