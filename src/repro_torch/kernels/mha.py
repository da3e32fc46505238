"""Flash multi-head attention (port of :mod:`repro.kernels.mha`): q, k, v
(BH, S, D) with batch and heads flattened, scores ``q * D**-0.5 @ k^T``,
an optional causal mask (``q_pos >= k_pos``, -1e30 fill), softmax in fp32,
output in q's dtype.

:func:`mha` runs the plain PyTorch twin (:func:`mha_torch`, the reference
oracle's arithmetic) only because the tensor it was given lies on the CPU;
on a CUDA tensor it launches ``csrc/mha.cu`` (tensor cores, online softmax
over key tiles, scores never in device memory) or raises.  It takes any
D: the kernel tiles the output's D over a grid axis, and the wrapper only
zero-pads D to a 16-byte row pitch (:func:`align_head_dim`), run with the
true D's scale and cut back.  Its key-split cluster is
:func:`pick_cluster`'s: a winner of :mod:`repro_torch.kernels.tune`,
else the static heuristic.  Under grad it runs in :class:`MhaFunction`,
whose backward is torch ops: the reference's has no backward kernel
either.

The quantized attention (``mha_quant`` of the reference) splits as the
reference's does: :func:`quantize_mha_operands` (torch ops: int8 / e4m3
codes with one fp32 scale per (batch*head) row), then
:func:`mha_quantized` on the codes, which launches ``csrc/mha_quant.cu``
on a CUDA tensor and runs :func:`mha_quantized_torch` on a CPU one.  It
takes any D: the kernel tiles the output's D over a grid axis, and the
wrapper zero-pads the codes' D only to a multiple of 16, the TMA copies'
row pitch (:func:`pad_head_dim`), run with the true D's scale.
:func:`mha_quant` is the two in a row; :func:`mha_quant_torch` is the
twin of the reference's ``mha_quant_jnp``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, quant, tune

NEG_INF = -1e30
CODE_PITCH = 16  # codes a row of the quantized kernel's operands rounds to
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_QTYPE_CODE = {torch.int8: 0, quant.FP8_DTYPE: 1}

# ---------------------------------------------------------------------------
# launch choice: mha.cu's key-split cluster (cs,)
# ---------------------------------------------------------------------------

CLUSTERS = (1, 2, 4, 8)  # blocks of a cluster mha.cu launches
_BM = _BKV = 64  # query rows and keys of a tile


def _key_tiles(sq: int, sk: int, causal: bool) -> int:
    """Key tiles the last query tile sees (all of them unless causal)."""
    kv_max = min(sk, -(-sq // _BM) * _BM) if causal else sk
    return -(-kv_max // _BKV)


def _valid_cluster(choice: tuple, sq: int, sk: int, causal: bool) -> bool:
    return (len(choice) == 1 and choice[0] in CLUSTERS
            and choice[0] <= _key_tiles(sq, sk, causal))


def _cluster_heuristic(bh: int, sq: int, sk: int, d: int, causal: bool,
                       dtype: torch.dtype, sms: int) -> tuple:
    """mha.cu's cluster before it took one: doubled while each block keeps
    a key tile and the grid stays within one wave of ``sms`` SMs."""
    per = 16 // (4 if dtype == torch.float32 else 2)
    dp = -(-d // per) * per  # the 16-byte row pitch the wrapper pads to
    dv = next((v for v in (16, 32, 64) if dp <= v), 128)
    units = bh * -(-sq // _BM) * -(-dp // dv)
    tiles = _key_tiles(sq, sk, causal)
    cs = 1
    while cs < CLUSTERS[-1] and 2 * cs <= tiles and units * 2 * cs <= sms:
        cs *= 2
    return (cs,)


def pick_cluster(bh: int, sq: int, sk: int, d: int, causal: bool = True,
                 dtype: torch.dtype = torch.float32, sms: int = 132
                 ) -> tuple:
    """``mha.cu``'s key-split cluster (cs,) for (bh, sq, sk, d) on a card
    of ``sms`` SMs: the ``cuda`` winner of :mod:`repro_torch.kernels.tune`
    for ("mha", (bh, sq, sk, d)) when it is at most the key tiles, else
    the static heuristic.  Memoized
    (:func:`~repro_torch.kernels.tune.picked`)."""
    return tune.picked(
        ("mha", bh, sq, sk, d, causal, dtype, sms),
        lambda: tune.resolve(
            "mha", (bh, sq, sk, d), "",
            lambda c: _valid_cluster(c, sq, sk, causal),
            lambda: _cluster_heuristic(bh, sq, sk, d, causal, dtype, sms)))


def cluster_candidates(bh: int, sq: int, sk: int, d: int,
                       causal: bool = True) -> list:
    """The tuner's candidates: every cluster up to the key tiles."""
    tiles = _key_tiles(sq, sk, causal)
    return [(c,) for c in CLUSTERS if c <= tiles]


def _probabilities(s: torch.Tensor, causal: bool) -> torch.Tensor:
    """fp32 scores (BH, Sq, Sk), masked (q_pos >= k_pos) where causal,
    softmaxed over the keys."""
    if causal:
        sq, sk = s.shape[1], s.shape[2]
        keep = (torch.arange(sq, device=s.device)[:, None]
                >= torch.arange(sk, device=s.device)[None, :])
        s = torch.where(keep, s, NEG_INF)
    return torch.softmax(s, dim=-1)


def _zero_pad(ts: tuple, dp: int) -> tuple:
    """Each (..., D) operand zero-padded along D to ``dp`` (as given when
    D is ``dp``)."""
    d = ts[0].shape[-1]
    if dp == d:
        return ts
    padded = []
    for t in ts:
        z = t.new_zeros(*t.shape[:-1], dp)
        z[..., :d] = t
        padded.append(z)
    return tuple(padded)


def pad_head_dim(*ts: torch.Tensor) -> tuple:
    """Each (BH, S, D) code operand zero-padded along D to a multiple of
    :data:`CODE_PITCH` (as given when D is one): the 16-byte row pitch of
    the quantized kernel's TMA copies, which read zeros past it up to the
    next 32-code wgmma k-step.  Zero dims add nothing to a score and make
    zero output columns, so with the true D's scale the padded attention
    cut back to D is the unpadded one."""
    d = ts[0].shape[-1]
    return _zero_pad(ts, -(-d // CODE_PITCH) * CODE_PITCH)


def align_head_dim(*ts: torch.Tensor) -> tuple:
    """Each (BH, S, D) operand zero-padded along D to a row pitch of a
    multiple of 16 bytes (what the TMA copies of ``csrc/mha.cu`` need), as
    given when its rows already are."""
    per = 16 // ts[0].element_size()
    d = ts[0].shape[-1]
    return _zero_pad(ts, -(-d // per) * per)


def mha_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale=None) -> torch.Tensor:
    """Plain twin: the whole score matrix, masked, softmaxed, times v.
    ``scale`` defaults to ``D**-0.5``."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    s = (q.to(torch.float32) * scale) @ k.to(torch.float32).transpose(
        -1, -2)
    return (_probabilities(s, causal) @ v.to(torch.float32)).to(q.dtype)


def _lib():
    fn = _build.library("mha").mha_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def mha_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool = True,
             choice: Optional[tuple] = None) -> torch.Tensor:
    """Launch ``csrc/mha.cu``: a warpgroup per (bh, 64-row query tile,
    output slab of D), a cluster of ``choice`` = (cs,) blocks splitting
    the keys (by default :func:`pick_cluster`'s; the kernel refuses a
    cluster it has no instance for); D zero-padded to a 16-byte row
    pitch."""
    if q.ndim != 3 or k.ndim != 3 or tuple(k.shape) != tuple(v.shape) or \
            k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"mha: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not (BH, Sq, D), (BH, Sk, D)")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if min(bh, sq, sk, d) == 0:
        raise ValueError(f"mha: empty operand {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"mha kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    _build.require_cuda("mha", q=(q, q.dtype), k=(k, q.dtype),
                        v=(v, q.dtype))
    launch = _lib()  # the kernel first: the picker reads the card
    choice = (pick_cluster(bh, sq, sk, d, causal, q.dtype,
                           _build.sm_count(q.get_device())) if choice is None
              else tune.as_choice(choice, 1, "mha", "(cs,)"))
    q, k, v = align_head_dim(q, k, v)
    # TMA reads from 16-byte aligned bases (a view may start off one)
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    dp = q.shape[-1]
    out = torch.empty((bh, sq, dp), dtype=q.dtype, device=q.device)
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bh, sq, sk, dp, int(causal), d ** -0.5,
                 _DTYPE_CODE[q.dtype], choice[0], _build.stream_of(q))
    _build.launches["mha"] += 1
    _build.launch_choices["mha"] = choice
    _build.check(err, "mha")
    return out if dp == d else out[..., :d].contiguous()


def _mha_forward(q, k, v, causal, choice):
    if q.device.type == "cpu":
        if choice is not None and not _valid_cluster(
                tuple(choice), q.shape[1], k.shape[1], causal):
            raise ValueError(f"mha: no kernel instance for launch choice "
                             f"{tuple(choice)}")
        return mha_torch(q, k, v, causal=causal)
    return mha_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                    causal=causal, choice=choice)


class MhaFunction(torch.autograd.Function):
    """:func:`mha` with a gradient: the forward is the wrapper's own route
    (the kernel on a CUDA tensor, the twin on a CPU one), the backward
    plain torch ops in fp32 on either device, as the reference trains
    through XLA autodiff of its jnp path.  It recomputes the probabilities
    P from q and k, then dV = P^T dO, dS = P * (dO V^T - rowsum(dO * O))
    (the row sum taken as rowsum(P * dO V^T), equal to it in exact
    arithmetic, so O is neither saved nor rounded to q's dtype) and
    dQ = scale dS K, dK = scale dS^T Q; each gradient is cast to its
    operand's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal, choice=None):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _mha_forward(q, k, v, causal, choice)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        scale = q.shape[-1] ** -0.5
        q32, k32, v32 = (t.to(torch.float32) for t in (q, k, v))
        g = g.to(torch.float32)
        p = _probabilities((q32 * scale) @ k32.transpose(-1, -2),
                           ctx.causal)
        dp = g @ v32.transpose(-1, -2)
        ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        return ((scale * (ds @ k32)).to(q.dtype) if need_q else None,
                (scale * (ds.transpose(-1, -2) @ q32)).to(k.dtype)
                if need_k else None,
                (p.transpose(-1, -2) @ g).to(v.dtype) if need_v else None,
                None, None)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, choice: Optional[tuple] = None) -> torch.Tensor:
    """Attention over (BH, S, D) operands: the CUDA kernel on a CUDA tensor
    (laid out contiguously first, launched with the cluster ``choice`` =
    (cs,), by default :func:`pick_cluster`'s), the plain twin on a CPU
    tensor (an explicit ``choice`` is still checked).  With grad mode on
    and an operand that requires grad, the same route runs inside
    :class:`MhaFunction`, whose backward is plain torch."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return MhaFunction.apply(q, k, v, causal, choice)
    return _mha_forward(q, k, v, causal, choice)


# ---------------------------------------------------------------------------
# quantized path (int8 / e4m3 q, k, v; dequant on load; fp32 softmax)
# ---------------------------------------------------------------------------

def quantize_mha_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          precision: str):
    """-> (qq, kq, vq, qs, ks, vs): codes with one fp32 scale per
    (batch*head) row, shape (BH, 1).  A softmax row mixes every position
    of one head, so the scale is uniform along S and D."""
    qq, qs = quant.quantize(q, precision, axis=(1, 2))
    kq, ks = quant.quantize(k, precision, axis=(1, 2))
    vq, vs = quant.quantize(v, precision, axis=(1, 2))
    to2d = lambda s: s.reshape(s.shape[0], 1)
    return qq, kq, vq, to2d(qs), to2d(ks), to2d(vs)


def mha_quantized_torch(qq: torch.Tensor, kq: torch.Tensor,
                        vq: torch.Tensor, qs: torch.Tensor, ks: torch.Tensor,
                        vs: torch.Tensor, *, causal: bool = True,
                        out_dtype: torch.dtype = torch.float32,
                        scale=None) -> torch.Tensor:
    """Plain twin on the codes: q dequantized as ``q * (qs * ks *
    scale)`` (``scale`` defaults to ``D**-0.5``), the whole score matrix
    against the k codes, softmax in fp32, times the v codes, scaled by
    vs."""
    d = qq.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    qf = qq.to(torch.float32) * (qs * ks * scale)[..., None]
    s = qf @ kq.to(torch.float32).transpose(-1, -2)
    out = _probabilities(s, causal) @ vq.to(torch.float32)
    return (out * vs[..., None]).to(out_dtype)


def _quant_lib():
    fn = _build.library("mha_quant").mha_quant_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + \
            [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def mha_quantized_cuda(qq: torch.Tensor, kq: torch.Tensor, vq: torch.Tensor,
                       qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
                       *, causal: bool = True,
                       out_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """Launch ``csrc/mha_quant.cu``: a warpgroup per (bh, 64-row query
    tile, output slab of D), a cluster splitting the keys when that grid
    is small; the codes zero-padded along D to a multiple of 16, the
    output at the true D."""
    if qq.ndim != 3 or kq.ndim != 3 or tuple(kq.shape) != tuple(vq.shape) \
            or kq.shape[0] != qq.shape[0] or kq.shape[2] != qq.shape[2]:
        raise ValueError(f"mha_quant: q {tuple(qq.shape)}, k "
                         f"{tuple(kq.shape)}, v {tuple(vq.shape)} are not "
                         f"(BH, Sq, D), (BH, Sk, D)")
    bh, sq, d = qq.shape
    sk = kq.shape[1]
    if min(bh, sq, sk, d) == 0:
        raise ValueError(f"mha_quant: empty operand {tuple(qq.shape)}, "
                         f"{tuple(kq.shape)}")
    if qq.dtype not in _QTYPE_CODE:
        raise TypeError(f"mha_quant kernel takes int8 or float8_e4m3fn "
                        f"codes, got {qq.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"mha_quant kernel writes float32 or bfloat16, not "
                        f"{out_dtype}")
    for name, s in (("qs", qs), ("ks", ks), ("vs", vs)):
        if tuple(s.shape) != (bh, 1):
            raise ValueError(f"mha_quant: {name} {tuple(s.shape)} != "
                             f"({bh}, 1)")
    _build.require_cuda("mha_quant", qq=(qq, qq.dtype), kq=(kq, qq.dtype),
                        vq=(vq, qq.dtype), qs=(qs, torch.float32),
                        ks=(ks, torch.float32), vs=(vs, torch.float32))
    qq, kq, vq = pad_head_dim(qq, kq, vq)
    # TMA reads from 16-byte aligned bases (a view may start off one)
    qq, kq, vq = (t if t.data_ptr() % 16 == 0 else t.clone()
                  for t in (qq, kq, vq))
    dp = qq.shape[-1]
    out = torch.empty((bh, sq, d), dtype=out_dtype, device=qq.device)
    err = _quant_lib()(
        qq.data_ptr(), kq.data_ptr(), vq.data_ptr(), qs.data_ptr(),
        ks.data_ptr(), vs.data_ptr(), out.data_ptr(), bh, sq, sk, dp, d,
        int(causal), d ** -0.5, _QTYPE_CODE[qq.dtype],
        _DTYPE_CODE[out_dtype], _build.stream_of(qq))
    _build.launches["mha_quant"] += 1
    _build.check(err, "mha_quant")
    return out


def mha_quantized(qq: torch.Tensor, kq: torch.Tensor, vq: torch.Tensor,
                  qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor, *,
                  causal: bool = True,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Quantized attention on codes (the reference's ``pallas_call``
    operands): the CUDA kernel on a CUDA tensor (laid out contiguously
    first), the plain twin on a CPU tensor."""
    if qq.device.type == "cpu":
        return mha_quantized_torch(qq, kq, vq, qs, ks, vs, causal=causal,
                                   out_dtype=out_dtype)
    return mha_quantized_cuda(
        *(t.contiguous() for t in (qq, kq, vq, qs, ks, vs)), causal=causal,
        out_dtype=out_dtype)


def mha_quant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              precision: str = "int8", causal: bool = True) -> torch.Tensor:
    """Attention over int8 / e4m3 q, k, v: quantize (torch ops on q's
    device), then :func:`mha_quantized`.  Output in q's dtype."""
    ops = quantize_mha_operands(q, k, v, precision)
    return mha_quantized(*ops, causal=causal, out_dtype=q.dtype)


def mha_quant_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    precision: str = "int8",
                    causal: bool = True) -> torch.Tensor:
    """Plain twin of :func:`mha_quant` (the reference's ``mha_quant_jnp``)
    on any device."""
    ops = quantize_mha_operands(q, k, v, precision)
    return mha_quantized_torch(*ops, causal=causal, out_dtype=q.dtype)
