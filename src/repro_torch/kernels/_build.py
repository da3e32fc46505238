"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is a self-contained source with a plain C entry
point.  At first CUDA use it is compiled by ``nvcc`` for ``sm_90a`` into
a shared library under ``build/repro_torch_kernels/`` at the repository
root (git-ignored) and loaded with :mod:`ctypes`; the library's file name
carries a hash of the source, the local headers it includes
(``#include "x.cuh"``, e.g. ``csrc/hopper.cuh``) and the flags, so an
edited source or header rebuilds.
:func:`build_all` starts one ``nvcc`` per source, all in parallel.

Every wrapper that launches a kernel adds one to :data:`launches` under
the kernel's name, and nowhere else, so a run can show that its path went
through the kernels (:func:`reset_launches` zeroes the counts); a kernel
with launch choices also records the last one in :data:`launch_choices`.

The kernels fill fresh tensors through ``ctypes``, which autograd cannot
see, so :func:`require_cuda` refuses (:func:`require_no_grad`) an operand
that requires grad while grad mode is on, rather than return a result
whose operands silently get no gradient.  ``te_gemm`` and ``mha`` launch
theirs inside a ``torch.autograd.Function`` (whose forward runs with grad
mode off) and so train; every other wrapper refuses.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# per-source flags.  -fmad=false: no multiply-add contraction, so the
# bit-exact kernels round every product and sum where their plain PyTorch
# twins do (the quantized GEMM's int8 path is exact: integer products,
# then the twin's dequant multiplies and bias add one by one); the other
# GEMM, attention and block kernels claim no bit-exactness (their sums
# run in another order than any library's) and keep FMA.  Each source's
# key is also the launch counter of its kernel, except detect_demap and
# ldpc_minsum, which hold two kernels each.
SOURCE_FLAGS = {
    "ls_che": ("-fmad=false",),
    "detect_demap": ("-fmad=false",),
    "ldpc_minsum": ("-fmad=false",),
    "te_gemm": (),
    "mha": (),
    "te_gemm_quant": ("-fmad=false",),
    "mha_quant": (),
    "fc_softmax": (),
    "dwconv_block": (),
}
SOURCES = tuple(SOURCE_FLAGS)

launches: collections.Counter = collections.Counter()
build_seconds: dict = {}  # the last build_all's seconds by source
# the launch choice (the tuple a kernel's ``pick_*`` returns) of each
# tuned kernel's last launch, under its launch counter's name
launch_choices: dict = {}
_libs: dict = {}


def reset_launches() -> None:
    launches.clear()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, or
    the ``PATH``; raise when there is none."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda or PATH): the "
            "repro_torch CUDA kernels are built from csrc/ at first use"
        )
    return found


def flags(name: str) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS[name]


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _source_bytes(path: Path, seen: set) -> bytes:
    """The file's bytes followed by those of every local header it
    includes, depth first, each header once."""
    data = path.read_bytes()
    parts = [data]
    for inc in _LOCAL_INCLUDE.findall(data):
        header = path.parent / inc.decode()
        if header not in seen:
            seen.add(header)
            parts.append(_source_bytes(header, seen))
    return b"".join(parts)


def library_path(name: str) -> Path:
    src = _source_bytes(CSRC / f"{name}.cu", set())
    digest = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names=SOURCES) -> float:
    """Compile every listed source whose library is missing, one ``nvcc``
    process each, all started together.  Returns the seconds it took;
    :data:`build_seconds` then holds each source's own (from the start to
    its ``nvcc``'s exit)."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    build_seconds.clear()
    if not todo:
        return 0.0
    exe = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [exe, *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )))
    logs = {}

    def finish(name, proc):  # one thread a process, so each exit is timed
        logs[name] = proc.communicate()[0]
        build_seconds[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=finish, args=(name, proc))
               for name, _, _, proc in procs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = []
    for name, out, tmp, proc in procs:
        log = logs[name]
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n"
                          f"{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def stream_of(t) -> int:
    """PyTorch's current stream on ``t``'s device, as the integer handle
    the kernels' C entry points take (no Stream object is built)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index`` (read once per device), which
    the launch heuristics size their grids by."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def require_no_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and any of ``tensors`` requires grad: a
    kernel's output carries no ``grad_fn``, so those operands would get no
    gradient and no error (serving runs under ``torch.no_grad()``)."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an operand requires grad, but the CUDA kernel has no "
            f"backward; call it under torch.no_grad() or detach the operands")


def require_cuda(name: str, **args) -> None:
    """Check each ``arg=(tensor, dtype)`` before its pointer goes to a
    kernel: all on one CUDA device, contiguous, of the given dtype, and
    none requiring grad while grad mode is on."""
    require_no_grad(name, *(t for t, _ in args.values()))
    dev = None  # the first tensor's CUDA device index
    for arg, (t, dtype) in args.items():
        if not t.is_cuda or (dev is not None and t.get_device() != dev):
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             + ("a CUDA device" if dev is None
                                else f"cuda:{dev}"))
        dev = t.get_device()
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected {dtype}")
