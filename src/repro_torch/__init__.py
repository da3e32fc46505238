"""PyTorch/CUDA port of the TensorPool AI-native PHY (the JAX package
:mod:`repro` is the reference it is checked against).

The layout mirrors :mod:`repro` module for module (``phy``, ``kernels``,
``serve``, ``core``, ``analysis``), so each port module sits where its
reference counterpart does.  The package imports ``torch`` and ``numpy``
only — never ``jax`` and never ``repro``.

Entry points take ``device=None``, which means CUDA
(:func:`repro_torch.device.resolve_device`); without a card they raise
instead of quietly running on the CPU.  Tests pass ``device="cpu"``, where
every hand-written kernel's wrapper runs its plain PyTorch twin.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
