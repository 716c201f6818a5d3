"""Device selection for the port's entry points.

Every entry point takes a ``device`` that defaults to ``"cuda"``. Asking
for CUDA on a machine without a usable card raises; the port never falls
back to the CPU by itself. The CPU runs only when the caller names it, as
the CPU tests do, and then every kernel wrapper takes its plain PyTorch
version (``ppnp_tpu_torch.kernels``).
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The ``torch.device`` for ``device`` (default ``"cuda"``).

    Raises ``RuntimeError`` when a CUDA device is asked for and
    ``torch.cuda.is_available()`` is false.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ppnp_tpu_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is false; pass device='cpu' "
            "(CLI: --device cpu) to run the plain PyTorch versions on "
            "the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
