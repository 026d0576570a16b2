"""omni_tpu_torch — the PyTorch/CUDA port of `omni_tpu`, for an NVIDIA H100.

The JAX package `omni_tpu` is the reference; this package mirrors its
module names so each counterpart is easy to find. It imports `torch` and
numpy only: never `jax` and nothing of `omni_tpu` (whose package
`__init__` runs JAX set-up), so it starts on a machine without JAX.

Entry points run on the card. The CPU is used only when a caller passes
`device="cpu"` (the tests do); with no device given and no CUDA, they
raise instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: `device` if given, else CUDA.

    Raises RuntimeError when no device is given and CUDA is absent."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "omni_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain CPU path")
    return torch.device("cuda")
