"""Parameter conversion from the JAX package's tree into the port's.

`from_jax_params` takes omni_tpu's parameter tree with every array already
converted to numpy (`jax.tree_util.tree_map(np.asarray, params)`): dicts,
lists, QTensor-like objects (anything with `ggml_type`, `shape` and
K-major planes) and arrays, bf16 arrays as ml_dtypes.bfloat16. Quantized
planes are transposed from [K', N] to the port's [N, K'], a pure
permutation of their bytes; the codebook formats' int8 value planes become
the port's nibble-index planes through the inverse codebook
(`qformats.codebook_plane`). The spoken round's trees come across the
same way: the APM's, the TTS decoder's and its extras (then
`tts.with_bf16`), the conformer's, the DiT's, the flow extras' and
HiFiGAN's (its resblocks' lists of (weight, bias) tuples), f32 arrays as
f32 tensors; the VPM's through `vpm_from_jax_params`. It imports nothing
of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .core.dtypes import GGMLType
from .kernels.qformats import CODEBOOK, PLANES, QTensor, codebook_plane


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: JAX's buffers are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _qtensor(qt, device) -> QTensor:
    t = GGMLType(int(qt.ggml_type))
    planes = {}
    for nm in PLANES:
        a = getattr(qt, nm, None)
        planes[nm] = (None if a is None
                      else _tensor(np.asarray(a).T, device))
    if t in CODEBOOK:
        planes["q"] = codebook_plane(planes["q"], t)
    return QTensor(t, tuple(int(s) for s in qt.shape), **planes)


def from_jax_params(params_np, device=None):
    """omni_tpu parameter tree (numpy leaves) -> the port's tree on
    `device`."""
    device = resolve_device(device)

    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if hasattr(x, "ggml_type") and hasattr(x, "q"):
            return _qtensor(x, device)
        return _tensor(x, device)

    return conv(params_np)


def vpm_from_jax_params(params_np, device=None) -> dict:
    """omni_tpu's VPM tree (`siglip.load_params`, numpy leaves; None where
    the file has no pre-LN or bias) -> the port's (`siglip.load_params`):
    f32 tensors, the patch weight [d, 3, p, p] viewed as the product's
    [d, 3 * p * p]."""
    p = from_jax_params(params_np, device)
    p["patch_w"] = p["patch_w"].reshape(p["patch_w"].shape[0], -1)
    return p
