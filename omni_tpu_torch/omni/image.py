"""Host-side image preprocessing: LLaVA-UHD slicing for MiniCPM-V/o
(counterpart of omni_tpu/omni/image.py).

An overview image downscaled to at most `slice_size` (aspect kept, sides
rounded to patch multiples), plus up to `max_slice_nums` refined slices on
the grid whose aspect ratio is closest in log error (the reference's
llava_uhd, vision.cpp:1452-1640); bicubic resize for the overview,
bilinear for the refined image and for stacked frames; per-channel
mean/std normalization from the GGUF's metadata. The runtime
`max_slice_nums` override is the high-res mode switch (vision.cpp:182-183).

The JAX package resizes with Pillow. The card's machine has no Pillow, so
`resize` is a transcription of Pillow's 8-bit resampler
(src/libImaging/Resample.c) that gives its bytes exactly: two separable
passes, horizontal first, each through 22-bit fixed-point weights and a
clip to 0..255. Only `load_image` (decoding a file) needs Pillow.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class SliceInstructions:
    overview_size: tuple[int, int]  # (w, h)
    refined_size: tuple[int, int]
    grid: tuple[int, int]  # (gx, gy)
    slices: list[tuple[int, int, int, int]]  # (x, y, w, h)


def _ensure_divide(length: int, patch: int) -> int:
    return max(int(round(length / patch)) * patch, patch)


def _best_resize(w: int, h: int, scale_res: int, patch: int,
                 allow_upscale: bool = False) -> tuple[int, int]:
    if w * h > scale_res * scale_res or allow_upscale:
        r = w / h
        h = int(scale_res / math.sqrt(r))
        w = int(h * r)
    return _ensure_divide(w, patch), _ensure_divide(h, patch)


def _best_grid(max_slice_nums: int, multiple: int, log_ratio: float) -> tuple[int, int]:
    candidates = []
    for i in (multiple - 1, multiple, multiple + 1):
        if i == 1 or i > max_slice_nums:
            continue
        for m in range(1, i + 1):
            if i % m == 0:
                candidates.append((m, i // m))
    best, err = (1, 1), float("inf")
    for gx, gy in candidates:
        e = abs(log_ratio - math.log(gx / gy))
        if e < err:
            best, err = (gx, gy), e
    return best


def _refine_size(w: int, h: int, grid: tuple[int, int], scale_res: int,
                 patch: int) -> tuple[int, int]:
    gx, gy = grid
    rw, rh = _ensure_divide(w, gx), _ensure_divide(h, gy)
    cw, ch = _best_resize(rw // gx, rh // gy, scale_res, patch, True)
    return cw * gx, ch * gy


def get_slice_instructions(
    w: int, h: int, slice_size: int = 448, patch_size: int = 14,
    max_slice_nums: int = 9,
) -> SliceInstructions:
    has_slices = w > slice_size or h > slice_size
    overview = _best_resize(w, h, slice_size, patch_size, not has_slices)
    log_ratio = math.log(w / h)
    ratio = (w * h) / (slice_size * slice_size)
    multiple = min(math.ceil(ratio), max_slice_nums)
    grid = _best_grid(max_slice_nums, multiple, log_ratio)
    refined = _refine_size(w, h, grid, slice_size, patch_size)

    inst = SliceInstructions(overview, refined, grid, [])
    if not has_slices or max_slice_nums == 0:
        return inst
    gx, gy = grid
    sw, sh = refined[0] // gx, refined[1] // gy
    for iy in range(gy):
        for ix in range(gx):
            inst.slices.append((ix * sw, iy * sh, sw, sh))
    return inst


# ---------------------------------------------------------------------------
# Pillow's 8-bit resampler (Resample.c), in numpy
# ---------------------------------------------------------------------------

PRECISION_BITS = 32 - 8 - 2


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


def _coeffs(in_size: int, out_size: int, method: str):
    """Each output pixel's source window (first index [out, ksize], clamped
    to the image) and its 22-bit fixed-point weights [out, ksize] (0 past
    the window), as `precompute_coeffs` and `normalize_coeffs_8bpc`."""
    filt, support = _FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = np.arange(xmax)
        w = filt((x + xmin - center + 0.5) * (1.0 / filterscale))
        ww = w.sum()
        if ww != 0.0:
            w = w / ww
        w = w * (1 << PRECISION_BITS)
        kk[xx, :xmax] = np.where(w < 0, -0.5 + w, 0.5 + w).astype(np.int64)
        idx[xx, :xmax] = xmin + x
    return idx, kk


def _pass(img: np.ndarray, out_size: int, axis: int, method: str) -> np.ndarray:
    """One separable pass along `axis` of a uint8 [H, W, C] image."""
    idx, kk = _coeffs(img.shape[axis], out_size, method)
    src = np.take(img, idx, axis=axis).astype(np.int64)  # [..., out, ksize, ...]
    w = kk[:, :, None] if axis == 1 else kk[:, :, None, None]
    acc = (src * w).sum(axis=axis + 1) + (1 << (PRECISION_BITS - 1))
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize(img: np.ndarray, w: int, h: int, method: str) -> np.ndarray:
    """uint8 [H, W, C] -> uint8 [h, w, C], Pillow's `Image.resize((w, h),
    BICUBIC or BILINEAR)` byte for byte: horizontal pass, then vertical, a
    side of unchanged size not filtered."""
    if method not in _FILTERS:
        raise ValueError(f"resize: unknown method {method!r}")
    out = np.asarray(img, np.uint8)
    if out.shape[1] != w:
        out = _pass(out, w, 1, method)
    if out.shape[0] != h:
        out = _pass(out, h, 0, method)
    return np.ascontiguousarray(out)


def slice_image(
    img: np.ndarray,  # [H, W, 3] uint8
    inst: SliceInstructions,
) -> list[np.ndarray]:
    """Overview first, then refined slices (uint8 images)."""
    out = [resize(img, *inst.overview_size, "bicubic")]
    if inst.slices:
        refined = resize(img, *inst.refined_size, "bilinear")
        for x, y, w, h in inst.slices:
            out.append(refined[y: y + h, x: x + w])
    return out


def normalize(img: np.ndarray, mean, std) -> np.ndarray:
    """uint8 [H, W, 3] -> f32 normalized."""
    x = img.astype(np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def stack_frames(frames: list[np.ndarray]) -> np.ndarray:
    """High-refresh mode: the trailing video frames of one second merged
    into one grid image, two columns (at 5 fps frame 0 is the main image and
    the other four stack 2 x 2). Frames are resized (bilinear) to the first
    frame's size; an odd count pads with black."""
    if not frames:
        raise ValueError("stack_frames needs at least one frame")
    h, w = frames[0].shape[:2]
    cols = 2 if len(frames) > 1 else 1
    rows = -(-len(frames) // cols)
    resized = [f if f.shape[:2] == (h, w) else resize(f, w, h, "bilinear")
               for f in frames]
    while len(resized) < rows * cols:
        resized.append(np.zeros((h, w, 3), frames[0].dtype))
    rows_img = [np.concatenate(resized[r * cols:(r + 1) * cols], axis=1)
                for r in range(rows)]
    return np.concatenate(rows_img, axis=0)


def load_image(path: str) -> np.ndarray:
    """An image file -> uint8 [H, W, 3] RGB. Decoding needs Pillow."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"load_image({path!r}) needs Pillow to decode the file; "
                          "pass a uint8 [H, W, 3] array instead") from e
    return np.asarray(Image.open(path).convert("RGB"))


def preprocess_uhd(
    img: np.ndarray, mean, std, slice_size: int = 448, patch_size: int = 14,
    max_slice_nums: int = 9,
) -> list[np.ndarray]:
    """Full UHD pipeline: slice + normalize. Returns list of f32 [H, W, 3]."""
    inst = get_slice_instructions(img.shape[1], img.shape[0], slice_size,
                                  patch_size, max_slice_nums)
    return [normalize(s, mean, std) for s in slice_image(img, inst)]
