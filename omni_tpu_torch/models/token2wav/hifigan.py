"""HiFiGAN2 (HiFT), the vocoder of Token2Wav: mel -> 24 kHz waveform
(counterpart of omni_tpu/models/token2wav/hifigan.py).

- F0 predictor: 5 x (conv k3 same + ELU) over the mel, linear -> |f0|.
- Sine source: f0 upsampled x480, harmonics 1..9, the per-frame mean phase
  increment, the cumulative phase interpolated linearly within a frame,
  sin x 0.1 where voiced (f0 > 10), merged to one channel by linear(9 -> 1)
  + tanh.
- Generator: conv_pre (k7) -> transposed convs x8, x5, x3 with the
  source's STFT (n_fft 16, hop 4) added at each scale through source_down
  convs and a resblock, each stage followed by 3 snake resblocks averaged;
  leaky ReLU 0.1 (0.01 before conv_post); conv_post (k7) -> 18 channels =
  log-magnitude (9) | phase (9); magnitude exp clamped at 100, phase
  sin(raw); the inverse STFT (Hann 16, hop 4, overlap-add normalised by
  the window squared); clamped to +-0.99. 480 samples a mel frame.

The STFT and its inverse are DFTs by matrix product over the 9 bins, as
the JAX package computes them (not torch.stft's framing).

Streaming: the source's first 8 mel frames (3,840 samples) are replaced
by the previous window's, for phase continuity; the caller crossfades.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ... import resolve_device
from .conformer import f32_getter

N_FFT = 16
HOP = 4
F_BINS = 9
SAMPLES_PER_MEL = 480
SR = 24000
HARMONICS = 9  # harmonic_num 8 + the fundamental
SINE_AMP = 0.1
VOICED_THRESHOLD = 10.0
LRELU = 0.1
AUDIO_LIMIT = 0.99
MEL_CACHE = 8
SOURCE_CACHE = MEL_CACHE * SAMPLES_PER_MEL


def _conv1d(x, w, b, stride=1, pad=0, dilation=1):
    """x [T, C], w [Cout, Cin, K]."""
    return F.conv1d(x.T[None], w, b, stride=stride, padding=pad,
                    dilation=dilation)[0].T


def _deconv1d(x, w, b, stride, pad):
    """ConvTranspose1d, w [Cin, Cout, K]."""
    return F.conv_transpose1d(x.T[None], w, b, stride=stride, padding=pad)[0].T


def _snake(x, alpha):
    return x + torch.sin(x * alpha) ** 2 / (alpha + 1e-9)


def f0_predict(p: dict, mel: torch.Tensor) -> torch.Tensor:
    """mel [T, 80] -> f0 [T], non-negative."""
    h = mel
    for i in range(5):
        h = F.elu(_conv1d(h, p[f"f0_conv{i}_w"], p[f"f0_conv{i}_b"], pad=1))
    return torch.abs(F.linear(h, p["f0_lin_w"], p["f0_lin_b"])[:, 0])


def sine_source(p: dict, f0: torch.Tensor) -> torch.Tensor:
    """f0 [Tm] -> the merged source [Tm * 480]."""
    tm = f0.shape[0]
    dev = f0.device
    harm = torch.arange(1, HARMONICS + 1, dtype=torch.float32, device=dev)
    rad = f0[:, None] * harm[None, :] / SR
    phase_frames = torch.cumsum(rad, dim=0) * 2.0 * float(np.pi)  # [Tm, 9]
    delta = torch.diff(phase_frames, dim=0, append=phase_frames[-1:] * 0)
    if tm > 1:
        delta = torch.cat([delta[:-1], delta[-2:-1]])
    ramp = torch.arange(SAMPLES_PER_MEL, dtype=torch.float32, device=dev) / SAMPLES_PER_MEL
    phase_up = phase_frames[:, None, :] + delta[:, None, :] * ramp[None, :, None]
    phase_up = phase_up.reshape(tm * SAMPLES_PER_MEL, HARMONICS) * SAMPLES_PER_MEL
    uv = (torch.repeat_interleave(f0, SAMPLES_PER_MEL) > VOICED_THRESHOLD).to(torch.float32)
    sines = torch.sin(phase_up) * SINE_AMP * uv[:, None]
    return torch.tanh(F.linear(sines, p["nsf_lin_w"], p["nsf_lin_b"])[:, 0])


def _hann(n, device):
    return 0.5 * (1.0 - torch.cos(2.0 * float(np.pi)
                                  * torch.arange(n, device=device) / n))


def _dft(device):
    """The cos and sin tables [F_BINS, N_FFT] of the 9-bin DFT."""
    n = torch.arange(N_FFT, dtype=torch.float32, device=device)
    k = torch.arange(F_BINS, dtype=torch.float32, device=device)
    ang = 2.0 * float(np.pi) / N_FFT * k[:, None] * n[None, :]
    return torch.cos(ang), torch.sin(ang)


def stft16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [T] -> (real [F, T / HOP], imag): centred Hann-16 frames,
    reflected at both ends, by the DFT as a matrix product."""
    pad = N_FFT // 2
    xp = torch.cat([x[1:pad + 1].flip(0), x, x[-pad - 1:-1].flip(0)])
    n_frames = x.shape[0] // HOP
    idx = (torch.arange(n_frames, device=x.device)[:, None] * HOP
           + torch.arange(N_FFT, device=x.device)[None, :])
    frames = xp[idx] * _hann(N_FFT, x.device)
    cos_t, sin_t = _dft(x.device)
    return (frames @ cos_t.T).T, (-(frames @ sin_t.T)).T


def istft16(real: torch.Tensor, imag: torch.Tensor) -> torch.Tensor:
    """real/imag [F, T'] -> wave [T' * HOP]: the inverse real DFT by matrix
    product (bins 0 and Nyquist once, the others twice), the window, and
    overlap-add normalised by the squared window."""
    t = real.shape[1]
    dev = real.device
    cos_t, sin_t = _dft(dev)
    w_k = torch.cat([torch.ones(1, device=dev), 2 * torch.ones(F_BINS - 2, device=dev),
                     torch.ones(1, device=dev)])
    win = _hann(N_FFT, dev)
    frames = (torch.einsum("ft,fn->tn", real * w_k[:, None], cos_t)
              - torch.einsum("ft,fn->tn", imag * w_k[:, None], sin_t)) / N_FFT
    frames = frames * win
    out_len = t * HOP + N_FFT
    idx = (torch.arange(t, device=dev)[:, None] * HOP
           + torch.arange(N_FFT, device=dev)[None, :]).reshape(-1)
    y = torch.zeros(out_len, device=dev).index_add_(0, idx, frames.reshape(-1))
    norm = torch.zeros(out_len, device=dev).index_add_(
        0, idx, (win * win).expand(t, N_FFT).reshape(-1))
    y = y / torch.clamp(norm, min=1e-8)
    pad = N_FFT // 2
    return y[pad:pad + t * HOP]


def _resblock(p: dict, idx: str, x: torch.Tensor) -> torch.Tensor:
    """HiFiGAN's resblock: convs1 dilated 1, 3, 5 by position (where k >
    1), convs2 undilated, snake before each."""
    for i, ((w1, b1), (w2, b2)) in enumerate(zip(p[f"rb{idx}_c1"], p[f"rb{idx}_c2"])):
        d1 = (1, 3, 5)[i] if w1.shape[-1] > 1 else 1
        xt = _snake(x, p[f"rb{idx}_a1"][i])
        xt = _conv1d(xt, w1, b1, pad=(w1.shape[-1] - 1) // 2 * d1, dilation=d1)
        xt = _snake(xt, p[f"rb{idx}_a2"][i])
        xt = _conv1d(xt, w2, b2, pad=(w2.shape[-1] - 1) // 2)
        x = x + xt
    return x


def decode(p: dict, mel: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """mel [T, 80] + source [T * 480] -> wave [T * 480]."""
    s_real, s_imag = stft16(source)
    s_stft = torch.cat([s_real, s_imag]).T  # [T * 120, 18]
    x = _conv1d(mel, p["conv_pre_w"], p["conv_pre_b"], pad=3)
    for stage, (stride, dpad, s_stride, s_pad) in enumerate(
            [(8, 4, 15, 7), (5, 3, 3, 1), (3, 2, 1, 0)]):
        x = torch.where(x >= 0, x, LRELU * x)
        x = _deconv1d(x, p[f"up{stage}_w"], p[f"up{stage}_b"], stride, dpad)
        si = _conv1d(s_stft, p[f"sd{stage}_w"], p[f"sd{stage}_b"],
                     stride=s_stride, pad=s_pad)
        x = x + _resblock(p, f"s{stage}", si)
        acc = _resblock(p, f"{stage * 3}", x)
        for j in (1, 2):
            acc = acc + _resblock(p, f"{stage * 3 + j}", x)
        x = acc / 3.0
    x = torch.where(x >= 0, x, 0.01 * x)
    post = _conv1d(x, p["conv_post_w"], p["conv_post_b"], pad=3)  # [Ts, 18]
    mag = torch.clamp(torch.exp(post[:, :F_BINS]), max=1e2)
    phase = torch.sin(post[:, F_BINS:])
    wave = istft16((mag * torch.cos(phase)).T, (mag * torch.sin(phase)).T)
    return torch.clamp(wave, -AUDIO_LIMIT, AUDIO_LIMIT)


def vocode(p: dict, mel: torch.Tensor, cached_source: torch.Tensor | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole vocoder: mel [T, 80] -> (wave [T * 480], source). The
    cached source, where given, replaces the start of the new one."""
    src = sine_source(p, f0_predict(p, mel))
    if cached_source is not None:
        src = torch.cat([cached_source.to(src.dtype), src[cached_source.shape[0]:]])
    return decode(p, mel, src), src


def load_hifigan_params(reader, device=None) -> dict:
    """The hifigan2 GGUF -> f32 params (either naming of the F0 predictor
    and the source's linear)."""
    get = f32_getter(reader, resolve_device(device))
    names = set(reader.tensors)

    def find(*cands):
        for c in cands:
            if c in names:
                return get(c)
        raise KeyError(f"hifigan tensor missing: {cands}")

    p = {
        "conv_pre_w": find("conv_pre.weight"), "conv_pre_b": find("conv_pre.bias"),
        "conv_post_w": find("conv_post.weight"), "conv_post_b": find("conv_post.bias"),
        "f0_lin_w": find("f0_predictor.proj.weight", "f0_predictor.linear.weight"),
        "f0_lin_b": find("f0_predictor.proj.bias", "f0_predictor.linear.bias"),
        "nsf_lin_w": find("m_source.l_linear.weight", "source_nsf.linear.weight"),
        "nsf_lin_b": find("m_source.l_linear.bias", "source_nsf.linear.bias"),
    }
    for i in range(5):
        p[f"f0_conv{i}_w"] = find(f"f0_predictor.condnet.{i * 2}.weight",
                                  f"f0_predictor.conv{i}.weight")
        p[f"f0_conv{i}_b"] = find(f"f0_predictor.condnet.{i * 2}.bias",
                                  f"f0_predictor.conv{i}.bias")
    for s in range(3):
        for key, name in (("up", "ups"), ("sd", "source_downs")):
            p[f"{key}{s}_w"] = find(f"{name}.{s}.weight")
            p[f"{key}{s}_b"] = find(f"{name}.{s}.bias")
        _load_resblock(p, f"s{s}", f"source_resblocks.{s}", get, names)
    for r in range(9):
        _load_resblock(p, f"{r}", f"resblocks.{r}", get, names)
    return p


def _load_resblock(p, key, prefix, get, names):
    c1, c2, a1, a2 = [], [], [], []
    i = 0
    while f"{prefix}.convs1.{i}.weight" in names:
        c1.append((get(f"{prefix}.convs1.{i}.weight"), get(f"{prefix}.convs1.{i}.bias")))
        c2.append((get(f"{prefix}.convs2.{i}.weight"), get(f"{prefix}.convs2.{i}.bias")))
        for lst, n, alt in ((a1, "activations1", 2 * i), (a2, "activations2", 2 * i + 1)):
            name = f"{prefix}.{n}.{i}.alpha"
            lst.append(get(name if name in names
                           else f"{prefix}.activations.{alt}.alpha").reshape(-1))
        i += 1
    p[f"rb{key}_c1"], p[f"rb{key}_c2"] = c1, c2
    p[f"rb{key}_a1"], p[f"rb{key}_a2"] = a1, a2
