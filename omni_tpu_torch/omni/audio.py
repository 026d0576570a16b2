"""Host-side audio preprocessing (counterpart of omni_tpu/omni/audio.py):
the Whisper log-mel spectrogram of a 16 kHz mono chunk, a WAV reader that
resamples to 16 kHz mono and a 16-bit WAV writer.

The spectrogram's law is the reference's (tools/mtmd/mtmd-audio.cpp
log_mel_spectrogram): periodic Hann window 400, hop 160, a reflected head
of 200 samples and a zero tail, the power spectrum, the APM file's mel
filterbank, log10 clamped at 1e-10, a floor 8 below the maximum, then
(x + 4) / 4. numpy on the host, as the reference runs it on CPU threads.
"""

from __future__ import annotations

import wave

import numpy as np

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160


def hann_window(n: int = N_FFT) -> np.ndarray:
    """Periodic Hann window (torch.hann_window(periodic=True))."""
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))).astype(np.float32)


def log_mel_spectrogram(samples: np.ndarray, mel_filters: np.ndarray,
                        n_frames: int | None = None) -> np.ndarray:
    """[n_samples] f32 -> [n_frames, n_mel] f32 normalised log-mel;
    `mel_filters` is [n_mel, N_FFT // 2 + 1]. n_frames defaults to
    round(n_samples / HOP), 100 a second."""
    samples = np.asarray(samples, np.float32)
    if n_frames is None:
        n_frames = int(round(len(samples) / HOP))
    pad = N_FFT // 2
    padded = np.concatenate([
        samples[1:pad + 1][::-1],  # reflected head
        samples,
        np.zeros(pad + N_FFT, np.float32),  # zero tail
    ])
    idx = np.arange(n_frames)[:, None] * HOP + np.arange(N_FFT)[None, :]
    spec = np.fft.rfft(padded[idx] * hann_window(), n=N_FFT, axis=-1)
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)  # [T, 201]
    log_spec = np.log10(np.maximum(power @ mel_filters.T, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


def load_wav_mono_16k(path: str) -> np.ndarray:
    """A PCM 8/16/32-bit WAV file as f32 mono at 16 kHz: channels averaged,
    other rates resampled by linear interpolation."""
    with wave.open(path, "rb") as w:
        raw = w.readframes(w.getnframes())
        ch, width, rate = w.getnchannels(), w.getsampwidth(), w.getframerate()
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    if rate != SAMPLE_RATE:
        t_out = np.arange(int(len(x) * SAMPLE_RATE / rate)) * (rate / SAMPLE_RATE)
        x = np.interp(t_out, np.arange(len(x)), x).astype(np.float32)
    return x


def write_wav(path: str, samples: np.ndarray, rate: int = 24000) -> None:
    """Mono 16-bit PCM, samples clipped to [-1, 1]."""
    x = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((x * 32767.0).astype(np.int16).tobytes())
