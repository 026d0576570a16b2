"""Token2Wav: streaming audio codes -> mel -> 24 kHz waveform
(counterpart of omni_tpu/models/token2wav/; the reference's
Token2WavSession, token2wav.cpp and token2wav-impl.cpp).

`feed_window(tokens[<= 28], is_final)` pads the window to 28 with token
4218 and runs one chunk: the token embedding, the upsampling conformer,
encoder_proj (mu), the 5-step CFM solve with guidance (56 mel frames, 2 a
token), then the vocoder over [the 8-frame mel cache | the new mel] with
the cached source, and a Hamming crossfade of the first 3,840 samples
with the previous window's tail. 25 main codes are 1 s of 24 kHz audio.
The speaker: the L2-normalised 192-d x-vector through the affine layer ->
80 channels, read with the priming caches from prompt_cache.gguf.

Every tensor stays on the session's device; `feed_window` reads the
window's wave back to the host once.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ... import resolve_device
from . import conformer as conf
from . import dit as ditm
from . import hifigan as hg

PAD_TOKEN = 4218
CHUNK_MAIN = 25
PRE_LOOKAHEAD = 3
DT = CHUNK_MAIN + PRE_LOOKAHEAD
MEL_CHANNELS = 80
SPK_DIM = 192


class Token2Wav:
    """A streaming token -> wav session (flow::Token2WavSession)."""

    def __init__(self, encoder_params, encoder_cfg, flow_extra, dit_params,
                 dit_cfg, voc_params, spk: np.ndarray, n_timesteps: int = 5,
                 temperature: float = 1.0, device=None):
        self.device = resolve_device(device)
        self.enc_p, self.enc_cfg = encoder_params, encoder_cfg
        self.extra = flow_extra  # input_embedding, spk_affine, encoder_proj
        self.dit_p, self.dit_cfg = dit_params, dit_cfg
        self.voc_p = voc_params
        self.n_timesteps = n_timesteps
        self.temperature = temperature
        self.set_spk(np.asarray(spk, np.float32).reshape(-1)[:SPK_DIM])
        self.reset()

    def set_spk(self, spk: np.ndarray) -> None:
        """The speaker x-vector and its normalised 80-d conditioning row."""
        self.spk = np.asarray(spk, np.float32)
        spk_n = self.spk / (np.linalg.norm(self.spk) + 1e-12)
        row = (spk_n @ self.extra["spk_affine_w"].cpu().numpy().T
               + self.extra["spk_affine_b"].cpu().numpy())
        self.spk80 = torch.from_numpy(np.asarray(row, np.float32)).to(self.device)

    def reset(self) -> None:
        """Fresh streaming state: the conformer's and the CFM's caches, the
        CFM's noise table, and the empty mel, source and speech tails."""
        self.enc_state = conf.ConformerState.create(self.enc_cfg, self.device)
        self.cfm_state = ditm.CFMState.create(self.dit_cfg, self.n_timesteps,
                                              self.device)
        self._clear_tails()

    def _clear_tails(self) -> None:
        self.mel_cache = torch.zeros((0, self.dit_cfg.out_channels), device=self.device)
        self.source_cache = None
        self.speech_cache = np.zeros((0,), np.float32)

    @classmethod
    def from_gguf(cls, encoder_gguf: str, flow_matching_gguf: str,
                  flow_extra_gguf: str, vocoder_gguf: str,
                  prompt_cache_gguf: str | None = None,
                  spk: np.ndarray | None = None, n_timesteps: int = 5,
                  temperature: float = 1.0, device=None) -> "Token2Wav":
        """The four GGUFs, and the voice: the prompt cache's packed caches
        imported, else its prompt tokens replayed; one with neither raises
        PromptCacheError."""
        from ...core.gguf import GGUFReader
        from . import prompt_cache as pc_mod

        device = resolve_device(device)
        enc_p, enc_cfg = conf.load_conformer_params(GGUFReader(encoder_gguf), device)
        dit_p, dit_cfg = ditm.load_dit_params(GGUFReader(flow_matching_gguf), device)
        get = conf.f32_getter(GGUFReader(flow_extra_gguf), device)
        extra = {"input_embedding": get("input_embedding.weight"),
                 "spk_affine_w": get("spk_embed_affine_layer.weight"),
                 "spk_affine_b": get("spk_embed_affine_layer.bias"),
                 "encoder_proj_w": get("encoder_proj.weight"),
                 "encoder_proj_b": get("encoder_proj.bias")}
        voc_p = hg.load_hifigan_params(GGUFReader(vocoder_gguf), device)
        pc = GGUFReader(prompt_cache_gguf) if prompt_cache_gguf else None
        spk_given = spk is not None
        if spk is None and pc is not None and "prompt_cache.spk_cb" in pc.tensors:
            spk, spk_given = pc_mod._get(pc, "prompt_cache.spk_cb"), True
        if spk is None:
            spk = np.zeros(SPK_DIM, np.float32)
        t2w = cls(enc_p, enc_cfg, extra, dit_p, dit_cfg, voc_p, spk, n_timesteps,
                  temperature, device)
        if pc is None:
            return t2w
        if pc_mod.has_cache_tensors(pc):
            spk_i, t2w.enc_state, t2w.cfm_state = pc_mod.import_states(
                pc, enc_cfg, dit_cfg, n_timesteps, device)
            if not spk_given:
                t2w.set_spk(spk_i)
            return t2w
        for name in ("prompt_cache.prompt_tokens", "prompt_tokens"):
            if name in pc.tensors:
                t2w.prime_with_prompt(np.asarray(pc.tensors[name].data).reshape(-1))
                return t2w
        raise pc_mod.PromptCacheError(
            f"{prompt_cache_gguf} carries neither packed cache tensors nor "
            "prompt tokens: cannot prime the reference voice")

    def prime_with_prompt(self, prompt_tokens) -> None:
        """Warm the conformer's and the CFM's caches with the reference
        voice's prompt tokens, window by window; their audio is dropped."""
        toks = np.asarray(prompt_tokens, np.int64).reshape(-1)
        for i in range(0, len(toks), CHUNK_MAIN):
            chunk = np.full(DT, PAD_TOKEN, np.int64)
            win = toks[i:i + DT]
            chunk[:len(win)] = win
            self._token2mel(chunk, last=False)
        self._clear_tails()

    def _token2mel(self, tokens: np.ndarray, last: bool) -> torch.Tensor:
        """A token window -> mel [2 T', 80] on the device: the embedding,
        the conformer chunk, encoder_proj and the CFM solve."""
        ids = torch.from_numpy(np.asarray(tokens, np.int64)).to(self.device)
        emb = self.extra["input_embedding"][ids]
        feats, self.enc_state = conf.encode_chunk(self.enc_p, self.enc_cfg, emb,
                                                  self.enc_state, last_chunk=last)
        mu = F.linear(feats, self.extra["encoder_proj_w"], self.extra["encoder_proj_b"])
        mel, self.cfm_state = ditm.cfm_solve_chunk(
            self.dit_p, self.dit_cfg, mu, self.spk80, self.cfm_state,
            self.n_timesteps, self.temperature)
        return mel

    def feed_window(self, tokens, is_final: bool = False) -> np.ndarray:
        """Up to 28 codes (25 + 3 look-ahead) -> the 24 kHz wave, 1 s for a
        full window (Token2Wav::push_tokens_window with its caches and
        fade). The window is always padded to 28 codes; the wave is cut to
        the valid codes' samples after the vocoder."""
        tokens = np.asarray(tokens, np.int64)
        n = len(tokens)
        if not 0 <= n <= DT:
            raise ValueError(f"a window holds at most {DT} codes, got {n}")
        if n == 0:
            return np.zeros(0, np.float32)
        chunk = np.full(DT, PAD_TOKEN, np.int64)
        chunk[:n] = tokens
        mel = self._token2mel(chunk, is_final)
        n_valid_mel = self.mel_cache.shape[0] + n * 2
        mel_in = torch.cat([self.mel_cache, mel])
        wave_d, source_d = hg.vocode(self.voc_p, mel_in, self.source_cache)
        valid = n_valid_mel * hg.SAMPLES_PER_MEL
        wave = wave_d[:valid].cpu().numpy()  # the window's one read-back
        if len(self.speech_cache):
            wave = _fade_in_out(wave, self.speech_cache)
        self.mel_cache = mel_in[:n_valid_mel][-hg.MEL_CACHE:]
        self.source_cache = source_d[:valid][-hg.SOURCE_CACHE:]
        self.speech_cache = wave[-hg.SOURCE_CACHE:]
        return wave


def _fade_in_out(wave: np.ndarray, prev_tail: np.ndarray) -> np.ndarray:
    """Hamming crossfade over the overlap (token2wav_utils::fade_in_out)."""
    n = min(len(prev_tail), len(wave))
    if n == 0:
        return wave
    t = np.arange(2 * n, dtype=np.float32)
    window = 0.54 - 0.46 * np.cos(2 * np.pi * t / (2 * n - 1))
    out = wave.copy()
    out[:n] = wave[:n] * window[:n] + prev_tail[:n] * window[n:]
    return out
