"""Token2Wav's prompt cache: reference-voice priming from the reference's
prompt_cache.gguf v2 (counterpart of
omni_tpu/models/token2wav/prompt_cache.py; the layouts are described
there, after token2wav-impl.{h,cpp}).

- prompt_cache.spk_cb: the speaker x-vector [B, 192];
- prompt_cache.conformer_att_cache: [L, B, H, T, 2 Dh] (k | v), the 6
  stage-1 layers then the 4 up-rate ones; stage-1 layers hold their
  history in the first T / 2 rows;
- prompt_cache.conformer_cnn_cache: [B, C, Tc], the pre-lookahead tail (2)
  then the upsampling conv's;
- prompt_cache.estimator_att_cache: [2B, steps * depth * H, Tc, 2 Dh];
- prompt_cache.estimator_cnn_cache: [2B, steps * depth, k - 1, 2 hidden].

A file without the cache tensors primes by replaying its prompt tokens
(`Token2Wav.prime_with_prompt`); one with neither is refused.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import conformer as conf
from . import dit as ditm


class PromptCacheError(ValueError):
    """A prompt_cache.gguf with neither cache tensors nor prompt tokens, or
    one whose layout does not fit the model."""


def has_cache_tensors(reader) -> bool:
    return "prompt_cache.conformer_att_cache" in reader.tensors


def _get(reader, name):
    from ...core import quants

    ti = reader.tensors[name]
    return np.asarray(quants.dequantize(ti.data, ti.ggml_type, ti.shape), np.float32)


def import_states(reader, enc_cfg: conf.ConformerConfig, dit_cfg: ditm.DiTConfig,
                  n_timesteps: int, device=None
                  ) -> tuple[np.ndarray, conf.ConformerState, ditm.CFMState]:
    """The packed caches -> (spk [192], ConformerState, CFMState). A history
    longer than a state holds keeps its most recent rows."""
    kv_steps = reader.kv.get("mtmd.prompt_cache.n_timesteps")
    if kv_steps is not None and int(kv_steps) != n_timesteps:
        raise PromptCacheError(
            f"prompt cache was exported with n_timesteps={int(kv_steps)}, "
            f"session uses {n_timesteps}")
    spk = _get(reader, "prompt_cache.spk_cb").reshape(-1, 192)[0]

    att = _get(reader, "prompt_cache.conformer_att_cache")
    att = att.reshape(-1, enc_cfg.n_heads, att.shape[-2], att.shape[-1])
    n_l1, n_l2 = enc_cfg.n_blocks, enc_cfg.n_up_blocks
    if att.shape[0] != n_l1 + n_l2:
        raise PromptCacheError(f"conformer att cache has {att.shape[0]} layers, "
                               f"model has {n_l1}+{n_l2}")
    dh = enc_cfg.head_dim
    t2 = att.shape[2]
    t1 = t2 // 2
    state = conf.ConformerState.create(enc_cfg, device)
    n1, n2 = min(t1, state.k1.shape[1]), min(t2, state.k2.shape[1])

    def kv_split(a, t_keep):  # [H, T, 2D] -> (k, v) [T, H, D], the last t_keep
        a = np.transpose(a[:, -t_keep:] if t_keep else a[:, :0], (1, 0, 2))
        return torch.from_numpy(a[..., :dh].copy()), torch.from_numpy(a[..., dh:].copy())

    for li in range(n_l1):
        state.k1[li, :n1], state.v1[li, :n1] = kv_split(att[li][:, :t1], n1)
    for lj in range(n_l2):
        state.k2[lj, :n2], state.v2[lj, :n2] = kv_split(att[n_l1 + lj], n2)
    cnn = _get(reader, "prompt_cache.conformer_cnn_cache")
    cnn = cnn.reshape(-1, cnn.shape[-1])  # [C, Tc]
    state.prelook_tail.copy_(torch.from_numpy(cnn[:, :2].T.copy()))
    up_src = cnn[:, 2:].T
    n_up = min(len(up_src), state.up_tail.shape[0])
    if n_up:
        state.up_tail[-n_up:] = torch.from_numpy(up_src[-n_up:].copy())
    state = dataclasses.replace(state, n1=n1, n2=n2)

    eatt = _get(reader, "prompt_cache.estimator_att_cache")
    steps, depth, h, dhd = n_timesteps, dit_cfg.depth, dit_cfg.num_heads, dit_cfg.head_dim
    tc = eatt.shape[-2]
    eatt = eatt.reshape(2, steps, depth, h, tc, 2 * dhd)
    cfm = ditm.CFMState.create(dit_cfg, n_timesteps, device)
    tkeep = min(tc, cfm.k.shape[3])
    # [2B, s, d, H, T, 2D] -> [s, d, 2, T, H, D]
    for cache, part in ((cfm.k, eatt[..., -tkeep:, :dhd]), (cfm.v, eatt[..., -tkeep:, dhd:])):
        cache[:, :, :, :tkeep] = torch.from_numpy(
            np.transpose(part, (1, 2, 0, 4, 3, 5)).copy()).to(cache.dtype)
    ecnn = _get(reader, "prompt_cache.estimator_cnn_cache")
    pad = ecnn.shape[-2]
    if pad != dit_cfg.conv_kernel - 1:
        raise PromptCacheError(f"estimator cnn cache pad {pad} != conv_kernel-1 "
                               f"({dit_cfg.conv_kernel - 1})")
    ecnn = ecnn.reshape(2, steps, depth, pad, 2 * dit_cfg.hidden)
    for cache, part in ((cfm.conv1, ecnn[..., :dit_cfg.hidden]),
                        (cfm.conv2, ecnn[..., dit_cfg.hidden:])):
        cache.copy_(torch.from_numpy(np.transpose(part, (1, 2, 0, 3, 4)).copy()))
    cfm.n = tkeep
    return spk, state, cfm
