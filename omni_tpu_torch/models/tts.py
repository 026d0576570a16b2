"""TTS: the streaming speech-code decoder of MiniCPM-o 4.5's voice
(counterpart of omni_tpu/models/tts.py).

A 20-layer d 768 LLaMA decoder (`qwen3.forward` with NORM rotary, no q/k
norm) and side weights read raw from the TTS GGUF:
- emb_text [152064, 768], indexed by the LLM's token ids;
- emb_code [6562, 768], the audio codes fed back as inputs;
- head_code [6562, 768], the output head over the audio codes;
- projector_semantic, a ReLU MLP 4096 -> 768 -> 768 over the LLM's hidden
  taps, and projector_spk, the same shape, for the speaker embedding.

Each chunk of LLM text is one condition: emb_text(token) +
projector_semantic(hidden) per token, the text_eos embedding at the end
of the turn, then emb_code(audio_bos = 0); chunk 0 starts with the
speaker embedding. Audio ids are relative, 0..6561, with audio_eos 6561.

Sampling (sample_tts_token): temperature 0.8, a repetition penalty 1.05
over the last 16 codes (skipped on a generation's first code), top-k 25,
top-p 0.85 keeping at least 3, then a categorical draw. The draws are
Gumbel-max over noise from a `torch.Generator` on the device, or noise
passed in (`gumbel=`), which is how the tests feed JAX's own draws.

`tts_decode_scan` generates up to n_steps codes with nothing read back by
the host inside it: the JAX package's `lax.scan` as a Python loop over
`qwen3.forward`, its done flag, penalty ring and position on the device.
The caller keeps the context's books (`n_past`, `cells_used`), as the
JAX pipeline does after each scan.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..core import quants
from ..kernels.dequant_matmul import matmul
from ..kernels.qformats import load_quantized
from ..runtime.sampler import gumbel_noise
from . import qwen3

NUM_AUDIO_TOKENS = 6562
AUDIO_EOS_REL = NUM_AUDIO_TOKENS - 1  # 6561
AUDIO_BOS_ABS = 151687  # omni.cpp:2696
TEXT_EOS_ID = 151692
SPK_EMB_ID = 21143


@dataclasses.dataclass(frozen=True)
class TTSSamplingParams:
    """TTSSamplingParams of modeling_minicpmo.py (omni.cpp:3617-3625)."""

    temperature: float = 0.8
    top_p: float = 0.85
    top_k: int = 25
    repetition_penalty: float = 1.05
    win_size: int = 16
    tau_r: float = 0.1
    min_tokens_to_keep: int = 3


def config_from_gguf(kv: dict[str, Any]) -> qwen3.Qwen3Config:
    """The decoder's config: LLaMA arch, NORM rotary, the audio codes as
    its vocabulary (its logits come from head_code)."""
    arch = kv.get("general.architecture", "minicpmtts")

    def g(key, default):
        return kv.get(f"{arch}.{key}", default)

    n_heads = int(g("attention.head_count", 12))
    d = int(g("embedding_length", 768))
    return qwen3.Qwen3Config(
        n_layers=int(g("block_count", 20)), d_model=d, n_heads=n_heads,
        n_kv_heads=int(g("attention.head_count_kv", n_heads)),
        head_dim=d // n_heads, d_ff=int(g("feed_forward_length", 3072)),
        n_vocab=NUM_AUDIO_TOKENS,
        rope_base=float(g("rope.freq_base", 10000.0)),
        rms_eps=float(g("attention.layer_norm_rms_epsilon", 1e-6)),
        rope_neox=False)


def _f32(reader, *names, required=True, device=None):
    for name in names:
        if name in reader.tensors:
            ti = reader.tensors[name]
            a = quants.dequantize(ti.data, ti.ggml_type, ti.shape)
            return torch.from_numpy(np.array(a, np.float32)).to(device)
    if required:
        raise KeyError(f"TTS tensor missing: {names}")
    return None


def load_params(reader, device=None) -> tuple[dict, dict]:
    """(decoder params in the qwen3 layout, extras) from either naming:
    llama.cpp's blk.N.* (read as `qwen3.load_params` reads them: F16/F32
    weights dense bf16, norms f32, the token embedding dense) or the
    converter's tts.layers.N.* (convert_tts.py; weights f32, headless).
    The extras are f32, with head_code and emb_code also in bf16 for the
    scan (`head_code_bf16`, `emb_code_bf16`)."""
    device = resolve_device(device)
    if "blk.0.attn_norm.weight" in reader.tensors:
        arch = reader.kv.get("general.architecture", "minicpmtts")
        n_layers = int(reader.kv[f"{arch}.block_count"])

        def get(name, keep_q=True, required=True):
            ti = reader.tensors.get(name)
            if ti is None:
                if required:
                    raise KeyError(f"missing tensor {name}")
                return None
            return load_quantized(ti.data, ti.ggml_type, ti.shape, keep_q, device)

        params = {"token_embd": get("token_embd.weight", keep_q=False),
                  "output_norm": get("output_norm.weight"),
                  "output": get("output.weight", required=False), "layers": []}
        for i in range(n_layers):
            params["layers"].append({
                nm: get(f"blk.{i}.{gg}.weight", required=nm not in qwen3._OPTIONAL)
                for gg, nm in qwen3._LAYER_TENSORS.items()})
    else:
        params = {"layers": [], "token_embd": None, "output": None,
                  "output_norm": _f32(reader, "tts.norm.weight", "norm.weight",
                                      device=device)}
        i = 0
        while (f"tts.layers.{i}.input_layernorm.weight" in reader.tensors
               or f"layers.{i}.input_layernorm.weight" in reader.tensors):
            pre = (f"tts.layers.{i}.", f"layers.{i}.")

            def g(suffix):
                return _f32(reader, pre[0] + suffix, pre[1] + suffix, device=device)

            params["layers"].append({
                "attn_norm": g("input_layernorm.weight"),
                "wq": g("self_attn.q_proj.weight"),
                "wk": g("self_attn.k_proj.weight"),
                "wv": g("self_attn.v_proj.weight"),
                "wo": g("self_attn.o_proj.weight"),
                "q_norm": None, "k_norm": None,
                "ffn_norm": g("post_attention_layernorm.weight"),
                "w_gate": g("mlp.gate_proj.weight"),
                "w_up": g("mlp.up_proj.weight"),
                "w_down": g("mlp.down_proj.weight"),
            })
            i += 1

    def x(name, required=True):
        return _f32(reader, name, "tts." + name, required=required, device=device)

    extras = {
        "emb_text": x("emb_text.weight"), "emb_code": x("emb_code.0.weight"),
        "head_code": x("head_code.0.weight"),
        "proj_sem_w1": x("projector_semantic.linear1.weight"),
        "proj_sem_b1": x("projector_semantic.linear1.bias"),
        "proj_sem_w2": x("projector_semantic.linear2.weight"),
        "proj_sem_b2": x("projector_semantic.linear2.bias"),
        **{f"proj_spk_{k}": x(f"projector_spk.linear{k[1]}.{w}", required=False)
           for k, w in (("w1", "weight"), ("b1", "bias"), ("w2", "weight"),
                        ("b2", "bias"))},
    }
    return params, with_bf16(extras)


def with_bf16(extras: dict) -> dict:
    """The extras with head_code and emb_code also in bf16, as the scan
    reads them (audio_logits' bf16 dot, the bf16 code embeddings)."""
    return {**extras, "head_code_bf16": extras["head_code"].to(torch.bfloat16),
            "emb_code_bf16": extras["emb_code"].to(torch.bfloat16)}


# ---------------------------------------------------------------------------
# conditioning and heads
# ---------------------------------------------------------------------------

def _mlp(extras: dict, pre: str, hidden: torch.Tensor) -> torch.Tensor:
    h = torch.relu(F.linear(hidden.to(torch.float32), extras[pre + "w1"],
                            extras[pre + "b1"]))
    return F.linear(h, extras[pre + "w2"], extras[pre + "b2"])


def projector_semantic(extras: dict, hidden: torch.Tensor) -> torch.Tensor:
    """LLM hidden [T, 4096] -> the TTS embedding space [T, 768]."""
    return _mlp(extras, "proj_sem_", hidden)


def projector_spk(extras: dict, hidden: torch.Tensor) -> torch.Tensor:
    """The speaker projector (projector_semantic's shape)."""
    return _mlp(extras, "proj_spk_", hidden)


def speaker_embed(extras: dict, ref_hidden=None) -> torch.Tensor:
    """The speaker embedding prepended at TTS chunk 0 [768]: projector_spk
    over the mean of the reference audio span's LLM hidden states, or the
    default voice, emb_text[21143]."""
    if ref_hidden is not None and extras.get("proj_spk_w1") is not None:
        ref = torch.as_tensor(ref_hidden, device=extras["emb_text"].device)
        pooled = ref.to(torch.float32).mean(dim=0, keepdim=True)
        return projector_spk(extras, pooled)[0]
    return extras["emb_text"][_row(extras["emb_text"], SPK_EMB_ID)]


def _row(table: torch.Tensor, i: int) -> int:
    """Row i, clamped to the table as a JAX gather clamps it (only a test
    file's small emb_text has fewer rows than the ids)."""
    return min(i, table.shape[0] - 1)


def build_condition(extras: dict, llm_tokens: torch.Tensor,
                    llm_hidden: torch.Tensor, end_of_turn: bool = False,
                    spk_embed: torch.Tensor | None = None) -> torch.Tensor:
    """One chunk's condition (omni.cpp:5812-5847): [spk_embed at chunk 0]
    + emb_text + projector_semantic(hidden) per token, + the text_eos
    embedding at the end of the turn, + the audio_bos code embedding."""
    et = extras["emb_text"]
    toks = torch.as_tensor(llm_tokens, dtype=torch.int64, device=et.device)
    hid = torch.as_tensor(llm_hidden, dtype=torch.float32, device=et.device)
    parts = [] if spk_embed is None else [spk_embed.to(et.device)[None]]
    parts.append(et[toks] + projector_semantic(extras, hid))
    if end_of_turn:
        r = _row(et, TEXT_EOS_ID)
        parts.append(et[r:r + 1])
    parts.append(extras["emb_code"][0:1])  # audio_bos = code 0
    return torch.cat(parts, dim=0)


def audio_logits(extras: dict, hidden: torch.Tensor) -> torch.Tensor:
    """TTS hidden [T, 768] (or [768]) -> f32 logits over the 6,562 codes:
    the bf16 dot of the JAX package, through the port's dense dot."""
    h2 = hidden[None] if hidden.ndim == 1 else hidden
    out = matmul(h2.to(torch.bfloat16), extras["head_code_bf16"],
                 out_dtype=torch.float32)
    return out[0] if hidden.ndim == 1 else out


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def apply_repetition_penalty(logits: torch.Tensor, prev_rel: torch.Tensor,
                             penalty: float, window: int) -> torch.Tensor:
    """alpha = penalty ** (count in the last `window` codes); positive
    logits divided by it, negative ones multiplied (omni.cpp:2368).
    prev_rel is a ring of relative ids, -1 padded."""
    w = prev_rel[-window:] if prev_rel.shape[0] > window else prev_rel
    n = logits.shape[-1]
    idx = torch.where(w >= 0, w, torch.full_like(w, n)).to(torch.int64)
    freq = torch.zeros(n + 1, dtype=logits.dtype, device=logits.device)
    freq.index_add_(0, idx, torch.ones_like(idx, dtype=logits.dtype))
    alpha = torch.pow(penalty, freq[:n])
    return torch.where(logits < 0, logits * alpha, logits / alpha)


def nucleus_support(logits: torch.Tensor, top_p: float, top_k: int,
                    min_keep: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The filtered candidates: with top-k, (the k largest logits sorted
    down, -inf past the top-p rank, their ids); without, (the whole row,
    -inf below the top-p threshold, None). Top-p runs over the k
    candidates renormalised, as the reference's TopK then TopP warpers."""
    n = logits.shape[-1]
    if 0 < top_k < n:
        k = max(top_k, min_keep)
        topv, topi = torch.topk(logits, k)  # sorted, largest first
        if top_p < 1.0:
            probs = torch.softmax(topv, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            keep = torch.clamp((cum - probs < top_p).sum(), min=min_keep)
            rank = torch.arange(k, device=logits.device)
            topv = topv.masked_fill(rank >= keep, float("-inf"))
        return topv, topi
    v = logits
    if top_p < 1.0:
        sorted_v = torch.sort(v, descending=True).values
        probs = torch.softmax(sorted_v, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = torch.clamp((cum - probs < top_p).sum(), min=min_keep)
        thresh = sorted_v.gather(0, (keep - 1).reshape(1))
        v = v.masked_fill(v < thresh, float("-inf"))
    return v, None


def _categorical(v: torch.Tensor, gumbel: torch.Tensor | None,
                 generator: torch.Generator | None) -> torch.Tensor:
    """argmax(v + Gumbel noise): jax.random.categorical's law. A 1-element
    int64 tensor (no 0-d index: that would read it on the host)."""
    if gumbel is None:
        gumbel = gumbel_noise(v.shape[-1], generator, v.device)
    return torch.argmax(v + gumbel).reshape(1)


def nucleus_sample(logits: torch.Tensor, top_p: float, top_k: int,
                   min_keep: int, generator: torch.Generator | None = None,
                   gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """Top-k and top-p with min_tokens_to_keep, then a categorical draw
    (nucleus_sampling_with_min_keep_tts, omni.cpp:2410). Returns a 0-d
    int64 tensor; `gumbel` is [k] with top-k, else [vocab]."""
    v, ids = nucleus_support(logits, top_p, top_k, min_keep)
    choice = _categorical(v, gumbel, generator)
    return (ids.gather(0, choice) if ids is not None else choice)[0]


def sample_audio_token(logits: torch.Tensor, prev_rel: torch.Tensor,
                       sp: TTSSamplingParams = TTSSamplingParams(),
                       skip_processors: bool = False,
                       force_no_eos: bool = False,
                       generator: torch.Generator | None = None,
                       gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """One audio code (a relative id, 0-d int64), sample_tts_token's law:
    temperature, the repetition penalty unless skip_processors, audio_eos
    masked if force_no_eos, then `nucleus_sample`."""
    v = logits / sp.temperature
    if not skip_processors:
        v = apply_repetition_penalty(v, prev_rel, sp.repetition_penalty,
                                     sp.win_size)
    if force_no_eos:  # by position, as JAX's mask (a test head may be short)
        ids = torch.arange(v.shape[-1], device=v.device)
        v = v.masked_fill(ids == AUDIO_EOS_REL, float("-inf"))
    return nucleus_sample(v, sp.top_p, sp.top_k, sp.min_tokens_to_keep,
                          generator, gumbel)


def ras_sample(logits: torch.Tensor, prev_rel: torch.Tensor,
               sp: TTSSamplingParams = TTSSamplingParams(),
               generator: torch.Generator | None = None,
               gumbel: tuple[torch.Tensor, torch.Tensor] | None = None
               ) -> torch.Tensor:
    """Repetition-aware sampling (omni.cpp:2330): a nucleus draw; if that
    code comes up win_size * tau_r times or more in the last 10, a plain
    categorical draw over the whole row instead. `gumbel`: the two draws'
    noise, ([k], [vocab])."""
    g1, g2 = gumbel if gumbel is not None else (None, None)
    cand = nucleus_sample(logits, sp.top_p, sp.top_k, 1, generator, g1)
    rep = (prev_rel[-10:] == cand).sum()
    fallback = _categorical(logits, g2, generator)[0]
    return torch.where(rep >= int(sp.win_size * sp.tau_r), fallback, cand)


# ---------------------------------------------------------------------------
# audio-code generation, sync-free
# ---------------------------------------------------------------------------

def tts_decode_scan(params: dict, cfg: qwen3.Qwen3Config, extras: dict, cache,
                    first_hidden: torch.Tensor, start_pos: torch.Tensor,
                    n_steps: int, sp: TTSSamplingParams = TTSSamplingParams(),
                    first_chunk: bool = False, force_no_eos: bool = False,
                    prev0: torch.Tensor | None = None,
                    done_in: torch.Tensor | None = None,
                    generator: torch.Generator | None = None,
                    gumbels: torch.Tensor | None = None):
    """Up to n_steps audio codes: head_code logits, the sampler with its
    repetition ring, the code's embedding, one decoder step. A sampled
    audio_eos freezes the state (its step and every later one write
    nothing and emit -1). `done_in` chains a prior scan's frozen flag, so
    a scan issued before its predecessor's codes are read is a no-op once
    the generation ended. `gumbels` ([n_steps, top_k]) is the draws' noise
    in place of the generator's (the tests feed JAX's).

    Returns (codes [n_steps] int64, rel ids or -1; the cache, updated in
    place; the last hidden [768] bf16; the ring [win_size]; the next
    position []; done []), all on the device: nothing here reads a value
    back to the host."""
    dev = first_hidden.device
    if prev0 is None:
        prev0 = torch.full((sp.win_size,), -1, dtype=torch.int64, device=dev)
    done = (torch.zeros((), dtype=torch.bool, device=dev) if done_in is None
            else done_in)
    all_slots = cache.find_slots(n_steps)  # one call: nothing frees cells
    seq0 = torch.zeros((1,), dtype=torch.int64, device=dev)
    emb_code = extras["emb_code_bf16"]
    h = first_hidden.to(torch.bfloat16).reshape(1, -1)
    pos = torch.as_tensor(start_pos, dtype=torch.int64, device=dev).reshape(())
    prev = prev0
    codes = []
    for i in range(n_steps):
        rel = sample_audio_token(
            audio_logits(extras, h)[0], prev, sp,
            skip_processors=(i == 0 and first_chunk), force_no_eos=force_no_eos,
            generator=generator, gumbel=None if gumbels is None else gumbels[i])
        done_next = done | (rel == AUDIO_EOS_REL)
        codes.append(torch.where(done_next, -1, rel))
        emb = emb_code.index_select(0, torch.clamp(rel, min=0).reshape(1))
        _, hidden, cache = qwen3.forward(
            params, cfg, emb, pos.reshape(1), seq0, cache, all_slots[i:i + 1],
            write_mask=(~done_next).reshape(1))
        h = torch.where(done_next, h, hidden.to(torch.bfloat16))
        prev = torch.where(done_next, prev, torch.cat([prev[1:], rel.reshape(1)]))
        pos = pos + (~done_next).to(pos.dtype)
        done = done_next
    return torch.stack(codes), cache, h[0], prev, pos, done
