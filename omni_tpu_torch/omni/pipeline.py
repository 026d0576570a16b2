"""The omni session orchestrator (counterpart of omni_tpu/omni/pipeline.py):
an LLM `Context`, and for a spoken round the APM (an `audio_encoder`
callable), the VPM (a `vision_encoder` callable), the TTS `Context` with
its side weights and a `Token2Wav` session, joined by three worker threads
and bounded queues with the reference's cadence (omni.cpp:3713-3722): the
prefill queue (1000 chunks of audio and image embeddings), the TTS queue
(1 text chunk: the LLM never runs more than one chunk ahead of the TTS)
and the Token2Wav queue (25 codes).

A session starts with `stream_prefill(index=0, system_prompt=...)`, which
writes the system prompt (the reference voice's audio, where given,
conditions the LLM and sets the TTS speaker embedding); each later index
carries one second of the user's input: audio, an image or video frames,
encoded on the caller's thread and prefilled by the LLM worker in the
reference's marker layout (omni.cpp:4317-4383). A simplex chunk puts each
image as <image>overview</image>, then <slice>..</slice> per LLaVA-UHD
slice and a newline, and its audio between <|audio_start|> and
<|audio_end|>; a duplex chunk opens a <unit> (the first image's
<unit><image>) and puts its audio rows bare. A text turn's words go in
with `prefill_text`. Each response is one `stream_decode`: its text
arrives on `text_out` in chunks of STEP_SIZE tokens; with TTS on, each
chunk and its hidden taps go to the TTS worker, whose audio codes stream
25 at a time to the Token2Wav worker, whose waves arrive on `wav_out`
(and, with `output_dir`, as round_XXX/tts_wav/wav_N.wav and a
generation_done.flag at the end of the turn). The prompts are MiniCPM-o's
ChatML: simplex turns, or duplex units.

Duplex (`SessionConfig(duplex=True)`): a turn starts with <|speak|> and
ends on <|listen|>, <|turn_eos|> or </s>, with no simplex turn end after
it; every DUPLEX_CHUNK_CAP-th sampled token of a speak segment is
discarded (it never enters the KV) and <|chunk_eos|></unit> is written in
its place (`_force_chunk_end`); the TTS makes at most DUPLEX_CHUNK_CAP
codes a text chunk and no audio_eos before the turn's last. Every <unit>
span is registered (`units`); past `high_water` cells the oldest closed
units are evicted down to `low_water`, never the `n_keep` cells of the
system prompt, and the later cells shift down (`Context.seq_add` re-rotates
their K): the unit window (omni.cpp:3107-3405).

The decode loop is the JAX package's fused loop: STEP_SIZE-token chunks of
`omni_decode_scan`, the next issued before the current one's results are
read. The TTS generates in 25-code `tts_decode_scan`s the same way, each
read once. Mirostat, or `SessionConfig(fused_decode=False)`, take the host
loop, one decode and one sample per token.

The workers are threads on one card, and every context issues its work
on the device's one default stream, where it runs in the order issued:
the LLM's and the TTS's calls of kernel F (whose split-merge arrival
counters are one buffer per device) and of kernel I (one workspace per
device and size) never overlap. A second stream would need its own
counters and workspaces first. The workers also share one Python
interpreter, so a TTS scan issued while Token2Wav renders a window slows
both; the first chunk's second scan therefore waits until Token2Wav has
rendered the turn's first window (`_hold_for_token2wav`, on an event, not
a timeout), which brings the first wave forward. The JAX package's timed
waits (0.4 s there, 0.5 s in the LLM loop) are not copied.

Every finished simplex round is recorded (`rounds`); past
`max_preserved_context` the oldest whole rounds are evicted, never the
`n_keep` cells of the system prompt, and the later cells shift down.
`session_state_bytes` saves the LLM's KV pool, the round window and the
unit registry in the JAX package's layout.
"""

from __future__ import annotations

import dataclasses
import inspect
import io
import os
import pickle
import queue
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from ..models import tts as tts_mod
from ..runtime import Batch, Context, KVCacheFull
from ..runtime.loop import _scalar, omni_decode_scan
from .image import stack_frames

# queue capacities (omni.cpp:3713-3722)
PREFILL_QUEUE_CAP = 1000
TTS_QUEUE_CAP = 1
T2W_QUEUE_CAP = 25

STEP_SIZE = 10  # LLM tokens per chunk (omni.cpp:9120)
DUPLEX_CHUNK_CAP = 26  # sampled tokens a duplex speak segment (omni.h:233)
SIMPLEX_AUDIO_CAP = 500  # audio codes per text chunk (omni.cpp:4976)
T2W_MAIN = 25
T2W_LOOKAHEAD = 3
SILENCE_TOKEN = 4218

SPECIALS = [
    "<|speak|>", "<|listen|>", "<|chunk_eos|>", "<|chunk_tts_eos|>",
    "<|turn_eos|>", "<|tts_eos|>", "</s>", "<|tts_bos|>", "</unit>",
    "<unit>", "<|tts_pad|>", "<|im_end|>", "<|im_start|>",
    "<|audio_start|>", "<|audio_end|>", "<think>", "</think>",
    "<image>", "</image>", "<slice>", "</slice>",
]

SIMPLEX_ASSISTANT_PROMPT = (
    "<|im_end|>\n<|im_start|>assistant\n<think>\n\n</think>\n\n<|tts_bos|>"
)
SIMPLEX_TURN_END = "<|im_end|>\n<|im_start|>user\n"


@dataclasses.dataclass
class SessionConfig:
    """Session config, mutable at run time (update_session_config)."""

    duplex: bool = False
    use_tts: bool = False  # needs the TTS context and Token2Wav too
    media_type: int = 1  # 1 audio, 2 omni (audio and vision)
    max_slice_nums: int = -1  # the slice override (-1: the encoder's default)
    # high-res mode: max_slice_nums forced to 2 (omni.h:258-263); high
    # refresh: a second's frames after the first merge into one stacked image
    high_image: bool = False
    high_refresh: bool = False
    # the fused decode loop (STEP_SIZE-token chunks a host dispatch);
    # mirostat takes the host loop whatever this says
    fused_decode: bool = True
    max_preserved_context: int = 3072  # round-window watermark
    high_water: int = 4000  # the duplex unit window's marks (omni.h:81-94)
    low_water: int = 3500
    max_new_tokens: int = 512
    # out-of-band audio: {output_dir}/round_XXX/tts_wav/wav_N.wav and
    # generation_done.flag (omni-cli.cpp:370-377)
    output_dir: str | None = None


@dataclasses.dataclass
class LLMOut:
    """An LLM -> TTS chunk (struct LLMOut, omni.cpp:256)."""

    text: str
    token_ids: list[int]
    hidden_states: np.ndarray  # [n, d_llm] f32
    end_of_turn: bool = False
    is_final: bool = False


@dataclasses.dataclass
class RoundBoundary:
    """The KV positions [start_pos, end_pos) of one finished round."""

    start_pos: int
    end_pos: int


@dataclasses.dataclass
class UnitEntry:
    """One duplex <unit>...</unit> span of the KV (UnitEntry, omni.h:96-103)."""

    start_pos: int
    end_pos: int = -1  # -1: still open

    @property
    def closed(self) -> bool:
        return self.end_pos >= 0


class OmniPipeline:
    """Session orchestrator over injected contexts: the LLM `Context` and
    tokenizer, and for speech the TTS `Context` and its extras
    (`tts.load_params`), a `Token2Wav` session, an `audio_encoder` (wav
    [n] f32 at 16 kHz -> LLM rows [n / 1600, d]) and a `vision_encoder`
    (uint8 [H, W, 3] -> a list of LLM rows [64, d], the overview and then
    each slice; it may take `max_slice_nums=`)."""

    def __init__(self, llm: Context, tokenizer, config: SessionConfig | None = None,
                 *, tts_ctx: Context | None = None, tts_extras: dict | None = None,
                 token2wav=None, audio_encoder: Callable | None = None,
                 vision_encoder: Callable | None = None):
        self.cfg = config or SessionConfig()
        if self.cfg.use_tts and (tts_ctx is None or tts_extras is None
                                 or token2wav is None):
            raise ValueError("use_tts needs tts_ctx, tts_extras and token2wav")
        self.llm = llm
        self.tok = tokenizer
        self.tts_ctx = tts_ctx
        self.tts_extras = tts_extras
        self.t2w = token2wav
        self.audio_encoder = audio_encoder
        self.vision_encoder = vision_encoder
        self.special = {}
        for s in SPECIALS:
            tid = tokenizer.vocab.token_to_id.get(s)
            if tid is not None:
                self.special[s] = tid
        self._filter_ids = set(self.special.values())
        self.text_out: queue.Queue = queue.Queue()
        self._end_ids_cache: dict[bool, tuple[int, ...]] = {}  # by duplex
        self.break_event = threading.Event()  # stop_speak's flag
        self.n_keep = 0  # cells of the system prompt, never evicted
        self.rounds: list[RoundBoundary] = []
        self.units: list[UnitEntry] = []  # the duplex unit registry
        self.current_round = 0
        # the workers, their queues and their flags
        self.embed_queue: queue.Queue = queue.Queue(PREFILL_QUEUE_CAP)
        self.tts_queue: queue.Queue = queue.Queue(TTS_QUEUE_CAP)
        self.t2w_queue: queue.Queue = queue.Queue(T2W_QUEUE_CAP)
        self.wav_out: queue.Queue = queue.Queue()
        self.session_stop = threading.Event()
        self.prefill_done = threading.Event()
        self.prefill_done.set()
        self._prefill_pending = 0  # chunks queued or being prefilled
        self._prefill_mtx = threading.Lock()
        self.llama_mtx = threading.RLock()  # the LLM context's (omni.h:287)
        self._threads: list[threading.Thread] = []
        self._workers_started = False
        # work handed to the TTS and Token2Wav workers and not yet done
        # (a queue's emptiness cannot see an item a worker has taken)
        self._tts_pending = 0
        self._t2w_pending = 0
        self._counts_changed = threading.Condition(self._prefill_mtx)
        self.last_error: Exception | None = None  # a worker's error
        # the TTS: the speaker embedding prepended at chunk 0 (the default
        # voice until a reference audio sets it at session init), the
        # sampler's generator (the JAX pipeline's PRNGKey(0)), Token2Wav's
        # window primed with 3 silence codes
        self.spk_embed: torch.Tensor | None = None
        if tts_extras is not None:
            self.spk_embed = tts_mod.speaker_embed(tts_extras)
        self._tts_gen = (torch.Generator(device=tts_ctx.device).manual_seed(0)
                         if tts_ctx is not None else None)
        self._t2w_buffer: list[int] = [SILENCE_TOKEN] * T2W_LOOKAHEAD
        self._wav_index = 0

    @property
    def speaking(self) -> bool:
        """The turn's text goes to the TTS."""
        return self.cfg.use_tts and self.tts_ctx is not None

    def busy(self) -> bool:
        """True while a stage holds queued or in-flight work."""
        with self._prefill_mtx:
            return (self._prefill_pending + self._tts_pending
                    + self._t2w_pending) > 0

    def _count(self, name: str, delta: int) -> None:
        with self._counts_changed:
            setattr(self, name, getattr(self, name) + delta)
            self._counts_changed.notify_all()

    def _wake_waiters(self) -> None:
        with self._counts_changed:
            self._counts_changed.notify_all()

    def _put(self, q: queue.Queue, name: str, item) -> None:
        """Count the item as pending, then enqueue it (blocking at the
        queue's capacity: the back-pressure)."""
        self._count(name, 1)
        q.put(item)

    # ------------------------------------------------------------------ util
    def _encode(self, text: str) -> np.ndarray:
        return np.asarray(self.tok.encode(text, add_special=False), np.int64)

    def _eval_text(self, text: str):
        toks = self._encode(text)
        if len(toks):
            with self.llama_mtx:
                logits, _ = self.llm.decode(Batch(tokens=toks), block=False)
            return logits[-1]
        return None

    def _eval_embeds(self, emb, return_hidden: bool = False):
        """LLM rows [T, d] into the KV; their hidden states where asked."""
        with self.llama_mtx:
            _, hidden = self.llm.decode(Batch(embeds=emb),
                                        return_hidden=return_hidden, block=False)
        return hidden

    def _end_names(self) -> tuple[str, ...]:
        """The protocol's turn-ending tokens: a duplex turn does not end on
        <|tts_eos|>."""
        return (("<|turn_eos|>", "</s>") if self.cfg.duplex
                else ("<|turn_eos|>", "<|tts_eos|>", "</s>"))

    def is_end_token(self, tid: int) -> bool:
        return any(self.special.get(n) == tid for n in self._end_names()) or \
            self.tok.vocab.is_eog(tid)

    def is_valid_tts_token(self, tid: int) -> bool:
        """Text-chunk filter (omni.cpp:4432-4476): no special ids, nothing
        at or above 150000."""
        return tid < 150000 and tid not in self._filter_ids

    def _end_ids(self) -> tuple[int, ...]:
        """End-token ids for the on-device classifier: the protocol end
        names plus every EOG id of the vocab (per duplex setting)."""
        duplex = self.cfg.duplex
        if duplex not in self._end_ids_cache:
            ids = {self.special[n] for n in self._end_names() if n in self.special}
            v = self.tok.vocab
            eos = getattr(v, "eos_id", None)
            if eos is not None:
                ids.add(int(eos))
            for tid in getattr(v, "token_to_id", {}).values():
                if v.is_eog(tid):
                    ids.add(int(tid))
            self._end_ids_cache[duplex] = tuple(sorted(ids))
        return self._end_ids_cache[duplex]

    # ------------------------------------------------------------- prefill
    def effective_max_slice_nums(self) -> int:
        """The session's slice override: high_image forces 2, else
        max_slice_nums (-1: the encoder's default); vision.cpp:182-183."""
        return 2 if self.cfg.high_image else self.cfg.max_slice_nums

    def _encode_image_parts(self, image: np.ndarray,
                            max_slice_nums: int | None = None) -> list[torch.Tensor]:
        """The image's LLM rows, a list [overview, slice 1, ...] (an encoder
        that returns one array gives one part). The override goes to an
        encoder whose signature takes `max_slice_nums`, decided from the
        signature, so that an error inside the encoder is not taken for an
        encoder without the override."""
        msn = (max_slice_nums if max_slice_nums is not None and max_slice_nums >= 0
               else self.effective_max_slice_nums())
        try:
            takes_msn = "max_slice_nums" in inspect.signature(
                self.vision_encoder).parameters
        except (TypeError, ValueError):
            takes_msn = False
        parts = (self.vision_encoder(image, max_slice_nums=msn) if takes_msn
                 else self.vision_encoder(image))
        if isinstance(parts, (np.ndarray, torch.Tensor)):
            parts = [parts]
        return [torch.as_tensor(p, dtype=torch.float32) for p in parts]

    def stream_prefill(self, audio: np.ndarray | None = None,
                       image: np.ndarray | None = None, index: int = 0,
                       system_prompt: str = "",
                       ref_audio: np.ndarray | None = None,
                       frames: list | None = None,
                       max_slice_nums: int = -1) -> None:
        """One 1 s chunk of the session (omni.cpp:8637). Index 0 is session
        init: the system prompt (duplex: "Streaming Duplex Conversation!"
        before it) with the reference voice's audio (`ref_audio`, else the
        chunk's audio) between <|audio_start|> and <|audio_end|>, whose
        hidden states also set the TTS speaker embedding; the workers
        start. A later index's audio and images are encoded here and queued
        for the LLM worker: `image`, or `frames` (the second's video frames:
        frame 0 the main image and, under high_refresh, the rest stacked
        into one more). `max_slice_nums` >= 0 overrides the session's slice
        setting for this chunk (server.cpp:5585). Audio or images without
        their encoder raise ValueError."""
        if index == 0:
            if ref_audio is None and audio is not None:
                ref_audio = audio  # the server passes the voice as chunk 0
            if self.cfg.duplex:
                pre = ("<|im_start|>system\nStreaming Duplex Conversation!"
                       + (system_prompt or "") + "<|audio_start|>")
                suf = "<|audio_end|><|im_end|>\n"
            else:
                pre = "<|im_start|>system\n" + (system_prompt or "") + "\n<|audio_start|>"
                suf = "<|audio_end|><|im_end|>\n<|im_start|>user\n"
            self._eval_text(pre)
            if ref_audio is not None and self.audio_encoder is not None:
                hid = self._eval_embeds(self.audio_encoder(ref_audio),
                                        return_hidden=True)
                if self.tts_extras is not None:
                    self.spk_embed = tts_mod.speaker_embed(self.tts_extras, hid)
            self._eval_text(suf)
            self.n_keep = self.llm.n_past.get(0, 0)
            self._start_workers()
            return
        images = []
        if frames:
            images.append(np.asarray(frames[0]))
            if len(frames) > 1 and self.cfg.high_refresh:
                images.append(stack_frames([np.asarray(f) for f in frames[1:]]))
        elif image is not None:
            images.append(image)
        if audio is not None and self.audio_encoder is None:
            raise ValueError("a prefill chunk's audio needs the audio encoder")
        if images and self.vision_encoder is None:
            raise ValueError("a prefill chunk's image needs the vision encoder")
        if self.audio_encoder is None and self.vision_encoder is None:
            raise ValueError("a prefill chunk past index 0 needs an encoder")
        item: dict[str, Any] = {"index": index}
        if audio is not None:
            item["audio_embeds"] = self.audio_encoder(audio)
        if images:
            item["image_parts"] = [self._encode_image_parts(im, max_slice_nums)
                                   for im in images]
        with self._prefill_mtx:
            self._prefill_pending += 1
            self.prefill_done.clear()
        self._start_workers()
        self.embed_queue.put(item)

    def _prefill_item(self, item: dict) -> None:
        """One chunk's rows into the LLM's KV in the reference's marker
        layout (llm_thread_func, omni.cpp:4317-4383). Each image is
        <image>overview</image>, then, where it has slices, <slice>s</slice>
        for each and a newline; a duplex chunk opens with <unit> (with the
        first image's <image> in one eval) and puts its audio rows bare, a
        simplex chunk puts them between <|audio_start|> and <|audio_end|>."""
        duplex = self.cfg.duplex
        if duplex:
            self._register_unit_start()
        image_parts = item.get("image_parts") or []
        for i, parts in enumerate(image_parts):
            self._eval_text("<unit><image>" if i == 0 and duplex else "<image>")
            self._eval_embeds(parts[0])  # the overview
            self._eval_text("</image>")
            if len(parts) > 1:  # the slices (the V2.6 schema)
                for sl in parts[1:]:
                    self._eval_text("<slice>")
                    self._eval_embeds(sl)
                    self._eval_text("</slice>")
                self._eval_text("\n")
        if duplex and not image_parts:
            self._eval_text("<unit>")
        if "audio_embeds" in item:
            if duplex:
                self._eval_embeds(item["audio_embeds"])
            else:
                self._eval_text("<|audio_start|>")
                self._eval_embeds(item["audio_embeds"])
                self._eval_text("<|audio_end|>")

    def _llm_prefill_worker(self) -> None:
        """Queued chunks into the LLM's KV (llm_thread_func,
        omni.cpp:4229-4425)."""
        while not self.session_stop.is_set():
            try:
                item = self.embed_queue.get(timeout=0.01)
            except queue.Empty:
                continue
            try:
                with self.llama_mtx:
                    self._prefill_item(item)
            except Exception as e:  # noqa: BLE001 - surfaced on the session
                self.last_error = e
            finally:
                with self._prefill_mtx:
                    self._prefill_pending -= 1
                    if self._prefill_pending == 0:
                        self.prefill_done.set()

    def _wait_prefill(self) -> None:
        """Wait until every queued chunk is in the KV; a worker's error is
        raised here."""
        while not self.prefill_done.wait(timeout=0.05):
            if self.last_error is not None:
                break
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise RuntimeError("a pipeline worker failed") from err

    def prefill_text(self, text: str) -> None:
        """The words of the open user turn, evaluated into the KV: the text
        counterpart of a later `stream_prefill` chunk (the user turn is
        open after session init and after every turn's end)."""
        self._eval_text(text)

    # -------------------------------------------------------------- decode
    def stream_decode(self, round_idx: int = 0,
                      max_new_tokens: int | None = None) -> None:
        """One response turn. Text chunks appear on `text_out`, then a
        final {"content": "", "stop": True, ...} event. A simplex turn
        opens with the assistant header and closes with the turn end; its
        cells become one round of the window, and past
        max_preserved_context the oldest rounds are evicted
        (`_slide_window_if_needed`). A duplex turn opens with <|speak|>;
        its unit closes, and past high_water the oldest units are evicted
        (`_enforce_unit_window`)."""
        limit = max_new_tokens or self.cfg.max_new_tokens
        self._wait_prefill()
        self.break_event.clear()
        if round_idx >= 0:
            self.current_round = round_idx
        self._wav_index = 0
        round_start = self.llm.n_past.get(0, 0)
        if not self.cfg.duplex:
            last_logits = self._eval_text(SIMPLEX_ASSISTANT_PROMPT)
        else:
            last_logits = self._eval_text(
                "<|speak|>" if "<|speak|>" in self.special else "\n")
        chunk_tokens: list[int] = []
        chunk_hiddens: list[np.ndarray] = []
        if self.cfg.fused_decode and self.llm.sampler.mirostat == 0:
            _, ended_with_listen = self._decode_loop_fused(
                last_logits, limit, chunk_tokens, chunk_hiddens)
        else:
            _, ended_with_listen = self._decode_loop_host(
                last_logits, limit, chunk_tokens, chunk_hiddens)
        self._emit_chunk(chunk_tokens, chunk_hiddens, True)
        if not self.cfg.duplex and not ended_with_listen:
            self._eval_text(SIMPLEX_TURN_END)
        self.rounds.append(RoundBoundary(round_start, self.llm.n_past.get(0, 0)))
        if self.cfg.duplex:
            self._register_unit_end()
            self._enforce_unit_window()
        else:
            self._slide_window_if_needed()
        self.text_out.put({"content": "", "stop": True,
                           "end_of_turn": not ended_with_listen})

    def _decode_loop_host(self, last_logits, limit: int, chunk_tokens: list[int],
                          chunk_hiddens: list[np.ndarray]) -> tuple[int, bool]:
        """One decode and one sample per token (`Context.sample_token`,
        which carries mirostat's mu); the protocol of the fused loop.
        Returns (tokens sampled, ended on <|listen|>)."""
        n_new = 0
        segment_tokens = 0  # sampled in the duplex speak segment
        tok = None
        while n_new < limit and not self.break_event.is_set():
            if tok is not None:
                with self.llama_mtx:
                    logits, hidden = self.llm.decode(
                        Batch(tokens=np.array([tok])), return_hidden=True)
                last_logits = logits[0]
                if self.is_valid_tts_token(tok):
                    chunk_tokens.append(tok)
                    chunk_hiddens.append(hidden[0].cpu().numpy())
            tok = self.llm.sample_token(last_logits)
            n_new += 1
            segment_tokens += 1
            if self.special.get("<|listen|>") == tok:
                self.text_out.put({"content": "", "is_listen": True,
                                   "stop": True})
                return n_new, True
            if self.is_end_token(tok):
                return n_new, False
            if self.cfg.duplex and segment_tokens >= DUPLEX_CHUNK_CAP:
                # the cap-breaching sample never enters the KV: it is
                # replaced by <|chunk_eos|></unit> (omni.cpp:9317-9344)
                last_logits = self._force_chunk_end(last_logits)
                segment_tokens = 0
                tok = None
            if len(chunk_tokens) >= STEP_SIZE:
                self._emit_chunk(chunk_tokens, chunk_hiddens)
                del chunk_tokens[:], chunk_hiddens[:]
        return n_new, False

    def _issue(self, st: dict, stop_feed: int, inflight: list[int],
               turn_kvb: list) -> tuple[torch.Tensor, torch.Tensor]:
        """Enqueue one STEP_SIZE chunk; returns its (packed, hiddens)."""
        llm = self.llm
        free = llm.cache.size - llm.cells_used - inflight[0]
        if free < STEP_SIZE:
            raise KVCacheFull(
                f"omni decode: need {STEP_SIZE} free KV cells, have {free}")
        kvb = turn_kvb[0]
        if kvb is not None and (max(llm.kv_high, llm.cells_used)
                                + inflight[0] + STEP_SIZE) > kvb:
            kvb = turn_kvb[0] = llm.kv_bucket(
                max(llm.kv_high, llm.cells_used) + inflight[0] + STEP_SIZE)
        with self.llama_mtx:
            packed, hiddens, st["logits"], llm.cache, st["prev"], \
                st["pos"], st["done"] = omni_decode_scan(
                    llm._forward, llm._embed, llm.cfg, llm.params, llm.cache,
                    st["logits"], st["pos"], 0, st["prev"],
                    n_steps=STEP_SIZE, sp=llm.sampler, end_ids=self._end_ids(),
                    listen_id=self.special.get("<|listen|>", -3),
                    stop_after=min(stop_feed, STEP_SIZE), done_in=st["done"],
                    kv_limit=kvb, generator=llm.generator)
        inflight[0] += STEP_SIZE
        return packed, hiddens

    def _decode_loop_fused(self, last_logits, limit: int, chunk_tokens: list[int],
                           chunk_hiddens: list[np.ndarray]) -> tuple[int, bool]:
        """The served hot loop: STEP_SIZE-token chunks, each issued before
        the previous one's tokens are read (one host sync per chunk, none
        per token). Returns (tokens sampled, ended on <|listen|>)."""
        llm = self.llm
        listen_id = self.special.get("<|listen|>", -3)
        n_new = 0
        segment_tokens = 0  # sampled in the duplex speak segment
        ended_with_listen = False
        st = {"logits": last_logits,
              "pos": _scalar(llm.n_past.get(0, 0), llm.device),
              "prev": llm.prev_tokens, "done": None}
        inflight = [0]  # issued but not yet accounted steps
        # one ragged-KV bucket for the whole turn: occupied cells + the
        # token budget + a margin for the assistant/turn-end evals
        turn_kvb = [llm.kv_bucket(max(llm.kv_high, llm.cells_used)
                                  + limit + 4 * STEP_SIZE)]

        def feed_budget(n, seg):
            b = limit - n
            if self.cfg.duplex:
                b = min(b, DUPLEX_CHUNK_CAP - seg)
            return b - 1  # the terminal sample is never fed

        def account(packed_np) -> int:
            n_fed = int(packed_np[1].sum())
            inflight[0] -= STEP_SIZE
            llm.n_past[0] = llm.n_past.get(0, 0) + n_fed
            llm.cells_used += n_fed
            llm.kv_high = max(llm.kv_high, llm.cells_used)
            return n_fed

        pending = None
        while not self.break_event.is_set():
            if pending is None:
                b = feed_budget(n_new, segment_tokens)
                if n_new >= limit or b < 0:
                    break
                pending = self._issue(st, b, inflight, turn_kvb)
            # speculate only while both chunks are free-running (no cap or
            # budget stop can fall in either)
            spec = None
            b_spec = feed_budget(n_new + STEP_SIZE, segment_tokens + STEP_SIZE)
            if (feed_budget(n_new, segment_tokens) >= STEP_SIZE and b_spec >= STEP_SIZE
                    and llm.cache.size - llm.cells_used - inflight[0]
                    >= STEP_SIZE):
                spec = self._issue(st, b_spec, inflight, turn_kvb)
            packed_np = pending[0].cpu().numpy()  # the chunk's one sync
            # the hidden taps, read only for the TTS
            hid_np = pending[1].cpu().numpy() if self.speaking else None
            n_fed = account(packed_np)
            n_new += n_fed
            segment_tokens += n_fed
            for j, t in enumerate(packed_np[0][:n_fed]):
                t = int(t)
                if self.is_valid_tts_token(t):
                    chunk_tokens.append(t)
                    if hid_np is not None:
                        chunk_hiddens.append(hid_np[j])
                if len(chunk_tokens) >= STEP_SIZE:
                    self._emit_chunk(chunk_tokens, chunk_hiddens)
                    del chunk_tokens[:], chunk_hiddens[:]
            if n_fed < STEP_SIZE:  # the chunk froze on its stop token
                if spec is not None:  # its successor fed nothing
                    inflight[0] -= STEP_SIZE
                pending = None
                n_new += 1
                segment_tokens += 1
                stop_tok = int(packed_np[0][n_fed])
                if stop_tok == listen_id:
                    self.text_out.put({"content": "", "is_listen": True,
                                       "stop": True})
                    ended_with_listen = True
                    break
                if stop_tok in self._end_ids() or self.is_end_token(stop_tok):
                    break
                if self.cfg.duplex and segment_tokens >= DUPLEX_CHUNK_CAP:
                    # the stop token breached the cap: it is discarded
                    st["logits"] = self._force_chunk_end(st["logits"])
                    segment_tokens = 0
                # a cap or budget stop: re-sync the chained device state
                st["pos"] = _scalar(llm.n_past.get(0, 0), llm.device)
                st["done"] = None
            else:
                pending = spec
        if pending is not None:  # a break or budget exit left it in flight
            n_new += account(pending[0].cpu().numpy())
        llm.prev_tokens = st["prev"]
        return n_new, ended_with_listen

    def _force_chunk_end(self, last_logits):
        """At the duplex cap: <|chunk_eos|></unit> into the KV in place of
        the discarded sample, the open unit closed; returns the logits
        after </unit> (omni.cpp:9317-9344)."""
        forced = "".join(t for t in ("<|chunk_eos|>", "</unit>") if t in self.special)
        if forced:
            lg = self._eval_text(forced)
            if lg is not None:
                last_logits = lg
        self._register_unit_end()
        return last_logits

    def _emit_chunk(self, tokens: list[int], hiddens: list[np.ndarray],
                    final: bool = False) -> None:
        """The chunk's text to `text_out`; with TTS, the chunk and its
        hidden taps to the TTS worker (the queue holds one: back-pressure on
        the LLM)."""
        text = self.tok.decode(tokens) if tokens else ""
        if text:
            self.text_out.put({"content": text, "stop": False})
        if self.speaking:
            self._put(self.tts_queue, "_tts_pending", LLMOut(
                text=text, token_ids=list(tokens),
                hidden_states=(np.stack(hiddens) if hiddens else
                               np.zeros((0, self.llm.cfg.d_model), np.float32)),
                end_of_turn=final, is_final=final))

    # ------------------------------------------------------------------ TTS
    def _tts_worker(self) -> None:
        """LLMOut chunks -> audio codes to the Token2Wav queue
        (tts_thread_func, omni.cpp:6093); a final chunk ends the turn."""
        first_chunk = True
        while not self.session_stop.is_set():
            try:
                out: LLMOut = self.tts_queue.get(timeout=0.01)
            except queue.Empty:
                continue
            try:
                if self.break_event.is_set():
                    first_chunk = True
                    continue
                self._tts_generate(out, first_chunk, emit=self._emit_code)
                first_chunk = out.is_final
                if out.is_final:
                    self._emit_code(None)  # the turn's end
            except Exception as e:  # noqa: BLE001 - surfaced on the session
                self.last_error = e
            finally:
                self._count("_tts_pending", -1)

    def _emit_code(self, code) -> None:
        self._put(self.t2w_queue, "_t2w_pending", code)

    def _tts_generate(self, out: LLMOut, first_chunk: bool, emit=None) -> list[int]:
        """One text chunk's audio codes: its condition prefilled into the
        TTS context (cleared at chunk 0, whose condition starts with the
        speaker embedding), then 25-code scans, each issued before the
        previous one's codes are read (after the first chunk; in it, the
        second scan waits for the first window), until audio_eos or the cap:
        SIMPLEX_AUDIO_CAP codes, or in duplex DUPLEX_CHUNK_CAP with no
        audio_eos drawn before the turn's final chunk. The codes go to
        `emit` as each scan is read."""
        if not out.token_ids and not out.is_final:
            return []
        ex, ctx = self.tts_extras, self.tts_ctx
        cond = tts_mod.build_condition(
            ex, torch.as_tensor(np.asarray(out.token_ids, np.int64)),
            torch.as_tensor(out.hidden_states), end_of_turn=out.end_of_turn,
            spk_embed=self.spk_embed if first_chunk else None)
        if first_chunk:
            # the chunk-0 condition [spk, cond..., (text_eos), audio_bos] is
            # what the reference re-forwards for the first code
            # (omni.cpp:2504-2518): prefilling it once into a clear KV
            # builds the same cells
            ctx.clear_kv()
        _, hidden = ctx.decode(Batch(embeds=cond), return_hidden=True, block=False)
        cap = DUPLEX_CHUNK_CAP if self.cfg.duplex else SIMPLEX_AUDIO_CAP
        force = bool(self.cfg.duplex and not out.is_final)
        st = {"h": hidden[-1], "prev": None, "done": None,
              "pos": _scalar(ctx.n_past.get(0, 0), ctx.device)}
        first_scan = [True]

        def issue(n_steps):
            codes, ctx.cache, st["h"], st["prev"], st["pos"], st["done"] = \
                tts_mod.tts_decode_scan(
                    ctx.params, ctx.cfg, ex, ctx.cache, st["h"], st["pos"],
                    n_steps, first_chunk=first_chunk and first_scan[0],
                    force_no_eos=force, prev0=st["prev"], done_in=st["done"], generator=self._tts_gen)
            first_scan[0] = False
            return codes, n_steps

        all_codes: list[int] = []
        pending = issue(min(T2W_MAIN, cap))
        inflight = issued = pending[1]
        while pending is not None and not self.break_event.is_set():
            spec = None
            nxt = min(T2W_MAIN, cap - issued)
            # the first chunk reads each scan before issuing the next, so
            # its codes reach Token2Wav before more TTS work is queued
            if (not first_chunk and nxt > 0
                    and ctx.cache.size - ctx.cells_used - inflight >= nxt):
                spec = issue(nxt)
                inflight += nxt
                issued += nxt
            codes_np = pending[0].cpu().numpy()  # the scan's one read
            n_valid = int((codes_np >= 0).sum())
            inflight -= pending[1]
            ctx.n_past[0] = ctx.n_past.get(0, 0) + n_valid
            ctx.cells_used += n_valid  # the scan's writes bypass decode()
            ctx.kv_high = max(ctx.kv_high, ctx.cells_used)
            codes = codes_np[:n_valid].tolist()
            all_codes.extend(codes)
            if emit is not None:
                for c in codes:
                    emit(c)
            if n_valid < pending[1]:  # audio_eos: a successor is a no-op
                break
            if spec is not None:
                pending = spec
                continue
            nxt = min(T2W_MAIN, cap - issued)
            if nxt <= 0:
                break
            if first_chunk and issued == T2W_MAIN and not self._hold_for_token2wav():
                break
            pending = issue(nxt)
            inflight += nxt
            issued += nxt
        return all_codes

    def _hold_for_token2wav(self) -> bool:
        """Wait until Token2Wav has taken every code emitted so far and
        rendered its window (3 silence codes + the first scan's 25 make the
        turn's first window), or the turn or the session is stopped; False
        if it was."""
        def stopped():
            return self.break_event.is_set() or self.session_stop.is_set()

        with self._counts_changed:
            self._counts_changed.wait_for(lambda: self._t2w_pending == 0 or stopped())
        return not stopped()

    # ------------------------------------------------------------ Token2Wav
    def _t2w_worker(self) -> None:
        """The 25 + 3 sliding window (t2w_thread_func, omni.cpp:8284): every
        28 buffered codes make a window, 25 consumed; the turn's end
        flushes the rest as the final window and primes the next turn with
        3 silence codes."""
        while not self.session_stop.is_set():
            try:
                item = self.t2w_queue.get(timeout=0.01)
            except queue.Empty:
                continue
            final = item is None
            try:
                if not final:
                    self._t2w_buffer.append(int(item))
                dt = T2W_MAIN + T2W_LOOKAHEAD
                while len(self._t2w_buffer) >= dt or (
                        final and len(self._t2w_buffer) > T2W_LOOKAHEAD):
                    last = final and len(self._t2w_buffer) <= dt
                    wave = self.t2w.feed_window(
                        np.asarray(self._t2w_buffer[:dt], np.int64), is_final=last)
                    self.wav_out.put(wave)
                    self._write_wav_file(wave, final=last)
                    del self._t2w_buffer[:min(T2W_MAIN, len(self._t2w_buffer))]
                    if last:
                        self._t2w_buffer = [SILENCE_TOKEN] * T2W_LOOKAHEAD
                        break
            except Exception as e:  # noqa: BLE001 - surfaced on the session
                self.last_error = e
            finally:
                self._count("_t2w_pending", -1)

    def _write_wav_file(self, wave, final: bool) -> None:
        """round_XXX/tts_wav/wav_N.wav, and generation_done.flag after the
        turn's last window (the reference t2w thread and omni-cli)."""
        if not self.cfg.output_dir:
            return
        from .audio import write_wav

        rd = os.path.join(self.cfg.output_dir, f"round_{self.current_round:03d}")
        os.makedirs(os.path.join(rd, "tts_wav"), exist_ok=True)
        write_wav(os.path.join(rd, "tts_wav", f"wav_{self._wav_index}.wav"),
                  np.asarray(wave, np.float32), rate=24000)
        self._wav_index += 1
        if final:
            open(os.path.join(rd, "generation_done.flag"), "w").close()

    # ----------------------------------------------------------- lifecycle
    def _start_workers(self) -> None:
        """The prefill worker where audio or images come in, the TTS and
        Token2Wav workers where the session speaks; a text session starts
        none."""
        if self._workers_started:
            return
        encodes = self.audio_encoder is not None or self.vision_encoder is not None
        fns = ([self._llm_prefill_worker] if encodes else []) + (
            [self._tts_worker, self._t2w_worker] if self.speaking else [])
        self._workers_started = bool(fns)
        for fn in fns:
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)

    def wait_idle(self) -> None:
        """Wait until every stage is idle (the turn's last wave out); a
        worker's error is raised here."""
        while self.busy() and self.last_error is None:
            time.sleep(0.005)
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise RuntimeError("a pipeline worker failed") from err

    def shutdown(self) -> None:
        """Stop the workers and wait for them."""
        self.session_stop.set()
        self._wake_waiters()
        for t in self._threads:
            t.join(timeout=5.0)

    def warm_decode(self) -> None:
        """Run one no-op chunk (done_in=True feeds nothing) at every
        ragged-KV bucket the session can reach. The JAX package compiles
        its scans here; the port warms its kernels and allocator so the
        first timed chunk pays no first-use cost."""
        llm = self.llm
        kvbs = sorted(b for b in {llm.kv_bucket(b) for b in llm.kv_buckets}
                      if b is not None) + [None]
        done = torch.ones((), dtype=torch.bool, device=llm.device)
        # its own generator: warming must not move the session's draws
        gen = torch.Generator(device=llm.device)
        for kvb in kvbs:
            omni_decode_scan(
                llm._forward, llm._embed, llm.cfg, llm.params, llm.cache,
                torch.zeros(llm.cfg.n_vocab, device=llm.device),
                _scalar(0, llm.device), 0, llm.prev_tokens,
                n_steps=STEP_SIZE, sp=llm.sampler, end_ids=self._end_ids(),
                listen_id=self.special.get("<|listen|>", -3),
                stop_after=0, done_in=done, kv_limit=kvb, generator=gen)

    def stop_speak(self) -> None:
        """Break: stop the turn's generation at its next chunk (the TTS at
        its next scan) and drop what the queues hold (omni.cpp:9548)."""
        self.break_event.set()
        self._wake_waiters()
        for q, name in ((self.tts_queue, "_tts_pending"),
                        (self.t2w_queue, "_t2w_pending"), (self.text_out, None)):
            try:
                while True:
                    q.get_nowait()
                    if name is not None:
                        self._count(name, -1)
            except queue.Empty:
                pass

    def clean_kvcache(self) -> None:
        """Forget the session: the KV pools, n_keep, the round window and
        the unit registry (sliding_window_reset, omni.cpp:3107)."""
        self.llm.clear_kv()
        if self.tts_ctx is not None:
            self.tts_ctx.clear_kv()
        self.n_keep = 0
        self.rounds.clear()
        self.units.clear()

    # ------------------------------------------------------- sliding window
    def _slide_window_if_needed(self) -> None:
        """Round-granular eviction (kv_cache_slide_window, omni.cpp:686-820):
        past max_preserved_context, drop the oldest whole rounds, never the
        n_keep cells of the system prompt, and shift the later cells down
        (seq_add re-rotates their K)."""
        n_past = self.llm.n_past.get(0, 0)
        if n_past <= self.cfg.max_preserved_context:
            return
        while self.rounds and n_past > self.cfg.max_preserved_context:
            r = self.rounds[0]
            if r.start_pos < self.n_keep:
                break
            drop = r.end_pos - r.start_pos
            self.llm.seq_rm(0, r.start_pos, r.end_pos)
            self.llm.seq_add(0, r.end_pos, -1, -drop)
            self.rounds.pop(0)
            for rb in self.rounds:
                rb.start_pos -= drop
                rb.end_pos -= drop
            n_past -= drop
        self.llm.n_past[0] = n_past

    # ---------------------------------------- the unit window (duplex)
    # omni.cpp:3107-3405: <unit> spans registered; past high_water the
    # oldest closed units are dropped down to low_water, the n_keep cells
    # of the system prompt never, and the later cells re-based
    def _register_unit_start(self) -> None:
        pos = self.llm.n_past.get(0, 0)
        if self.units and not self.units[-1].closed:
            self.units[-1].end_pos = pos  # closed by the next unit
        self.units.append(UnitEntry(start_pos=pos))

    def _register_unit_end(self) -> None:
        if self.units and not self.units[-1].closed:
            self.units[-1].end_pos = self.llm.n_past.get(0, 0)

    def _enforce_unit_window(self) -> None:
        n_past = self.llm.n_past.get(0, 0)
        if n_past <= self.cfg.high_water:
            return
        while self.units and n_past > self.cfg.low_water:
            u = self.units[0]
            if not u.closed or u.start_pos < self.n_keep:
                break
            drop = u.end_pos - u.start_pos
            if drop <= 0:
                self.units.pop(0)
                continue
            self.llm.seq_rm(0, u.start_pos, u.end_pos)
            self.llm.seq_add(0, u.end_pos, -1, -drop)
            self.units.pop(0)
            for uu in self.units:
                uu.start_pos -= drop
                if uu.closed:
                    uu.end_pos -= drop
            for rb in self.rounds:
                rb.start_pos = max(rb.start_pos - drop, self.n_keep)
                rb.end_pos = max(rb.end_pos - drop, self.n_keep)
            n_past -= drop
        self.llm.n_past[0] = n_past

    # ------------------------------------------------------------ checkpoint
    def session_state_bytes(self) -> bytes:
        """The whole session: the LLM's KV pool and positions
        (`Context.state_bytes`), the round window and the unit registry,
        in the JAX package's pickle layout."""
        meta = {"n_keep": self.n_keep,
                "rounds": [(r.start_pos, r.end_pos) for r in self.rounds],
                "units": [(u.start_pos, u.end_pos) for u in self.units],
                "current_round": self.current_round,
                "cfg": dataclasses.asdict(self.cfg)}
        buf = io.BytesIO()
        pickle.dump({"meta": meta, "llm": self.llm.state_bytes()}, buf)
        return buf.getvalue()

    def load_session_state_bytes(self, data: bytes) -> None:
        """Restore a session saved by either package (a pickle, as the JAX
        package writes it: load only bytes a session of yours saved). The
        config fields this pipeline has are taken over but `use_tts` (the
        pipeline's TTS is fixed when it is built); the TTS KV restarts
        clean."""
        blob = pickle.load(io.BytesIO(data))
        meta = blob["meta"]
        self.llm.load_state_bytes(blob["llm"])
        self.n_keep = meta["n_keep"]
        self.rounds = [RoundBoundary(a, b) for a, b in meta["rounds"]]
        self.units = [UnitEntry(a, b) for a, b in meta["units"]]
        self.current_round = meta["current_round"]
        for f in dataclasses.fields(self.cfg):
            if f.name != "use_tts" and f.name in meta["cfg"]:
                setattr(self.cfg, f.name, meta["cfg"][f.name])
        if self.tts_ctx is not None:
            self.tts_ctx.clear_kv()
