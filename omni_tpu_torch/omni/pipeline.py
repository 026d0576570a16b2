"""The omni session orchestrator, LLM only (counterpart of
omni_tpu/omni/pipeline.py with duplex=False, use_tts=False).

A session starts with `stream_prefill(index=0, system_prompt=...)`, which
opens the first user turn; a text turn's words go in with `prefill_text`;
each response is one `stream_decode`, whose text arrives on the `text_out`
queue in chunks of STEP_SIZE tokens. The prompts are MiniCPM-o's simplex
ChatML: the system turn, then per round the user's words, the assistant
header and the reply, closed by "<|im_end|>\n<|im_start|>user\n".

The decode loop is the JAX package's fused loop: STEP_SIZE-token chunks of
`omni_decode_scan`, the next chunk issued before the current one's results
are read (its `done_in` chains the previous chunk's frozen flag), so the
host enqueues while the card runs. Mirostat, whose mu the host carries, or
`SessionConfig(fused_decode=False)` take the host loop instead, one decode
and one sample per token.

Every finished round is recorded (`rounds`); past `max_preserved_context`
the oldest whole rounds are evicted, never the `n_keep` cells of the system
prompt, and the later cells shift down with `Context.seq_add` (K
re-rotated). `session_state_bytes` saves the KV pool and the round window
in the JAX package's layout.

Duplex, TTS and Token2Wav and the encoders (audio, image: `stream_prefill`
index > 0) are later slices.
"""

from __future__ import annotations

import dataclasses
import io
import pickle
import queue
import threading

import numpy as np
import torch

from ..runtime import Batch, Context, KVCacheFull
from ..runtime.loop import _scalar, omni_decode_scan

STEP_SIZE = 10  # LLM tokens per chunk (omni.cpp:9120)

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
    """Session config; this slice serves duplex=False, use_tts=False."""

    duplex: bool = False
    use_tts: bool = False
    # the fused decode loop (STEP_SIZE-token chunks a host dispatch);
    # mirostat takes the host loop whatever this says
    fused_decode: bool = True
    max_preserved_context: int = 3072  # round-window watermark
    max_new_tokens: int = 512


@dataclasses.dataclass
class RoundBoundary:
    """The KV positions [start_pos, end_pos) of one finished round."""

    start_pos: int
    end_pos: int


class OmniPipeline:
    """Session orchestrator over an injected LLM `Context` and tokenizer."""

    def __init__(self, llm: Context, tokenizer,
                 config: SessionConfig | None = None):
        self.cfg = config or SessionConfig()
        if self.cfg.duplex or self.cfg.use_tts:
            raise NotImplementedError(
                "duplex and TTS sessions are not ported yet")
        self.llm = llm
        self.tok = tokenizer
        self.special = {}
        for s in SPECIALS:
            tid = tokenizer.vocab.token_to_id.get(s)
            if tid is not None:
                self.special[s] = tid
        self._filter_ids = set(self.special.values())
        self.text_out: queue.Queue = queue.Queue()
        self._end_ids_cache: tuple[int, ...] | None = None
        self.break_event = threading.Event()  # stop_speak's flag
        self.n_keep = 0  # cells of the system prompt, never evicted
        self.rounds: list[RoundBoundary] = []
        self.current_round = 0

    # ------------------------------------------------------------------ util
    def _encode(self, text: str) -> np.ndarray:
        return np.asarray(self.tok.encode(text, add_special=False), np.int64)

    def _eval_text(self, text: str):
        toks = self._encode(text)
        if len(toks):
            logits, _ = self.llm.decode(Batch(tokens=toks), block=False)
            return logits[-1]
        return None

    def is_end_token(self, tid: int) -> bool:
        return any(self.special.get(n) == tid
                   for n in ("<|turn_eos|>", "<|tts_eos|>", "</s>")) or \
            self.tok.vocab.is_eog(tid)

    def is_valid_tts_token(self, tid: int) -> bool:
        """Text-chunk filter (omni.cpp:4432-4476): no special ids, nothing
        at or above 150000."""
        return tid < 150000 and tid not in self._filter_ids

    def _end_ids(self) -> tuple[int, ...]:
        """End-token ids for the on-device classifier: the protocol end
        names plus every EOG id of the vocab."""
        if self._end_ids_cache is None:
            ids = {self.special[n] for n in ("<|turn_eos|>", "<|tts_eos|>",
                                             "</s>") if n in self.special}
            v = self.tok.vocab
            eos = getattr(v, "eos_id", None)
            if eos is not None:
                ids.add(int(eos))
            for tid in getattr(v, "token_to_id", {}).values():
                if v.is_eog(tid):
                    ids.add(int(tid))
            self._end_ids_cache = tuple(sorted(ids))
        return self._end_ids_cache

    # ------------------------------------------------------------- prefill
    def stream_prefill(self, index: int = 0, system_prompt: str = "") -> None:
        """Session init (index 0): evaluate the simplex system prompt. Later
        indices carry audio/image chunks, which need the encoders."""
        if index != 0:
            raise NotImplementedError(
                "audio/image prefill chunks need the encoders (later slice)")
        self._eval_text("<|im_start|>system\n" + (system_prompt or "")
                        + "\n<|audio_start|>")
        self._eval_text("<|audio_end|><|im_end|>\n<|im_start|>user\n")
        self.n_keep = self.llm.n_past.get(0, 0)

    def prefill_text(self, text: str) -> None:
        """The words of the open user turn, evaluated into the KV: the text
        counterpart of a later `stream_prefill` chunk (the user turn is
        open after session init and after every turn's end)."""
        self._eval_text(text)

    # -------------------------------------------------------------- decode
    def stream_decode(self, round_idx: int = 0,
                      max_new_tokens: int | None = None) -> None:
        """One response turn. Text chunks appear on `text_out`, then a
        final {"content": "", "stop": True, ...} event. The turn's cells
        become one round of the window; past max_preserved_context the
        oldest rounds are evicted (`_slide_window_if_needed`)."""
        limit = max_new_tokens or self.cfg.max_new_tokens
        self.break_event.clear()
        if round_idx >= 0:
            self.current_round = round_idx
        round_start = self.llm.n_past.get(0, 0)
        last_logits = self._eval_text(SIMPLEX_ASSISTANT_PROMPT)
        chunk_tokens: list[int] = []
        if self.cfg.fused_decode and self.llm.sampler.mirostat == 0:
            _, ended_with_listen = self._decode_loop_fused(
                last_logits, limit, chunk_tokens)
        else:
            _, ended_with_listen = self._decode_loop_host(
                last_logits, limit, chunk_tokens)
        self._emit_chunk(chunk_tokens)
        if not ended_with_listen:
            self._eval_text(SIMPLEX_TURN_END)
        self.rounds.append(RoundBoundary(round_start, self.llm.n_past.get(0, 0)))
        self._slide_window_if_needed()
        self.text_out.put({"content": "", "stop": True,
                           "end_of_turn": not ended_with_listen})

    def _decode_loop_host(self, last_logits, limit: int,
                          chunk_tokens: list[int]) -> tuple[int, bool]:
        """One decode and one sample per token (`Context.sample_token`,
        which carries mirostat's mu); the protocol of the fused loop.
        Returns (tokens sampled, ended on <|listen|>)."""
        n_new = 0
        tok = None
        while n_new < limit and not self.break_event.is_set():
            if tok is not None:
                logits, _ = self.llm.decode(Batch(tokens=np.array([tok])))
                last_logits = logits[0]
                if self.is_valid_tts_token(tok):
                    chunk_tokens.append(tok)
            tok = self.llm.sample_token(last_logits)
            n_new += 1
            if self.special.get("<|listen|>") == tok:
                self.text_out.put({"content": "", "is_listen": True,
                                   "stop": True})
                return n_new, True
            if self.is_end_token(tok):
                return n_new, False
            if len(chunk_tokens) >= STEP_SIZE:
                self._emit_chunk(chunk_tokens)
                del chunk_tokens[:]
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

    def _decode_loop_fused(self, last_logits, limit: int,
                           chunk_tokens: list[int]) -> tuple[int, bool]:
        """The served hot loop: STEP_SIZE-token chunks, each issued before
        the previous one's tokens are read (one host sync per chunk, none
        per token). Returns (tokens sampled, ended on <|listen|>)."""
        llm = self.llm
        listen_id = self.special.get("<|listen|>", -3)
        n_new = 0
        ended_with_listen = False
        st = {"logits": last_logits,
              "pos": _scalar(llm.n_past.get(0, 0), llm.device),
              "prev": llm.prev_tokens, "done": None}
        inflight = [0]  # issued but not yet accounted steps
        # one ragged-KV bucket for the whole turn: occupied cells + the
        # token budget + a margin for the assistant/turn-end evals
        turn_kvb = [llm.kv_bucket(max(llm.kv_high, llm.cells_used)
                                  + limit + 4 * STEP_SIZE)]

        def feed_budget(n):
            return limit - n - 1  # the terminal sample is never fed

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
                b = feed_budget(n_new)
                if n_new >= limit or b < 0:
                    break
                pending = self._issue(st, b, inflight, turn_kvb)
            # speculate only while both chunks are free-running
            spec = None
            b_spec = feed_budget(n_new + STEP_SIZE)
            if (feed_budget(n_new) >= STEP_SIZE and b_spec >= STEP_SIZE
                    and llm.cache.size - llm.cells_used - inflight[0]
                    >= STEP_SIZE):
                spec = self._issue(st, b_spec, inflight, turn_kvb)
            packed_np = pending[0].cpu().numpy()  # the chunk's one sync
            n_fed = account(packed_np)
            n_new += n_fed
            for t in packed_np[0][:n_fed]:
                t = int(t)
                if self.is_valid_tts_token(t):
                    chunk_tokens.append(t)
                if len(chunk_tokens) >= STEP_SIZE:
                    self._emit_chunk(chunk_tokens)
                    del chunk_tokens[:]
            if n_fed < STEP_SIZE:  # the chunk froze on its stop token
                if spec is not None:  # its successor fed nothing
                    inflight[0] -= STEP_SIZE
                pending = None
                n_new += 1
                stop_tok = int(packed_np[0][n_fed])
                if stop_tok == listen_id:
                    self.text_out.put({"content": "", "is_listen": True,
                                       "stop": True})
                    ended_with_listen = True
                    break
                if stop_tok in self._end_ids() or self.is_end_token(stop_tok):
                    break
                # budget stop: re-sync the chained device state
                st["pos"] = _scalar(llm.n_past.get(0, 0), llm.device)
                st["done"] = None
            else:
                pending = spec
        if pending is not None:  # a break or budget exit left it in flight
            n_new += account(pending[0].cpu().numpy())
        llm.prev_tokens = st["prev"]
        return n_new, ended_with_listen

    def _emit_chunk(self, tokens: list[int]) -> None:
        text = self.tok.decode(tokens) if tokens else ""
        if text:
            self.text_out.put({"content": text, "stop": False})

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
        """Break: stop the turn's generation at its next chunk and drop the
        text not yet read (omni.cpp:9548)."""
        self.break_event.set()
        try:
            while True:
                self.text_out.get_nowait()
        except queue.Empty:
            pass

    def clean_kvcache(self) -> None:
        """Forget the session: the KV pool, n_keep and the round window."""
        self.llm.clear_kv()
        self.n_keep = 0
        self.rounds.clear()

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

    # ------------------------------------------------------------ checkpoint
    def session_state_bytes(self) -> bytes:
        """The whole session: the LLM's KV pool and positions
        (`Context.state_bytes`) and the round window, in the JAX
        package's pickle layout (its duplex unit registry empty)."""
        meta = {"n_keep": self.n_keep,
                "rounds": [(r.start_pos, r.end_pos) for r in self.rounds],
                "units": [], "current_round": self.current_round,
                "cfg": dataclasses.asdict(self.cfg)}
        buf = io.BytesIO()
        pickle.dump({"meta": meta, "llm": self.llm.state_bytes()}, buf)
        return buf.getvalue()

    def load_session_state_bytes(self, data: bytes) -> None:
        """Restore a session saved by either package (a pickle, as the JAX
        package writes it: load only bytes a session of yours saved). The
        config fields this pipeline has are taken over; a duplex session,
        or one with units, is refused."""
        blob = pickle.load(io.BytesIO(data))
        meta = blob["meta"]
        if meta["cfg"].get("duplex") or meta.get("units"):
            raise NotImplementedError("duplex sessions are not ported yet")
        self.llm.load_state_bytes(blob["llm"])
        self.n_keep = meta["n_keep"]
        self.rounds = [RoundBoundary(a, b) for a, b in meta["rounds"]]
        self.current_round = meta["current_round"]
        for f in dataclasses.fields(self.cfg):
            if f.name not in ("duplex", "use_tts") and f.name in meta["cfg"]:
                setattr(self.cfg, f.name, meta["cfg"][f.name])
