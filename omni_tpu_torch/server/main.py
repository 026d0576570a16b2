"""HTTP inference server (counterpart of omni_tpu/server/main.py, itself
the counterpart of llama-server, tools/server/server.cpp): OpenAI-compatible
completions/chat/embeddings-style endpoints with SSE streaming, slot-based
continuous batching, health/metrics/slots introspection, tokenize and
detokenize, GBNF and JSON-schema grammars, tool calls, rerank, infill, slot
save/restore, and the six omni streaming endpoints
(/v1/stream/{omni_init,prefill,decode,break,reset,update_session_config},
server.cpp:6240-6248) wired to one OmniPipeline, over a decoder `Context`.

    python -m omni_tpu_torch.server.main -m FILE.gguf [--port 8080] \
        [-c 4096] [-np 4] [--cache-type-k bf16|q8_0|q4_0] \
        [--slot-save-path DIR] [--api-key KEY] [--device cpu]

stdlib http.server, one thread per request. Every device call runs under
`ServerState.sched_lock` on the one CUDA stream: kernel F's arrival
counters and kernel I's workspaces are per-device buffers that every call
shares. Plain requests take the fused single-stream path (concurrent ones
interleave by 16-token chunk under the lock); requests with a grammar,
n_probs, mirostat or infill share the mixed ubatches of
`SlotScheduler.step` (continuous batching).

Not ported yet, each refused at start-up by name: `--draft` (speculative
decoding) and `--lora` (ROADMAP queue 1 item 9), `--mmproj` (the mtmd chat),
encoder-only and recurrent models (item 10), `--warmup` (item 11).
"""

from __future__ import annotations

import collections
import json
import os
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..core.gguf import GGUFReader
from ..models import qwen3
from ..runtime import MAX_SEQS, Batch, Context, KVCacheFull, SamplerParams
from ..runtime.slots import SlotScheduler, SlotState
from ..tokenizer import build_tokenizer

# the JAX server's encoder-only architectures (served through BERT or
# EmbeddingGemma there) and its recurrent / hybrid families
# (omni_tpu/runtime/recurrent_session.py)
ENCODER_ARCHS = ("bert", "nomic-bert", "nomic-bert-moe", "jina-bert-v2",
                 "jina-bert-v3", "neo-bert", "gemma-embedding")
RECURRENT_ARCHS = ("mamba", "mamba2", "rwkv6", "rwkv6qwen2", "rwkv7", "arwkv7",
                   "jamba", "falcon-h1", "granitehybrid", "lfm2", "lfm2moe",
                   "nemotron_h", "plamo2")
SCRATCH_SEQ = 31  # embedding / rerank scratch (30 is the speculative one's)
FUSED_CHUNK = 16  # tokens a fused chunk of the single-stream path


class FifoRLock:
    """A re-entrant lock handed over in arrival order. With
    `threading.Lock` the thread that releases it takes it straight back
    (it holds the GIL), so one request's step loop would starve the others
    of their launch and no two requests would share a ubatch; here a
    released lock goes to the longest waiter."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._owner: int | None = None
        self._depth = 0
        self._queue: collections.deque = collections.deque()

    def acquire(self) -> bool:
        me = threading.get_ident()
        with self._cond:
            if self._owner == me:
                self._depth += 1
                return True
            ticket = object()
            self._queue.append(ticket)
            try:
                while self._owner is not None or self._queue[0] is not ticket:
                    self._cond.wait()
            except BaseException:  # interrupted: leave the queue to the rest
                self._queue.remove(ticket)
                self._cond.notify_all()
                raise
            self._queue.popleft()
            self._owner, self._depth = me, 1
            return True

    def release(self) -> None:
        with self._cond:
            if self._owner != threading.get_ident():
                raise RuntimeError("release of a FifoRLock not held")
            self._depth -= 1
            if self._depth == 0:
                self._owner = None
                self._cond.notify_all()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()


def apply_chat_template(messages: list[dict], add_generation_prompt=True) -> str:
    """ChatML (the MiniCPM-o/Qwen default; reference default_tts_chat_template
    at omni.cpp:3518)."""
    out = []
    for m in messages:
        out.append(f"<|im_start|>{m['role']}\n{m.get('content', '')}<|im_end|>\n")
    if add_generation_prompt:
        out.append("<|im_start|>assistant\n")
    return "".join(out)


class ServerState:
    def __init__(self, ctx: Context, tokenizer, n_slots: int = 4,
                 model_name: str = "omni-tpu",
                 slot_save_path: str | None = None,
                 chat_template: str | None = None,
                 api_key: str | None = None):
        from ..chat_parser import detect_format

        self.ctx = ctx
        # --api-key bearer auth (reference server --api-key; /health and
        # /models stay public, test_security.py contract)
        self.api_key = api_key
        self.tok = tokenizer
        self.model_name = model_name
        self._vocab_trie = None
        # seqs 30 (speculative) and 31 (embedding/rerank scratch) are
        # reserved; the KV bitset caps everything at MAX_SEQS (32)
        n_slots = max(1, min(n_slots, MAX_SEQS - 2))
        self.sched = SlotScheduler(ctx, n_slots=n_slots,
                                   vocab_trie=self._trie,
                                   token_text=lambda t: tokenizer.decode([t]))
        # re-entrant (the text-only omni session shares it as its
        # llama_mtx) and first come, first served (requests join the steps)
        self.sched_lock = FifoRLock()
        self.omni = None  # OmniPipeline, created by /v1/stream/omni_init
        # slot persistence is OFF unless --slot-save-path names a directory
        # (the reference gates it identically: tools/server --slot-save-path;
        # filenames are confined to that directory)
        self.slot_save_path = slot_save_path
        # model's own Jinja chat template (GGUF tokenizer.chat_template) +
        # the native tool-call format it implies (common/chat.cpp role)
        self.chat_template = chat_template
        self.chat_format = detect_format(chat_template)
        self._jinja_missing_logged = False
        self.metrics = {"n_requests": 0, "n_tokens_generated": 0,
                        "t_start": time.time()}
        self.loras: list[dict] = []  # --lora is not ported: always empty

    def render_prompt(self, messages, tools=None):
        """Resolve the model's chat template: Jinja render of the GGUF
        template first, then the built-in family renderer detected from its
        markers (reference llm_chat_apply_template fallback path,
        src/llama-chat.cpp) — so a template the Jinja engine can't render
        (or a machine without jinja2) still produces the correct surface
        form. Returns (prompt | None, chat_format)."""
        if self.chat_template:
            from ..chat_parser import apply_jinja_template

            try:
                return apply_jinja_template(
                    self.chat_template, messages, tools=tools,
                    add_generation_prompt=True), self.chat_format
            except ImportError:
                if not self._jinja_missing_logged:
                    self._jinja_missing_logged = True
                    print("omni-server: jinja2 is not installed; chat "
                          "templates render through the family renderers "
                          "(chat.py)", file=sys.stderr, flush=True)
            except Exception:  # noqa: BLE001 (template feature gap)
                pass
            from ..chat import _REGISTRY, detect_template

            fam = detect_template(self.chat_template)
            if fam is not None and fam != "chatml":
                try:
                    return _REGISTRY[fam](messages, True), "generic"
                except Exception:  # noqa: BLE001 (exotic roles)
                    pass
        return None, "generic"

    # lazy vocab trie (built once, only when a grammar request arrives)
    def _trie(self):
        if self._vocab_trie is None:
            from ..grammar import VocabTrie

            texts = []
            for tid in range(self.tok.vocab.n_tokens):
                try:
                    texts.append((tid, self.tok.decode([tid])))
                except Exception:  # noqa: BLE001
                    continue
            self._vocab_trie = VocabTrie(texts)
        return self._vocab_trie

    def _scratch_hidden(self, ids) -> torch.Tensor:
        """Hidden states [T, d] of `ids` on the scratch sequence, which is
        freed right after; call under sched_lock."""
        _, hidden = self.ctx.decode(Batch(
            tokens=np.asarray(ids, np.int32),
            pos=np.arange(len(ids), dtype=np.int32),
            seq_id=np.full(len(ids), SCRATCH_SEQ, np.int32)), return_hidden=True)
        self.ctx.seq_rm(SCRATCH_SEQ, -1, -1)
        self.ctx.n_past.pop(SCRATCH_SEQ, None)
        return hidden

    def embed(self, prompt_tokens) -> np.ndarray:
        """L2-normalized embedding (server /embedding contract): mean-pooled
        decoder hidden states."""
        with self.sched_lock:
            v = self._scratch_hidden(prompt_tokens).float().mean(0).cpu().numpy()
        return v / max(np.linalg.norm(v), 1e-12)

    def rank_score(self, query: str, doc: str) -> float:
        """RANK pooling: last hidden of [BOS]query[EOS]doc[EOS] through the
        optional cls (dense+tanh) and cls_out (projection) heads
        (reference format_rerank + build_pooling RANK)."""
        v = self.tok.vocab
        ids = []
        if v.bos_id is not None:
            ids.append(v.bos_id)
        ids += self.tok.encode(query, add_special=False)
        if v.eos_id is not None:
            ids.append(v.eos_id)
        ids += self.tok.encode(doc, add_special=False)
        if v.eos_id is not None:
            ids.append(v.eos_id)
        p = self.ctx.params
        with self.sched_lock:
            h = self._scratch_hidden(ids)[-1].float()  # LAST pooling (causal)
            if p.get("cls") is not None:
                h = p["cls"].float() @ h
                if p.get("cls_b") is not None:
                    h = h + p["cls_b"].float()
                h = torch.tanh(h)
            if p.get("cls_out") is not None:
                h = p["cls_out"].float() @ h
                if p.get("cls_out_b") is not None:
                    h = h + p["cls_out_b"].float()
            return float(h.reshape(-1)[0].cpu())

    # ---- scheduler-backed completion ---------------------------------
    def complete(self, prompt_tokens, max_new, sampler, stream_cb=None,
                 grammar=None, n_probs=0, infill=False,
                 grammar_lazy=False, grammar_triggers=()):
        # single-stream fast path: fused chunks (one host fetch per 16
        # tokens) through the slot machinery so prompt-cache/slot-save
        # contracts hold; grammar/n_probs/mirostat/infill requests take the
        # step scheduler (continuous batching)
        if (grammar is None and n_probs == 0 and sampler.mirostat == 0
                and not infill):  # FIM needs the host-side EOG-merge sampler
            return self._complete_fused(prompt_tokens, max_new, sampler,
                                        stream_cb)

        done = threading.Event()

        def on_token(tok, finished):
            self.metrics["n_tokens_generated"] += 1
            if stream_cb:
                stream_cb(tok, finished)
            if finished:
                done.set()

        with self.sched_lock:
            slot = self.sched.launch(prompt_tokens, max_new=max_new,
                                     sampler=sampler,
                                     stop_tokens=self._stop_ids(),
                                     on_token=on_token, grammar=grammar,
                                     n_probs=n_probs, infill=infill,
                                     grammar_lazy=grammar_lazy,
                                     grammar_triggers=grammar_triggers)
            if slot is None:
                return None
        try:
            while not done.is_set():
                with self.sched_lock:
                    if self.sched.has_work():
                        self.sched.step()
                    else:
                        break
        except BaseException:
            # a failed step (or a client gone mid-stream) must not leave
            # the slot in GENERATING state
            with self.sched_lock:
                self.sched.release(slot, free_kv=False)
            raise
        out = list(slot.out_tokens)
        timing = {
            "prompt_ms": (slot.t_first_token - slot.t_start) * 1e3,
            "predicted_ms": (time.time() - slot.t_first_token) * 1e3,
            "n_decoded": slot.n_decoded,
        }
        if n_probs:
            timing["probs"] = list(slot.probs_out)
        with self.sched_lock:
            # keep the KV: enables slot save/restore and prompt-cache reuse
            self.sched.release(slot, free_kv=False)
        return out, timing

    def _complete_fused(self, prompt_tokens, max_new, sampler, stream_cb):
        from ..runtime.loop import fused_generate

        with self.sched_lock:
            slot = self.sched.launch(prompt_tokens, max_new=max_new,
                                     sampler=sampler,
                                     stop_tokens=self._stop_ids())
            if slot is None:
                return None
        try:
            with self.sched_lock:
                # mark the prompt consumed: we prefill it ourselves; a
                # GENERATING slot with no out_tokens is inert for step()
                slot.n_prompt_done = len(prompt_tokens)
                slot.n_past = len(prompt_tokens)
                slot.state = SlotState.GENERATING
                try:
                    last = self.ctx.prefill(prompt_tokens, seq_id=slot.id)
                except KVCacheFull:
                    if self.sched.reclaim_idle_kv() == 0:
                        raise
                    last = self.ctx.prefill(prompt_tokens, seq_id=slot.id)
                slot.t_first_token = time.time()

            def cb(tok, finished):
                self.metrics["n_tokens_generated"] += 1
                if stream_cb:
                    stream_cb(tok, finished)

            def pre_chunk():  # per-slot context shift (server.cpp:2872)
                slot.n_past = self.ctx.n_past.get(slot.id, slot.n_past)
                if (slot.n_past + FUSED_CHUNK > self.sched.n_ctx_slot
                        and self.sched.ctx_shift):
                    self.sched._context_shift(slot)
                elif (self.ctx.cache.size - self.ctx.cells_used < FUSED_CHUNK
                      and self.sched.reclaim_idle_kv() == 0
                      and self.sched.ctx_shift):
                    self.sched._context_shift(slot)

            out = fused_generate(self.ctx, last, slot.id, max_new,
                                 stop_tokens=self._stop_ids(), chunk=FUSED_CHUNK,
                                 on_token=cb, sampler=sampler,
                                 lock=self.sched_lock, pre_chunk=pre_chunk)
            timing = {
                "prompt_ms": (slot.t_first_token - slot.t_start) * 1e3,
                "predicted_ms": (time.time() - slot.t_first_token) * 1e3,
                "n_decoded": len(out),
            }
            with self.sched_lock:
                slot.out_tokens = list(out)
                slot.n_decoded = len(out)
                slot.n_past = self.ctx.n_past.get(slot.id, slot.n_past)
                # DONE, so that no step feeds the finished stream before
                # the release below
                slot.state = SlotState.DONE
            return out, timing
        finally:
            # the slot must never leak in GENERATING state (client
            # disconnects raise from the stream callback mid-generation)
            with self.sched_lock:
                self.sched.release(slot, free_kv=False)

    def _stop_ids(self):
        v = self.tok.vocab
        ids = [v.eos_id] if v.eos_id is not None else []
        for s in ("<|im_end|>", "<|endoftext|>"):
            t = v.token_to_id.get(s)
            if t is not None:
                ids.append(t)
        return tuple(ids)


def make_handler(state: ServerState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        # ---- helpers -----------------------------------------------------
        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _sse_start(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

        def _sse_send(self, obj) -> None:
            data = f"data: {json.dumps(obj)}\n\n".encode()
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

        def _sse_done(self):
            data = b"data: [DONE]\n\n"
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            if n == 0:
                return {}
            return json.loads(self.rfile.read(n) or b"{}")

        # ---- GET ----------------------------------------------------------
        def _authed(self) -> bool:
            """--api-key gate (reference server.cpp middleware_server_state
            + test_security.py contract): /health and /models stay public;
            everything else needs `Authorization: Bearer <key>`."""
            if state.api_key is None:
                return True
            pub = self.path.split("?")[0] in (
                "/health", "/v1/health", "/models", "/v1/models")
            if pub:
                return True
            got = self.headers.get("Authorization", "")
            if got == f"Bearer {state.api_key}":
                return True
            self._json(401, {"error": {
                "message": "invalid api key",
                "type": "authentication_error"}})
            return False

        def do_GET(self):
            state.metrics["n_requests"] += 1
            if not self._authed():
                return
            if self.path in ("/health", "/v1/health"):
                self._json(200, {"status": "ok"})
            elif self.path in ("/v1/models", "/models", "/api/tags"):
                # /api/tags is the ollama-compat alias (server.cpp:6218)
                self._json(200, {"object": "list", "data": [
                    {"id": state.model_name, "object": "model"}],
                    "models": [{"name": state.model_name,
                                "model": state.model_name}]})
            elif self.path == "/props":
                self._json(200, {"model": state.model_name,
                                 "n_ctx": state.ctx.n_ctx,
                                 "n_slots": len(state.sched.slots)})
            elif self.path == "/lora-adapters":
                self._json(200, [{"id": i, "path": e["path"], "scale": e["scale"]}
                                 for i, e in enumerate(state.loras)])
            elif self.path == "/slots":
                self._json(200, [
                    {"id": s.id, "state": s.state.name,
                     "n_past": s.n_past, "n_decoded": s.n_decoded}
                    for s in state.sched.slots])
            elif self.path == "/metrics":
                with state.sched_lock:  # reads the pool on the device
                    m = state.sched.metrics()
                lines = [
                    "# TYPE omni_tpu_requests_total counter",
                    f"omni_tpu_requests_total {state.metrics['n_requests']}",
                    "# TYPE omni_tpu_tokens_generated_total counter",
                    f"omni_tpu_tokens_generated_total {state.metrics['n_tokens_generated']}",
                    "# TYPE omni_tpu_kv_cells_used gauge",
                    f"omni_tpu_kv_cells_used {m['kv_cells_used']}",
                    f"omni_tpu_kv_cells_total {m['kv_cells_total']}",
                ]
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "not found"})

        # ---- POST ---------------------------------------------------------
        def do_POST(self):
            state.metrics["n_requests"] += 1
            if not self._authed():
                return
            try:
                body = self._body()
                route = self.path.split("?")[0]
                if route in ("/completion", "/completions", "/v1/completions"):
                    self._handle_completion(body)
                elif route in ("/v1/chat/completions", "/chat/completions",
                               "/api/chat"):
                    # /api/chat = ollama-compat alias (server.cpp:6224)
                    self._handle_chat(body)
                elif route in ("/tokenize",):
                    toks = state.tok.encode(body.get("content", ""),
                                            add_special=body.get("add_special", False))
                    self._json(200, {"tokens": toks})
                elif route in ("/detokenize",):
                    self._json(200, {"content": state.tok.decode(
                        body.get("tokens", []))})
                elif route in ("/embedding", "/embeddings", "/v1/embeddings"):
                    self._handle_embeddings(body, openai="/v1/" in route)
                elif route in ("/rerank", "/v1/rerank", "/rerank/",
                               "/reranking", "/v1/reranking"):
                    self._handle_rerank(body)
                elif route == "/api/show":  # ollama-compat model info
                    self._json(200, {
                        "model_info": {"general.name": state.model_name},
                        "capabilities": ["completion"],
                    })
                elif route == "/infill":
                    self._handle_infill(body)
                elif route == "/apply-template":
                    msgs = body.get("messages", [])
                    p, _ = state.render_prompt(msgs)
                    self._json(200, {"prompt": p if p is not None
                                     else apply_chat_template(msgs)})
                elif route.startswith("/slots/"):
                    self._handle_slot_action(route, body)
                elif route == "/lora-adapters":
                    # no adapter is loaded (--lora is not ported): nothing
                    # to rescale
                    self._json(200, {"success": True})
                elif route.startswith("/v1/stream/"):
                    self._handle_omni(route[len("/v1/stream/"):], body)
                else:
                    self._json(404, {"error": "not found"})
            except BrokenPipeError:
                pass
            except ValueError as e:
                # request-shaped errors (e.g. prompt exceeds the per-slot
                # context budget) are the client's fault: structured 400
                # like the reference's ERROR_TYPE_INVALID_REQUEST
                try:
                    self._json(400, {"error": {
                        "message": str(e), "type": "invalid_request_error"}})
                except Exception:  # noqa: BLE001
                    pass
            except Exception as e:  # noqa: BLE001
                try:
                    self._json(500, {"error": str(e)})
                except Exception:  # noqa: BLE001
                    pass

        # ---- completions ---------------------------------------------------
        def _sampler_from(self, body) -> SamplerParams:
            return SamplerParams(
                temp=float(body.get("temperature", 0.8)),
                top_k=int(body.get("top_k", 40)),
                top_p=float(body.get("top_p", 0.95)),
                min_p=float(body.get("min_p", 0.05)),
                penalty_repeat=float(body.get("repeat_penalty", 1.0)),
                seed=int(body.get("seed", 42)),
                greedy=float(body.get("temperature", 0.8)) <= 0,
            )

        def _grammar_from(self, body):
            """Constrained decoding: GBNF text (`grammar`) or a JSON schema
            (`json_schema` / OpenAI response_format)."""
            from ..grammar import json_schema_to_gbnf, parse_gbnf

            gbnf = body.get("grammar")
            schema = body.get("json_schema")
            rf = body.get("response_format") or {}
            if not gbnf and not schema and isinstance(rf, dict):
                if rf.get("type") == "json_schema":
                    schema = rf.get("json_schema", {}).get("schema", True)
                elif rf.get("type") == "json_object":
                    schema = True
            if schema is not None and not gbnf:
                gbnf = json_schema_to_gbnf(schema if schema is not True else {})
            return parse_gbnf(gbnf) if gbnf else None

        def _handle_completion(self, body):
            prompt = body.get("prompt", "")
            toks = np.asarray(state.tok.encode(prompt), np.int32)
            max_new = int(body.get("n_predict", body.get("max_tokens", 128)))
            sampler = self._sampler_from(body)
            grammar = self._grammar_from(body)
            if body.get("stream"):
                self._sse_start()

                def cb(tok, finished):
                    self._sse_send({
                        "content": state.tok.decode([tok]),
                        "stop": bool(finished)})

                state.complete(toks, max_new, sampler, stream_cb=cb,
                               grammar=grammar)
                self._sse_done()
            else:
                n_probs = int(body.get("n_probs", 0))
                out, timing = state.complete(toks, max_new, sampler,
                                             grammar=grammar, n_probs=n_probs)
                resp = {
                    "content": state.tok.decode(out),
                    "tokens_predicted": timing["n_decoded"],
                    "timings": {k: v for k, v in timing.items()
                                if k != "probs"},
                }
                if n_probs:
                    # llama-server completion_probabilities contract
                    resp["completion_probabilities"] = [
                        {"id": tok,
                         "token": state.tok.decode([tok]),
                         "top_logprobs": [
                             {"id": i, "token": state.tok.decode([i]),
                              "logprob": lp} for i, lp in top]}
                        for tok, top in zip(out, timing.get("probs", []))]
                self._json(200, resp)

        def _tools_schema(self, tools, tool_choice):
            """JSON schema constraining output to a tool call (the
            reference's tool-call grammar, common/chat.cpp)."""
            fns = [t["function"] for t in tools if t.get("type") == "function"]
            if isinstance(tool_choice, dict):
                want = tool_choice.get("function", {}).get("name")
                fns = [f for f in fns if f["name"] == want]
            calls = [{
                "type": "object",
                "properties": {
                    "name": {"const": f["name"]},
                    "arguments": f.get("parameters", {"type": "object"}),
                },
                "required": ["name", "arguments"],
                "additionalProperties": False,
            } for f in fns]
            return calls[0] if len(calls) == 1 else {"anyOf": calls}

        def _hermes_tool_grammar(self, tools, tool_choice):
            """<tool_call>{...}</tool_call> grammar for hermes/qwen-format
            models (the reference's per-format tool grammars with lazy
            triggers, common/chat.cpp:2142-2249). Returns (Grammar,
            trigger words)."""
            import re as _re

            from ..grammar import json_schema_to_gbnf, parse_gbnf

            body = json_schema_to_gbnf(self._tools_schema(tools, tool_choice))
            body = _re.sub(r"\broot\b", "tc-obj", body)
            # single optional whitespace char around the payload: unbounded
            # [ \t\n]* lets a weak/greedy model meander in whitespace
            # forever instead of closing the call
            gbnf = (body + '\nnlsp ::= [ \\t\\n]?\n'
                    'root ::= "<tool_call>" nlsp tc-obj nlsp "</tool_call>"\n')
            return parse_gbnf(gbnf), ("<tool_call>",)

        def _parse_tool_call(self, text):
            try:
                obj = json.loads(text)
                return [{"id": f"call_{int(time.time()*1000)}",
                         "type": "function",
                         "function": {"name": obj["name"],
                                      "arguments": json.dumps(obj["arguments"])}}]
            except Exception:  # noqa: BLE001
                return None

        def _handle_chat(self, body):
            messages = list(body.get("messages", []))
            tools = body.get("tools") or []
            tool_choice = body.get("tool_choice", "auto" if tools else "none")
            force_tool = tools and tool_choice != "none" and (
                tool_choice == "required" or isinstance(tool_choice, dict))
            # model's own template (Jinja with native tool-call syntax,
            # then the built-in family renderer — common/chat.cpp role)
            prompt, chat_fmt = state.render_prompt(messages, tools or None)
            if prompt is None:
                if tools:
                    # advertise the tools in the system prompt; constrained
                    # JSON does the rest (generic-format fallback)
                    tool_desc = "\n".join(
                        f"- {t['function']['name']}: "
                        f"{t['function'].get('description', '')} "
                        f"parameters: {json.dumps(t['function'].get('parameters', {}))}"
                        for t in tools if t.get("type") == "function")
                    messages.insert(0, {
                        "role": "system",
                        "content": "You can call these tools by replying with "
                                   'JSON {"name": ..., "arguments": {...}}:\n'
                                   + tool_desc})
                prompt = apply_chat_template(messages)
            grammar_lazy, grammar_triggers = False, ()
            tool_grammar = None
            if force_tool and chat_fmt == "generic":
                body = dict(body)
                body["json_schema"] = self._tools_schema(tools, tool_choice)
                body.pop("response_format", None)
            elif tools and tool_choice != "none" and chat_fmt == "hermes":
                # hermes/qwen native syntax: grammar constrains the call;
                # with "auto" choice it stays DORMANT until the model emits
                # the <tool_call> trigger, so plain-text answers flow free
                tool_grammar, grammar_triggers = self._hermes_tool_grammar(
                    tools, tool_choice)
                grammar_lazy = not force_tool
            toks = np.asarray(
                state.tok.encode(prompt, parse_special=True), np.int32)
            max_new = int(body.get("max_tokens", 128))
            sampler = self._sampler_from(body)
            grammar = self._grammar_from(body) or tool_grammar
            rid = f"chatcmpl-{int(time.time()*1000)}"
            if body.get("stream"):
                self._sse_start()
                acc: list[int] = []
                parse_tools = bool(tools) and chat_fmt != "content_only"

                def cb(tok, finished):
                    acc.append(tok)
                    if parse_tools:
                        return  # buffered: tool syntax must not leak as text
                    self._sse_send({
                        "id": rid, "object": "chat.completion.chunk",
                        "model": state.model_name,
                        "choices": [{"index": 0, "delta":
                                     {"content": state.tok.decode([tok])},
                                     "finish_reason": "stop" if finished else None}],
                    })

                state.complete(toks, max_new, sampler, stream_cb=cb,
                               grammar=grammar, grammar_lazy=grammar_lazy,
                               grammar_triggers=grammar_triggers)
                if parse_tools:
                    # tool-enabled stream: parse the buffered output and
                    # deliver either tool_calls deltas or the content
                    # (OpenAI streaming contract, whole-call deltas)
                    from ..chat_parser import parse_response

                    text = state.tok.decode(acc, skip_special=True)
                    parsed = parse_response(text, chat_fmt)
                    if not parsed["tool_calls"] and force_tool:
                        parsed["tool_calls"] = self._parse_tool_call(text) or []
                    delta: dict = {}
                    finish = "stop"
                    if parsed["tool_calls"]:
                        delta["tool_calls"] = [
                            {"index": i, **c}
                            for i, c in enumerate(parsed["tool_calls"])]
                        finish = "tool_calls"
                    else:
                        delta["content"] = parsed["content"] or text
                    self._sse_send({
                        "id": rid, "object": "chat.completion.chunk",
                        "model": state.model_name,
                        "choices": [{"index": 0, "delta": delta,
                                     "finish_reason": finish}],
                    })
                self._sse_done()
            else:
                out, timing = state.complete(toks, max_new, sampler,
                                             grammar=grammar,
                                             grammar_lazy=grammar_lazy,
                                             grammar_triggers=grammar_triggers)
                content = state.tok.decode(out, skip_special=True)
                # parse the model-native tool-call syntax (chat-parser role)
                from ..chat_parser import parse_response

                parsed = parse_response(content, chat_fmt)
                message = {"role": "assistant",
                           "content": parsed["content"] or content}
                if parsed["reasoning_content"]:
                    message["reasoning_content"] = parsed["reasoning_content"]
                finish = "stop"
                calls = parsed["tool_calls"] or (
                    self._parse_tool_call(content) if force_tool else None)
                if (tools or force_tool) and calls:
                    message = {"role": "assistant", "content": None,
                               "tool_calls": calls}
                    if parsed["reasoning_content"]:
                        message["reasoning_content"] = parsed[
                            "reasoning_content"]
                    finish = "tool_calls"
                self._json(200, {
                    "id": rid, "object": "chat.completion",
                    "model": state.model_name,
                    "choices": [{"index": 0, "message": message,
                                 "finish_reason": finish}],
                    "usage": {"prompt_tokens": len(toks),
                              "completion_tokens": timing["n_decoded"],
                              "total_tokens": len(toks) + timing["n_decoded"]},
                })

        # ---- embeddings / infill / slot persistence -------------------------
        def _handle_embeddings(self, body, openai: bool):
            inputs = body.get("input", body.get("content", ""))
            if isinstance(inputs, str):
                inputs = [inputs]
            vecs = [state.embed(np.asarray(state.tok.encode(s), np.int32))
                    for s in inputs]
            if openai:
                self._json(200, {
                    "object": "list", "model": state.model_name,
                    "data": [{"object": "embedding", "index": i,
                              "embedding": v.tolist()}
                             for i, v in enumerate(vecs)]})
            else:
                self._json(200, [{"index": i, "embedding": [v.tolist()]}
                                 for i, v in enumerate(vecs)])

        def _handle_rerank(self, body):
            """Document reranking (server /v1/rerank): models with a rank
            head (cls/cls.output tensors; RANK pooling of the reference,
            src/llama-graph.cpp:1945-1974) score
            [BOS]query[EOS]doc[EOS] through the head; headless models fall
            back to embedding cosine similarity."""
            query = body.get("query", "")
            docs = body.get("documents", [])
            results = []
            p = state.ctx.params
            if p.get("cls_out") is not None or p.get("cls") is not None:
                for i, doc in enumerate(docs):
                    results.append({"index": i,
                                    "relevance_score":
                                        state.rank_score(query, doc)})
            else:
                qv = state.embed(np.asarray(state.tok.encode(query),
                                            np.int32))
                for i, doc in enumerate(docs):
                    dv = state.embed(np.asarray(state.tok.encode(doc),
                                                np.int32))
                    results.append({"index": i,
                                    "relevance_score": float(qv @ dv)})
            results.sort(key=lambda r: -r["relevance_score"])
            top_n = int(body.get("top_n", len(results)))
            self._json(200, {"model": state.model_name,
                             "results": results[:top_n]})

        def _handle_infill(self, body):
            """Fill-in-middle (server /infill): FIM special tokens when the
            vocab has them, else plain prefix+suffix concatenation."""
            v = state.tok.vocab
            pre = body.get("input_prefix", "")
            suf = body.get("input_suffix", "")
            fim_pre = v.token_to_id.get("<|fim_prefix|>")
            fim_suf = v.token_to_id.get("<|fim_suffix|>")
            fim_mid = v.token_to_id.get("<|fim_middle|>")
            if None not in (fim_pre, fim_suf, fim_mid):
                toks = ([fim_pre] + state.tok.encode(pre)
                        + [fim_suf] + state.tok.encode(suf) + [fim_mid])
            else:
                toks = state.tok.encode(pre + suf)
            out, timing = state.complete(
                np.asarray(toks, np.int32),
                int(body.get("n_predict", 64)), self._sampler_from(body),
                infill=True)
            self._json(200, {"content": state.tok.decode(out),
                             "tokens_predicted": timing["n_decoded"]})

        def _handle_slot_action(self, route, body):
            """POST /slots/{id}?action=save|restore|erase (server.cpp slot
            persistence, tested by test_slot_save.py in the reference)."""
            from urllib.parse import parse_qs, urlparse

            u = urlparse(self.path)
            sid = int(route.split("/")[2])
            action = parse_qs(u.query).get("action", [""])[0]
            if not (0 <= sid < len(state.sched.slots)):
                self._json(400, {"error": "invalid slot id"})
                return
            if action in ("save", "restore") and not state.slot_save_path:
                # same gate as the reference server: persistence requires
                # an explicit --slot-save-path directory
                self._json(400, {"error": "slot save/restore disabled "
                                          "(start with --slot-save-path)"})
                return

            def safe_path(name: str) -> str | None:
                """Confine client filenames to the configured directory:
                no separators, no parent traversal."""
                if (not name or "/" in name or "\\" in name or ".." in name
                        or name.startswith(".")):
                    return None
                return os.path.join(state.slot_save_path, name)

            if action == "save":
                path = safe_path(body.get("filename", f"slot_{sid}.bin"))
                if path is None:
                    self._json(400, {"error": "invalid filename"})
                    return
                with state.sched_lock:
                    blob = state.ctx.seq_state_bytes(sid)
                os.makedirs(state.slot_save_path, exist_ok=True)
                with open(path, "wb") as f:
                    f.write(blob)
                self._json(200, {"id_slot": sid,
                                 "filename": os.path.basename(path),
                                 "n_saved": len(blob)})
            elif action == "restore":
                path = safe_path(body.get("filename", f"slot_{sid}.bin"))
                if path is None:
                    self._json(400, {"error": "invalid filename"})
                    return
                if not os.path.exists(path):
                    self._json(400, {"error": "no such slot file"})
                    return
                with open(path, "rb") as f:
                    blob = f.read()
                with state.sched_lock:
                    n = state.ctx.load_seq_state_bytes(sid, blob)
                    state.sched.slots[sid].n_past = state.ctx.n_past.get(sid, 0)
                self._json(200, {"id_slot": sid, "n_restored": n})
            elif action == "erase":
                with state.sched_lock:
                    state.ctx.seq_rm(sid, -1, -1)
                    state.ctx.n_past.pop(sid, None)
                    state.sched.slots[sid].n_past = 0
                self._json(200, {"id_slot": sid, "erased": True})
            else:
                self._json(400, {"error": f"unknown action {action!r}"})

        # ---- omni streaming endpoints (server.cpp:5548-6080) ---------------
        def _handle_omni(self, action: str, body: dict):
            if action == "omni_init":
                ok = self._omni_init(body)
                self._json(200 if ok else 500,
                           {"success": ok} if ok else
                           {"error": "omni init failed (model_dir missing?)"})
            elif state.omni is None:
                self._json(400, {"error": "omni session not initialized"})
            elif action == "prefill":
                # body contract (server.cpp:5556-5619): audio_path_prefix /
                # img_path_prefix are FULL file paths on the server host,
                # cnt is the chunk index, max_slice_nums=-1 means session
                # default
                idx = int(body.get("cnt", body.get("index", 0)))
                audio = None
                if body.get("audio_path_prefix"):
                    from ..omni.audio import load_wav_mono_16k

                    audio = load_wav_mono_16k(body["audio_path_prefix"])
                image = None
                if body.get("img_path_prefix"):
                    from ..omni.image import load_image

                    image = load_image(body["img_path_prefix"])
                state.omni.stream_prefill(
                    audio=audio, image=image, index=idx,
                    system_prompt=body.get("system_prompt", ""),
                    max_slice_nums=int(body.get("max_slice_nums", -1)))
                self._json(200, {"success": True, "cnt": idx})
            elif action == "decode":
                t = threading.Thread(
                    target=state.omni.stream_decode,
                    kwargs={"round_idx": int(body.get("round_idx", -1))},
                    daemon=True)
                t.start()
                self._sse_start()
                while True:
                    try:
                        ev = state.omni.text_out.get(timeout=60.0)
                    except queue.Empty:
                        break
                    self._sse_send({
                        "content": ev.get("content", ""),
                        "stop": bool(ev.get("stop")),
                        "is_listen": bool(ev.get("is_listen")),
                        "end_of_turn": bool(ev.get("end_of_turn")),
                    })
                    if ev.get("stop"):
                        break
                self._sse_done()
                t.join(timeout=60.0)
            elif action == "break":
                state.omni.stop_speak()
                self._json(200, {"success": True})
            elif action == "reset":
                with state.omni.llama_mtx:
                    state.omni.clean_kvcache()
                self._json(200, {"success": True})
            elif action == "update_session_config":
                # hot-swap without reloading weights
                # (server.cpp:5990-6080; highImage forces max_slice_nums=2
                # at encode time via effective_max_slice_nums)
                cfg = state.omni.cfg
                for k in ("duplex", "media_type", "max_slice_nums",
                          "max_preserved_context", "use_tts", "high_image",
                          "high_refresh", "high_water", "low_water",
                          "max_new_tokens", "output_dir"):
                    if k in body:
                        setattr(cfg, k, body[k])
                # reference uses camelCase keys (server.cpp:6062, :6079)
                if "highImage" in body:
                    cfg.high_image = bool(body["highImage"])
                if "highRefresh" in body:
                    cfg.high_refresh = bool(body["highRefresh"])
                self._json(200, {
                    "success": True,
                    "highImage": cfg.high_image,
                    "highRefresh": cfg.high_refresh,
                    "duplex": cfg.duplex,
                    "media_type": cfg.media_type,
                })
            else:
                self._json(404, {"error": f"unknown stream action {action}"})

        def _omni_init(self, body: dict) -> bool:
            """Full omni session init (server.cpp:5746-5846): loads the
            module set from model_dir through omni-cli's `build_pipeline`,
            wires use_tts/duplex/output_dir, and prefills the voice-clone
            reference audio when given."""
            import glob as _glob

            from ..omni.pipeline import OmniPipeline, SessionConfig

            duplex = bool(body.get("duplex", False))
            use_tts = bool(body.get("use_tts", False))
            media_type = int(body.get("media_type", body.get("msg_type", 1)))
            model_dir = body.get("model_dir")
            if state.omni is not None:
                state.omni.shutdown()
                state.omni = None
            if model_dir:
                import argparse

                from ..cli.omni_cli import build_pipeline, resolve_model_paths

                hits = sorted(_glob.glob(os.path.join(model_dir, "*.gguf")))
                if not hits:
                    return False
                paths = resolve_model_paths(hits[0])
                ns = argparse.Namespace(
                    ctx_size=int(body.get("ctx_size", state.ctx.n_ctx)),
                    temp=float(body.get("temperature", 0.7)),
                    omni=media_type == 2,
                    duplex=duplex,
                    no_tts=not use_tts,
                    no_audio=False,
                    max_slice_nums=int(body.get("max_slice_nums", 9)),
                )
                state.omni = build_pipeline(paths, ns, device=state.ctx.device)
                state.omni.cfg.media_type = media_type
            else:
                # text-only session over the already-loaded LLM
                state.omni = OmniPipeline(
                    llm=state.ctx, tokenizer=state.tok,
                    config=SessionConfig(duplex=duplex, use_tts=False,
                                         media_type=media_type))
                # the session SHARES the completion Context here — its
                # device access must serialize against the slot scheduler
                # (two different locks on one Context would race)
                state.omni.llama_mtx = state.sched_lock
            if body.get("output_dir"):
                state.omni.cfg.output_dir = str(body["output_dir"])
            # voice-clone reference audio: index-0 prefill with it
            # (server.cpp:5821-5830)
            voice_audio = body.get("voice_audio") or ""
            if voice_audio:
                from ..omni.audio import load_wav_mono_16k

                state.omni.stream_prefill(
                    index=0,
                    system_prompt=body.get("system_prompt", ""),
                    ref_audio=load_wav_mono_16k(voice_audio))
            return True

    return Handler


def serve(state: ServerState, host: str = "127.0.0.1", port: int = 8080):
    httpd = ThreadingHTTPServer((host, port), make_handler(state))
    return httpd


def refuse_unported(args, arch: str | None = None) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for a flag or a
    model architecture the port's server does not serve yet."""
    if args.draft:
        raise NotImplementedError("--draft (speculative decoding) is not "
                                  "ported: ROADMAP queue 1 item 9")
    if args.lora:
        raise NotImplementedError("--lora (LoRA adapters) is not ported: "
                                  "ROADMAP queue 1 item 9")
    if args.mmproj:
        raise NotImplementedError("--mmproj (the mtmd chat) is not ported: "
                                  "ROADMAP queue 1 item 10")
    if args.warmup:
        raise NotImplementedError("--warmup is not ported: ROADMAP queue 1 "
                                  "item 11")
    if arch in ENCODER_ARCHS:
        raise NotImplementedError(f"encoder-only model {arch!r} (embedding / "
                                  "rerank) is not ported: ROADMAP queue 1 "
                                  "item 10")
    if arch in RECURRENT_ARCHS:
        raise NotImplementedError(f"recurrent model {arch!r} is not ported: "
                                  "ROADMAP queue 1 item 10")


def main(argv=None):
    from .. import resolve_device
    from ..cli.args import EnvArgumentParser

    ap = EnvArgumentParser("omni-server")
    ap.add_argument("-m", "--model", required=True, help="LLM GGUF path")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("-c", "--ctx-size", type=int, default=4096)
    ap.add_argument("-np", "--parallel", type=int, default=4)
    ap.add_argument("--cache-type-k", default="bf16",
                    choices=["bf16", "q8_0", "q4_0"])
    ap.add_argument("--lora", action="append", default=[],
                    help="LoRA adapter GGUF (not ported: refused)")
    ap.add_argument("--draft", help="draft model GGUF for speculative "
                                    "decoding (not ported: refused)")
    ap.add_argument("--api-key", default=None,
                    help="require `Authorization: Bearer <key>` on every "
                         "endpoint except /health and /models")
    ap.add_argument("--slot-save-path", default=None,
                    help="directory for slot save/restore files (persistence "
                         "is disabled unless set)")
    ap.add_argument("--mmproj", default=None,
                    help="multimodal projector GGUF (not ported: refused)")
    ap.add_argument("--warmup", action="store_true",
                    help="pre-compile before accepting traffic (not ported: "
                         "refused)")
    ap.add_argument("--device", default=None, help="cpu for the plain path")
    args = ap.parse_args(argv)
    refuse_unported(args)

    device = resolve_device(args.device)
    reader = GGUFReader(args.model)
    refuse_unported(args, reader.kv.get("general.architecture"))
    tok = build_tokenizer(reader.kv)
    cfg = qwen3.Qwen3Config.from_gguf(reader.kv)
    params = qwen3.load_params(reader, device=device)
    kv_dtype = {"q8_0": "q8_0", "q4_0": "q4_0"}.get(args.cache_type_k,
                                                    torch.bfloat16)
    ctx = Context(cfg, params, qwen3.forward, qwen3.embed,
                  n_ctx=args.ctx_size, device=device, kv_dtype=kv_dtype)
    state = ServerState(ctx, tok, n_slots=args.parallel,
                        slot_save_path=args.slot_save_path,
                        chat_template=reader.kv.get("tokenizer.chat_template"),
                        api_key=args.api_key)
    httpd = serve(state, args.host, args.port)
    print(f"omni-server listening on http://{args.host}:{args.port}")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
