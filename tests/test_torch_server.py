"""The port's HTTP server (omni_tpu_torch.server.main) against omni_tpu's,
both on ephemeral ports over the tiny file of tests/test_server.py (2
layers, d_model 64, a 300-token byte-level BPE vocabulary, F32 weights):
greedy completion, chat, chat SSE, a GBNF grammar, a json_schema
response_format, a forced tool call, tokenize/detokenize, infill and
n_probs give equal bodies but for ids and timings (n_probs: the same
tokens and top ids, logprobs within JIT_LOGITS_ATOL of the JAX server's
jitted steps; test_torch_slots.py holds them to 2e-2 of the op-by-op
run); a step-path stream that parts from the JAX one is teacher-forced to
prove the parting a rounding flip; embeddings and the rank score (a file
with a rank head) match within cosine >= 0.999 and max|d| <= 2e-2. On the
port alone: the route contract of tests/test_server.py, the --api-key
gate, slot save/restore/erase (a traversal in the filename is refused),
the text-only /v1/stream/* session, the family fallback without jinja2,
`main` on the CPU, and each unported flag or model refused by name."""

import json
import threading
import urllib.error
import urllib.request
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from jax._src import compilation_cache
from omni_tpu.core import GGMLType
from omni_tpu.core import GGUFReader as JaxReader
from omni_tpu.models import qwen3 as jq
from omni_tpu.runtime import Context as JaxContext
from omni_tpu.server import main as jmain
from omni_tpu.testing import write_tiny_qwen3
from omni_tpu.tokenizer import build_tokenizer as jax_tokenizer
from omni_tpu_torch.core.gguf import GGUFReader
from omni_tpu_torch.models import qwen3 as tq
import omni_tpu_torch.runtime.slots as slots_mod
from omni_tpu_torch.runtime import Context
from omni_tpu_torch.server import main as tmain
from omni_tpu_torch.tokenizer import build_tokenizer
from test_torch_model import JIT_LOGITS_ATOL

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=64, n_vocab=300, qtype=GGMLType.F32, byte_tokenizer=True)


@pytest.fixture(scope="module", autouse=True)
def no_compile_cache():
    """Keep the JAX reference calls from writing compile-cache entries into
    the tracked omni_tpu/_warmcache/."""
    old = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", old)
    compilation_cache.reset_cache()


def _load(path, n_ctx=1024):
    jr = JaxReader(path)
    jcfg = jq.Qwen3Config.from_gguf(jr.kv)
    jctx = JaxContext(jcfg, jq.load_params(jr), jq.forward, jq.embed, n_ctx=n_ctx)
    tr = GGUFReader(path)
    tctx = Context(tq.Qwen3Config.from_gguf(tr.kv), tq.load_params(tr, device="cpu"),
                   tq.forward, tq.embed, n_ctx=n_ctx, device="cpu")
    tok = build_tokenizer(tr.kv)
    tr.close()
    return jctx, jax_tokenizer(jr.kv), tctx, tok


def _start(mod, state):
    httpd = mod.serve(state, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, t, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("torch_server")
    path = d / "llm.gguf"
    write_tiny_qwen3(path, **TINY)
    jctx, jtok, tctx, tok = _load(path)
    jstate = jmain.ServerState(jctx, jtok, n_slots=2,
                               slot_save_path=str(d / "jslots"))
    jax_outs = []  # each JAX completion's tokens, for teacher forcing
    complete = jstate.complete

    def recording(*a, **kw):
        r = complete(*a, **kw)
        jax_outs.append(list(r[0]))
        return r

    jstate.complete = recording
    tstate = tmain.ServerState(tctx, tok, n_slots=2,
                               slot_save_path=str(d / "slots"))
    started = [_start(jmain, jstate), _start(tmain, tstate)]
    yield {"jax": started[0][2], "port": started[1][2], "state": tstate,
           "path": path, "dir": d, "jax_outs": jax_outs}
    for httpd, t, _ in started:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def _post(url, obj, raw=False, headers=None):
    req = urllib.request.Request(url, json.dumps(obj).encode(),
                                 {"Content-Type": "application/json",
                                  **(headers or {})})
    with urllib.request.urlopen(req, timeout=300) as r:
        data = r.read()
    return data if raw else json.loads(data)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read().decode()


def _events(raw: bytes):
    return [json.loads(line[6:]) for line in raw.decode().splitlines()
            if line.startswith("data: ") and line != "data: [DONE]"]


def _norm(obj):
    """A body with its timings dropped and its ids (timestamps, call ids)
    blanked."""
    if isinstance(obj, list):
        return [_norm(v) for v in obj]
    if isinstance(obj, dict):
        return {k: ("" if k == "id" and isinstance(v, str) else _norm(v))
                for k, v in obj.items() if k != "timings"}
    return obj


TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "Get the weather",
    "parameters": {"type": "object",
                   "properties": {"city": {"type": "string", "maxLength": 4}},
                   "required": ["city"], "additionalProperties": False}}}]
SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"},
                                           "c": {"enum": ["a", "b"]}},
          "required": ["ok", "c"], "additionalProperties": False}
CASES = {
    "completion": ("/completion", {"prompt": "hi there", "n_predict": 12,
                                   "temperature": 0.0}),
    "chat": ("/v1/chat/completions", {
        "messages": [{"role": "system", "content": "Be brief."},
                     {"role": "user", "content": "hello"}],
        "max_tokens": 10, "temperature": 0.0}),
    "chat_sse": ("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hello"}], "max_tokens": 6,
        "temperature": 0.0, "stream": True}),
    "grammar": ("/completion", {"prompt": "answer:", "n_predict": 8,
                                "temperature": 0.0,
                                "grammar": 'root ::= "yes" | "no"'}),
    "json_schema": ("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "give a bool"}],
        "max_tokens": 32, "temperature": 0.0,
        "response_format": {"type": "json_schema",
                            "json_schema": {"schema": SCHEMA}}}),
    "tool_call": ("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "weather in Paris?"}],
        "tools": TOOLS, "tool_choice": "required", "max_tokens": 64,
        "temperature": 0.0}),
    "tokenize": ("/tokenize", {"content": "hello world 一二 <|im_end|>",
                               "add_special": True}),
    "detokenize": ("/detokenize", {"tokens": [104, 105, 256, 32, 228, 184]}),
    "infill": ("/infill", {"input_prefix": "def add(a, b):",
                           "input_suffix": "return c", "n_predict": 6,
                           "temperature": 0.0}),
}


STEP_PATH = ("grammar", "json_schema", "tool_call")  # SlotScheduler.step


def _teacher(forced, gaps):
    """A stand-in for the slots' `sample`: the next of the JAX server's
    tokens (then the port's own argmax); where the port's own argmax
    differs, the logit gap is recorded."""
    def sample(logits, *a, **kw):
        own = int(torch.argmax(logits))
        if not forced:
            return torch.tensor(own)
        tok = forced.pop(0)
        if own != tok:
            gaps.append(float(logits[own] - logits[tok]))
        return torch.tensor(tok)
    return sample


@pytest.mark.parametrize("case", sorted(CASES))
def test_body_matches_jax(servers, case, monkeypatch):
    """Equal bodies. Where a step-path stream parts from the JAX one, the
    parting is proven a rounding flip: teacher-forced with the JAX tokens
    the port gives the JAX body, and at each step its own argmax differs
    from the forced token its logits hold the two within JIT_LOGITS_ATOL
    (XLA's jitted steps move this fixture's logits by ~0.05)."""
    route, body = CASES[case]
    raw = body.get("stream", False)
    want = _post(servers["jax"] + route, body, raw=raw)
    got = _post(servers["port"] + route, body, raw=raw)
    if raw:
        want, got = _events(want), _events(got)
        assert got[-1]["choices"][0]["finish_reason"] == "stop"
    if _norm(got) != _norm(want) and case in STEP_PATH:
        gaps = []
        monkeypatch.setattr(slots_mod, "sample",
                            _teacher(list(servers["jax_outs"][-1]), gaps))
        got = _post(servers["port"] + route, body)
        assert gaps and len(gaps) <= 3 and max(gaps) <= JIT_LOGITS_ATOL, gaps
    assert _norm(got) == _norm(want)
    if case == "json_schema":
        doc = json.loads(got["choices"][0]["message"]["content"])
        assert set(doc) == {"ok", "c"} and isinstance(doc["ok"], bool)
    if case == "tool_call":
        choice = got["choices"][0]
        assert choice["finish_reason"] == "tool_calls"
        call = choice["message"]["tool_calls"][0]["function"]
        assert call["name"] == "get_weather"
        assert len(json.loads(call["arguments"])["city"]) <= 4


def test_n_probs_matches_jax(servers):
    """The step path's n_probs: tokens and top ids equal; logprobs within
    JIT_LOGITS_ATOL of the JAX server's jitted steps (test_torch_slots.py
    holds the same step path to 2e-2 against the op-by-op run,
    which costs ~15 s of compiling a shape here)."""
    body = {"prompt": "hi", "n_predict": 3, "n_probs": 4, "temperature": 0.0}
    want = _post(servers["jax"] + "/completion", body)
    got = _post(servers["port"] + "/completion", body)
    assert got["content"] == want["content"]
    assert got["tokens_predicted"] == want["tokens_predicted"] == 3
    gp, wp = got["completion_probabilities"], want["completion_probabilities"]
    strip = [[{k: v for k, v in t.items() if k != "logprob"}
              for t in p["top_logprobs"]] for p in gp]
    assert strip == [[{k: v for k, v in t.items() if k != "logprob"}
                      for t in p["top_logprobs"]] for p in wp]
    assert [(p["id"], p["token"]) for p in gp] == [(p["id"], p["token"]) for p in wp]
    d = max(abs(a["logprob"] - b["logprob"]) for p, q in zip(gp, wp)
            for a, b in zip(p["top_logprobs"], q["top_logprobs"]))
    assert d <= JIT_LOGITS_ATOL, d


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    return cos >= 0.999 and float(np.abs(a - b).max()) <= 2e-2, cos


def test_embeddings_match_jax(servers):
    body = {"input": ["hello", "world of text"]}
    want = _post(servers["jax"] + "/v1/embeddings", body)
    got = _post(servers["port"] + "/v1/embeddings", body)
    assert got["object"] == "list" and len(got["data"]) == 2
    for g, w in zip(got["data"], want["data"]):
        v = np.asarray(g["embedding"])
        assert v.shape == (64,) and abs(np.linalg.norm(v) - 1.0) < 1e-4
        ok, cos = _close(v, w["embedding"])
        assert ok, cos
    legacy = _post(servers["port"] + "/embedding", {"content": "hello"})
    np.testing.assert_allclose(legacy[0]["embedding"][0],
                               got["data"][0]["embedding"], atol=1e-6)
    # the scratch sequence leaves no cell behind
    assert servers["state"].ctx.n_past.get(tmain.SCRATCH_SEQ) is None


def test_rerank_with_rank_head_matches_jax(tmp_path):
    """A file with cls/cls.output tensors: the port loads the rank head
    dense, scores [BOS]q[EOS]doc[EOS] through it as omni_tpu does, and
    /v1/rerank ranks by it."""
    rng = np.random.default_rng(4)
    d = 64
    path = tmp_path / "rank.gguf"
    write_tiny_qwen3(path, **TINY, extra_tensors={
        "cls.weight": rng.standard_normal((d, d)).astype(np.float32) * 0.1,
        "cls.bias": rng.standard_normal(d).astype(np.float32) * 0.1,
        "cls.output.weight": rng.standard_normal((1, d)).astype(np.float32) * 0.1,
        "cls.output.bias": rng.standard_normal(1).astype(np.float32) * 0.1})
    jctx, jtok, tctx, tok = _load(path, n_ctx=256)
    assert tctx.params["cls"].dtype == torch.bfloat16
    assert tctx.params["cls_b"].dtype == torch.float32
    jstate = jmain.ServerState(jctx, jtok, n_slots=1)
    tstate = tmain.ServerState(tctx, tok, n_slots=1)
    docs = ["doc one", "a different doc"]
    want = [jstate.rank_score("hello", s) for s in docs]
    got = [tstate.rank_score("hello", s) for s in docs]
    assert np.abs(np.subtract(got, want)).max() <= 2e-2, (got, want)
    httpd, t, url = _start(tmain, tstate)
    try:
        out = _post(url + "/v1/rerank", {"query": "hello", "documents": docs})
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
    scores = {r["index"]: r["relevance_score"] for r in out["results"]}
    np.testing.assert_allclose([scores[0], scores[1]], got, rtol=1e-6)


# ---- the port alone --------------------------------------------------------

def test_route_contract(servers):
    url = servers["port"]
    assert json.loads(_get(url + "/health")) == {"status": "ok"}
    assert json.loads(_get(url + "/v1/health"))["status"] == "ok"
    assert json.loads(_get(url + "/v1/models"))["data"][0]["id"] == "omni-tpu"
    assert json.loads(_get(url + "/api/tags"))["models"][0]["name"] == "omni-tpu"
    assert json.loads(_get(url + "/props")) == {"model": "omni-tpu", "n_ctx": 1024,
                                                "n_slots": 2}
    slots = json.loads(_get(url + "/slots"))
    assert len(slots) == 2 and {s["state"] for s in slots} == {"IDLE"}
    assert json.loads(_get(url + "/lora-adapters")) == []
    assert _post(url + "/lora-adapters", [{"id": 0, "scale": 0.5}]) == {"success": True}
    r = _post(url + "/tokenize", {"content": "hello world"})
    assert _post(url + "/detokenize", {"tokens": r["tokens"]})["content"] == "hello world"
    events = _events(_post(url + "/v1/completions", {
        "prompt": "hi", "n_predict": 4, "stream": True, "temperature": 0.0}, raw=True))
    assert len(events) == 4 and events[-1]["stop"] is True
    assert not any(e["stop"] for e in events[:-1])
    out = _post(url + "/apply-template", {"messages": [{"role": "user", "content": "hi"}]})
    assert out["prompt"].startswith("<|im_start|>user\nhi<|im_end|>")
    for alias in ("/api/chat", "/chat/completions"):
        r = _post(url + alias, {"messages": [{"role": "user", "content": "hi"}],
                                "max_tokens": 4, "temperature": 0.0})
        assert r["choices"][0]["message"]["role"] == "assistant"
    assert "model_info" in _post(url + "/api/show", {})
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/nope", {})
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:  # past the slot budget
        _post(url + "/completion", {"prompt": "x" * 600, "n_predict": 2})
    assert e.value.code == 400
    text = _get(url + "/metrics")
    assert "omni_tpu_requests_total" in text and "omni_tpu_kv_cells_total 1024" in text


def test_parallel_requests(servers):
    """Two plain requests at once (the fused path, interleaved by chunk) and
    two n_probs requests at once (one mixed ubatch a step): each equals
    itself served alone."""
    url = servers["port"]
    for extra in ({}, {"n_probs": 2}):
        body = {"prompt": "abc", "n_predict": 20, "temperature": 0.0, **extra}
        alone = _post(url + "/completion", body)
        results = [None, None]

        def hit(i):
            results[i] = _post(url + "/completion", body)

        ts = [threading.Thread(target=hit, args=(i,)) for i in range(2)]
        [t.start() for t in ts]
        [t.join(timeout=300) for t in ts]
        for r in results:
            assert r["content"] == alone["content"]
            if extra:
                assert ([p["id"] for p in r["completion_probabilities"]]
                        == [p["id"] for p in alone["completion_probabilities"]])


def test_api_key_gate(servers):
    key = "sk-secret"
    tctx = servers["state"].ctx
    state = tmain.ServerState(Context(tctx.cfg, tctx.params, tq.forward, tq.embed,
                                      n_ctx=128, device="cpu"),
                              servers["state"].tok, n_slots=1, api_key=key)
    httpd, t, url = _start(tmain, state)
    try:
        for ep in ("/health", "/v1/models"):
            assert "error" not in json.loads(_get(url + ep))
        for bad in (None, "wrong"):
            hdr = {"Authorization": f"Bearer {bad}"} if bad else {}
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url + "/completion", {"prompt": "ab", "n_predict": 2}, headers=hdr)
            assert e.value.code == 401
            assert json.loads(e.value.read())["error"]["type"] == "authentication_error"
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(url + "/props")
        assert e.value.code == 401
        out = _post(url + "/completion", {"prompt": "ab", "n_predict": 2,
                                          "temperature": 0.0},
                    headers={"Authorization": f"Bearer {key}"})
        assert out["tokens_predicted"] == 2
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def test_slot_save_restore_erase(servers):
    url, state = servers["port"], servers["state"]
    _post(url + "/completion", {"prompt": "hello", "n_predict": 4, "temperature": 0.0})
    before = state.ctx.seq_state_bytes(0)
    out = _post(url + "/slots/0?action=save", {"filename": "slot0.bin"})
    assert out["n_saved"] == len(before) and (servers["dir"] / "slots" / "slot0.bin").exists()
    assert _post(url + "/slots/0?action=erase", {})["erased"]
    assert state.ctx.n_past.get(0) is None
    out = _post(url + "/slots/0?action=restore", {"filename": "slot0.bin"})
    assert out["n_restored"] > 0
    assert state.ctx.seq_state_bytes(0) == before
    assert json.loads(_get(url + "/slots"))[0]["n_past"] == state.ctx.n_past[0]
    bad = [("/slots/9?action=save", {}), ("/slots/0?action=restore", {"filename": "none.bin"}),
           ("/slots/0?action=bogus", {})] + [
        ("/slots/0?action=save", {"filename": f}) for f in
        ("../evil.bin", "/tmp/evil.bin", "a/b.bin", ".hidden", "a\\b")]
    for route, body in bad:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + route, body)
        assert e.value.code == 400, route
    assert not (servers["dir"] / "evil.bin").exists()


def test_text_only_stream_session(servers):
    """/v1/stream/*: omni_init without a model_dir shares the server's
    Context and its lock; a prefill (session init), a decode SSE that ends
    with stop, break, update_session_config and reset."""
    url, state = servers["port"], servers["state"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/v1/stream/decode", {})
    assert e.value.code == 400 or state.omni is not None
    assert _post(url + "/v1/stream/omni_init", {"media_type": 1})["success"] is True
    assert state.omni.llama_mtx is state.sched_lock
    r = _post(url + "/v1/stream/update_session_config",
              {"max_preserved_context": 256, "max_new_tokens": 8, "highImage": True})
    assert r["success"] and r["highImage"] is True and state.omni.cfg.max_new_tokens == 8
    assert _post(url + "/v1/stream/prefill", {"cnt": 0, "system_prompt": "Be brief."}) == {
        "success": True, "cnt": 0}
    assert state.omni.n_keep > 0
    raw = _post(url + "/v1/stream/decode", {"round_idx": 0}, raw=True)
    events = _events(raw)
    assert events[-1]["stop"] is True and b"data: [DONE]" in raw
    assert len(state.omni.rounds) == 1
    assert _post(url + "/v1/stream/break", {}) == {"success": True}
    assert _post(url + "/v1/stream/reset", {}) == {"success": True}
    assert state.ctx.cells_used == 0 and not state.omni.rounds
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/v1/stream/bogus", {})
    assert e.value.code == 404
    state.omni.shutdown()
    state.omni = None


def test_family_fallback_without_jinja2(servers, monkeypatch, capsys):
    """Without jinja2 (the card's machine) a GGUF template renders through
    the family renderer its markers name, and the fallback is logged once."""
    import sys

    from omni_tpu_torch import chat

    monkeypatch.setitem(sys.modules, "jinja2", None)
    s = servers["state"]
    state = tmain.ServerState(s.ctx, s.tok, n_slots=1,
                              chat_template="{{ bos_token }}<|start_header_id|>"
                                            "x<|eot_id|>")
    msgs = [{"role": "system", "content": "s"}, {"role": "user", "content": "u"}]
    for _ in range(2):
        p, fmt = state.render_prompt(msgs)
        assert p == chat.apply_chat_template("llama3", msgs, True) and fmt == "generic"
    assert capsys.readouterr().err.count("jinja2 is not installed") == 1
    state2 = tmain.ServerState(s.ctx, s.tok, n_slots=1,
                               chat_template="{{ x }}<|im_start|>")
    assert state2.render_prompt(msgs) == (None, "generic")  # chatml: the caller's


def test_main_serves_on_the_cpu(servers):
    """`main --device cpu` loads the file into a Context of the asked pool
    and hands it to `serve` (stubbed: no socket)."""
    seen = {}

    class Stub:
        def serve_forever(self):
            pass

    def fake_serve(state, host, port):
        seen.update(state=state, host=host, port=port)
        return Stub()

    with mock.patch.object(tmain, "serve", fake_serve):
        tmain.main(["-m", str(servers["path"]), "--device", "cpu", "-c", "256",
                    "-np", "3", "--cache-type-k", "q8_0", "--port", "0",
                    "--api-key", "k"])
    st = seen["state"]
    assert st.ctx.device.type == "cpu" and st.ctx.cache.quantized
    assert st.ctx.n_ctx == 256 and len(st.sched.slots) == 3 and st.api_key == "k"


@pytest.mark.parametrize("argv,item", [
    (["--draft", "d.gguf"], "item 9"), (["--lora", "a.gguf"], "item 9"),
    (["--mmproj", "p.gguf"], "item 10"), (["--warmup"], "item 11"),
    ("bert", "item 10"), ("gemma-embedding", "item 10"), ("mamba", "item 10"),
    ("rwkv7", "item 10")])
def test_unported_refused_by_name(servers, tmp_path, argv, item):
    path = servers["path"]
    if isinstance(argv, str):  # an architecture the server does not serve
        path = tmp_path / f"{argv}.gguf"
        write_tiny_qwen3(path, **TINY, arch=argv)
        argv = []
    with pytest.raises(NotImplementedError, match=item):
        tmain.main(["-m", str(path), "--device", "cpu", *argv])


def test_fifo_lock_hands_over_in_arrival_order():
    """The server's lock is re-entrant and goes to the longest waiter: a
    thread that releases it and asks again queues behind the others (so a
    request's step loop cannot starve another request's launch)."""
    lock = tmain.FifoRLock()
    order, ready = [], threading.Event()

    def waiter(i):
        ready.wait()
        with lock:
            order.append(i)

    with lock:
        with lock:  # re-entrant
            ts = [threading.Thread(target=waiter, args=(i,)) for i in range(3)]
            for i, th in enumerate(ts):
                th.start()
                ready.set()
                while len(lock._queue) < i + 1:
                    threading.Event().wait(0.001)
    with lock:  # released, then asked for again: behind the three
        order.append("again")
    for th in ts:
        th.join(timeout=10)
    assert order == [0, 1, 2, "again"]
    with pytest.raises(RuntimeError):
        lock.release()


def test_fifo_lock_under_contention():
    """More threads than cores, a short switch interval: every
    read-modify-write under the lock lands (none lost), nested entries
    included, and every thread ends."""
    import os
    import sys

    lock, box = tmain.FifoRLock(), {"n": 0}
    n_threads, n_iters = len(os.sched_getaffinity(0)) + 4, 30

    def work():
        for _ in range(n_iters):
            with lock:
                with lock:
                    v = box["n"]
                    threading.Event().wait(0)
                    box["n"] = v + 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ts)
    assert box["n"] == n_threads * n_iters
