"""Model-native chat output parsing + Jinja chat templating (the port's
copy of omni_tpu/chat_parser.py). `jinja2` is imported inside
`apply_jinja_template` only: a machine without it imports this module, and
the server falls back to the family renderers of `chat.py`.

Counterpart of the reference's common/chat.cpp + common/chat-parser.cpp
(minja engine + per-format tool-call parsers): GGUF chat templates render
through real Jinja (jinja2 plays the vendored minja's role), the template
string identifies the model's native tool-call FORMAT, and responses parse
into {content, reasoning_content, tool_calls} per that format's syntax —
the model emits its own calling convention, no grammar forcing required.

Formats (marker syntax per common/chat.cpp):
- hermes      : <tool_call>{"name":…,"arguments":{…}}</tool_call>  (also
                Qwen2/3; chat.cpp:2142-2249)
- mistral_nemo: [TOOL_CALLS][{"name":…,"arguments":{…},"id":…}, …]
                (chat.cpp:978-1065)
- magistral   : [THINK]…[/THINK] reasoning + mistral_nemo calls
                (chat.cpp:1057-1065)
- llama_3_x   : {"name":…,"parameters":{…}} bare JSON, or the builtin
                <|python_tag|>name.call(k=v,…) form (chat.cpp:1201-1267)
- deepseek_r1 : <｜tool▁calls▁begin｜><｜tool▁call▁begin｜>function<｜tool▁sep｜>
                NAME\n```json\nARGS\n```<｜tool▁call▁end｜>… (chat.cpp:1509-1596)
                (DeepSeek V3.1 uses the same call-block syntax)
- functionary_v3_2: >>>NAME\nARGS_JSON (chat.cpp)
- functionary_v3_1: <function=NAME>{ARGS}</function>, <|python_tag|>CODE
                (chat.cpp:1994-2065)
- firefunction_v2: " functools[{"name":…,"arguments":{…}},…]"
                (chat.cpp:1952-1991)
- command_r7b : <|START_THINKING|>…<|END_THINKING|> reasoning,
                <|START_ACTION|>[{tool_name, tool_call_id, parameters}]
                <|END_ACTION|>, <|START_RESPONSE|>…<|END_RESPONSE|>
                (chat.cpp:1149-1179)
- granite     : <think>…</think>, <response>…</response>,
                <|tool_call|>[{name, arguments}] (chat.cpp:2397-2441)
- nemotron_v2 : <think>…</think> + <TOOLCALL>[{name, arguments}]</TOOLCALL>
                (chat.cpp:2444-2499)
- seed_oss    : <seed:think>…</seed:think> +
                <seed:tool_call><function=NAME><parameter=K>V</parameter>…
                </function></seed:tool_call> (chat.cpp:2502-2560)
- gpt_oss     : harmony channels — header…<|message|>body<|end|> segments;
                analysis→reasoning, final→content, "to=functions.NAME"
                header→tool call (chat.cpp:1817-1905)
- apertus     : <|inner_prefix|>…<|inner_suffix|> reasoning +
                <|tools_prefix|>[{"NAME": {args}}, …]<|tools_suffix|>
                single-key short-form calls (chat.cpp:2471-2500)
- generic     : one JSON object {"name":…,"arguments":{…}} or
                {"tool_calls":[…]} (the grammar-forced fallback)
- content_only: no tool syntax.

Reasoning blocks (<think>…</think>) split off for every format
(common_chat_parser reasoning handling).
"""

from __future__ import annotations

import json
import re
import uuid


def detect_format(template: str | None) -> str:
    """Chat-template string -> native tool-call format (the detection
    heuristics of common_chat_templates_apply)."""
    if not template:
        return "content_only"
    if "<|START_ACTION|>" in template or "<|START_THINKING|>" in template:
        return "command_r7b"
    if "<seed:think>" in template or "<seed:tool_call>" in template:
        return "seed_oss"
    if "<|channel|>" in template:
        return "gpt_oss"
    if "<TOOLCALL>" in template:
        return "nemotron_v2"
    if " functools[" in template or "functools[" in template:
        return "firefunction_v2"
    if "<|tool_call|>" in template:
        return "granite"
    if "<tool_call>" in template:
        return "hermes"
    if "[THINK]" in template and "[/THINK]" in template:
        return "magistral"
    if "[TOOL_CALLS]" in template:
        return "mistral_nemo"
    if "tool▁calls▁begin" in template or "tool_calls_begin" in template:
        return "deepseek_r1"
    if ">>>all" in template:
        return "functionary_v3_2"
    if "<function=" in template:
        return "functionary_v3_1"
    if "<|tools_prefix|>" in template or "<|inner_prefix|>" in template:
        return "apertus"
    if "<|python_tag|>" in template or "ipython" in template:
        return "llama_3_x"
    return "generic"


def _mk_call(name: str, arguments) -> dict:
    if not isinstance(arguments, str):
        arguments = json.dumps(arguments)
    return {"id": f"call_{uuid.uuid4().hex[:12]}", "type": "function",
            "function": {"name": name, "arguments": arguments}}


def _try_json(s: str):
    try:
        return json.loads(s)
    except Exception:  # noqa: BLE001
        return None


def _try_json_prefix(s: str):
    """Parse a leading JSON value, tolerating trailing text (a stop-token
    race can leave content after the call payload). Returns (value, rest)."""
    try:
        val, end = json.JSONDecoder().raw_decode(s)
        return val, s[end:]
    except Exception:  # noqa: BLE001
        return None, s


def _parse_mistral_calls(text: str) -> tuple[list[dict], str]:
    """[TOOL_CALLS] JSON-array syntax -> (calls, remaining content)."""
    calls: list[dict] = []
    at = text.find("[TOOL_CALLS]")
    if at == -1:
        return calls, text
    arr, rest = _try_json_prefix(text[at + len("[TOOL_CALLS]"):].strip())
    if isinstance(arr, dict):
        arr = [arr]
    for obj in arr or []:
        if isinstance(obj, dict) and "name" in obj:
            calls.append(_mk_call(obj["name"], obj.get("arguments", {})))
    return calls, ((text[:at] + rest).strip() if calls else text)


def _coerce_param(v: str):
    """seed_oss <parameter> values: JSON if it parses, else raw string."""
    j = _try_json(v.strip())
    return j if j is not None else v.strip()


_THINK_RE = re.compile(r"<think>(.*?)</think>\s*", re.S)
_HERMES_RE = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.S)
_DSR1_CALL_RE = re.compile(
    r"<｜tool▁call▁begin｜>(?:function)?(?:<｜tool▁sep｜>)?"
    r"\s*([\w.\-]+)\s*\n```json\n(.*?)\n```\s*<｜tool▁call▁end｜>", re.S)
_PYTAG_RE = re.compile(r"<\|python_tag\|>([\w.\-]+)\.call\((.*)\)\s*$", re.S)
_FUNCTIONARY_RE = re.compile(r">>>([\w.\-]+)\n(\{.*?\})(?=\s*>>>|\s*$)", re.S)


def parse_response(text: str, fmt: str = "generic") -> dict:
    """-> {"content", "reasoning_content", "tool_calls"} (the
    common_chat_msg contract)."""
    reasoning = None
    m = _THINK_RE.search(text)
    if m:
        reasoning = m.group(1).strip()
        text = _THINK_RE.sub("", text, count=1)

    calls: list[dict] = []
    content = text

    if fmt == "hermes":
        for m in _HERMES_RE.finditer(text):
            obj = _try_json(m.group(1))
            if obj and "name" in obj:
                calls.append(_mk_call(obj["name"],
                                      obj.get("arguments", obj.get("parameters", {}))))
        content = _HERMES_RE.sub("", text).strip()
    elif fmt == "mistral_nemo":
        calls, content = _parse_mistral_calls(text)
    elif fmt == "magistral":
        m = re.search(r"\[THINK\](.*?)\[/THINK\]\s*", text, re.S)
        if m:
            reasoning = m.group(1).strip()
            text = text[:m.start()] + text[m.end():]
        calls, content = _parse_mistral_calls(text)
    elif fmt == "deepseek_r1":
        for m in _DSR1_CALL_RE.finditer(text):
            args = _try_json(m.group(2))
            calls.append(_mk_call(m.group(1), args if args is not None
                                  else m.group(2)))
        if calls:
            content = text[: text.find("<｜tool▁calls▁begin｜>")
                           if "<｜tool▁calls▁begin｜>" in text else
                           text.find("<｜tool▁call▁begin｜>")].strip()
    elif fmt == "apertus":
        # <|inner_prefix|>…<|inner_suffix|> reasoning,
        # <|tools_prefix|>[{"tool_name": {args}}, …]<|tools_suffix|>
        # (chat.cpp:2471-2500 common_chat_parse_apertus; calls use the
        # single-key "short form" of chat-parser.cpp:82)
        m = re.search(r"<\|inner_prefix\|>(.*?)<\|inner_suffix\|>\s*",
                      text, re.S)
        if m:
            reasoning = m.group(1).strip()
            text = text[:m.start()] + text[m.end():]
        at = text.find("<|tools_prefix|>")
        if at != -1:
            arr, rest = _try_json_prefix(
                text[at + len("<|tools_prefix|>"):].strip())
            if isinstance(arr, list):
                for obj in arr:
                    if isinstance(obj, dict) and len(obj) == 1:
                        name, args = next(iter(obj.items()))
                        calls.append(_mk_call(name, args))
            rest = rest.strip()
            if rest.startswith("<|tools_suffix|>"):
                rest = rest[len("<|tools_suffix|>"):]
            content = (text[:at] + rest).strip() if calls else text.strip()
        else:
            content = text.strip()
    elif fmt == "llama_3_x":
        m = _PYTAG_RE.search(text)
        if m:  # builtin-tool python-call syntax
            kwargs = {}
            for kv in re.findall(r"([\w]+)\s*=\s*(\"[^\"]*\"|[^,]+)",
                                 m.group(2)):
                v = _try_json(kv[1])
                kwargs[kv[0]] = v if v is not None else kv[1].strip('"')
            calls.append(_mk_call(m.group(1), kwargs))
            content = text[: m.start()].strip()
        else:
            obj = _try_json(text.strip())
            if isinstance(obj, dict) and "name" in obj and (
                    "parameters" in obj or "arguments" in obj):
                calls.append(_mk_call(
                    obj["name"], obj.get("parameters",
                                         obj.get("arguments", {}))))
                content = ""
    elif fmt == "functionary_v3_2":
        for m in _FUNCTIONARY_RE.finditer(text):
            if m.group(1) == "all":
                continue
            args = _try_json(m.group(2))
            if args is not None:
                calls.append(_mk_call(m.group(1), args))
        if calls:
            content = text[: text.find(">>>")].strip()
    elif fmt == "command_r7b":
        m = re.search(r"<\|START_THINKING\|>(.*?)<\|END_THINKING\|>\s*",
                      text, re.S)
        if m:
            reasoning = m.group(1).strip()
            text = text[:m.start()] + text[m.end():]
        m = re.search(r"<\|START_ACTION\|>(.*?)(?:<\|END_ACTION\|>|$)",
                      text, re.S)
        if m:
            for obj in _try_json(m.group(1)) or []:
                if isinstance(obj, dict):
                    calls.append(_mk_call(obj.get("tool_name", ""),
                                          obj.get("parameters", {})))
            content = (text[:m.start()] + text[m.end():]).strip()
        else:
            r = re.search(r"<\|START_RESPONSE\|>(.*?)(?:<\|END_RESPONSE\|>|$)",
                          text, re.S)
            content = r.group(1).strip() if r else text.strip()
    elif fmt == "granite":
        r = re.search(r"<response>(.*?)(?:</response>|$)", text, re.S)
        resp = r.group(1).strip() if r else None
        mt = re.search(r"<\|tool_call\|>\s*(\[.*)", text, re.S)
        if mt:
            arr, _ = _try_json_prefix(mt.group(1))
            for obj in arr or []:
                if isinstance(obj, dict) and "name" in obj:
                    calls.append(_mk_call(obj["name"],
                                          obj.get("arguments", {})))
            content = resp if resp is not None else text[:mt.start()].strip()
        else:
            content = resp if resp is not None else text.strip()
    elif fmt == "nemotron_v2":
        m = re.search(r"<TOOLCALL>(.*?)(?:</TOOLCALL>|$)", text, re.S)
        if m:
            for obj in _try_json(m.group(1)) or []:
                if isinstance(obj, dict) and "name" in obj:
                    calls.append(_mk_call(obj["name"],
                                          obj.get("arguments", {})))
            content = (text[:m.start()] + text[m.end():]).strip()
    elif fmt == "seed_oss":
        m = re.search(r"<seed:think>(.*?)</seed:think>\s*", text, re.S)
        if m:
            reasoning = m.group(1).strip()
            text = text[:m.start()] + text[m.end():]
        for tc in re.finditer(r"<seed:tool_call>(.*?)</seed:tool_call>",
                              text, re.S):
            fm = re.search(r"<function=([^>]+)>(.*?)(?:</function>|$)",
                           tc.group(1), re.S)
            if fm:
                args = {k: _coerce_param(v) for k, v in re.findall(
                    r"<parameter=([^>]+)>(.*?)</parameter>",
                    fm.group(2), re.S)}
                calls.append(_mk_call(fm.group(1), args))
        content = re.sub(r"<seed:tool_call>.*?</seed:tool_call>", "",
                         text, flags=re.S).strip()
    elif fmt == "firefunction_v2":
        at = text.find("functools[")
        if at != -1:
            arr, rest = _try_json_prefix(text[at + len("functools"):])
            for obj in arr or []:
                if isinstance(obj, dict) and "name" in obj:
                    calls.append(_mk_call(obj["name"],
                                          obj.get("arguments", {})))
            if calls:
                content = (text[:at].rstrip() + rest).strip()
    elif fmt == "functionary_v3_1":
        for m in re.finditer(r"<function=([^>]+)>\s*(\{.*?\})\s*</function>",
                             text, re.S):
            args = _try_json(m.group(2))
            if args is not None:
                calls.append(_mk_call(m.group(1), args))
        text2 = re.sub(r"<function=[^>]+>\s*\{.*?\}\s*</function>", "",
                       text, flags=re.S)
        m = re.search(r"<\|python_tag\|>(.*)$", text2, re.S)
        if m:  # builtin code-interpreter call (chat.cpp:2046-2059)
            calls.append(_mk_call("python", {"code": m.group(1).strip()}))
            text2 = text2[: m.start()]
        content = text2.strip()
    elif fmt == "gpt_oss":
        if "<|message|>" not in text:
            content = text.strip()
        else:
            reasoning_parts: list[str] = []
            content_parts: list[str] = []
            # harmony segments: header<|message|>body, terminated by
            # <|end|> / the next <|start|>assistant / end-of-text
            for m in re.finditer(
                    r"(?:^|<\|start\|>assistant)(?P<hdr>.*?)<\|message\|>"
                    r"(?P<body>.*?)(?=<\|end\|>|<\|start\|>|$)", text, re.S):
                hdr, body = m.group("hdr"), m.group("body")
                fn = re.search(r"to=functions\.([^<\s]+)", hdr)
                if fn:
                    args = _try_json(body.strip())
                    calls.append(_mk_call(fn.group(1),
                                          args if args is not None
                                          else body.strip()))
                elif "<|channel|>analysis" in hdr:
                    reasoning_parts.append(body.strip())
                else:  # final / commentary preamble
                    content_parts.append(body.strip())
            if reasoning_parts:
                reasoning = "\n".join(reasoning_parts)
            content = "\n".join(p for p in content_parts if p)
    elif fmt == "generic":
        obj = _try_json(text.strip())
        if isinstance(obj, dict):
            if "tool_calls" in obj:
                for c in obj["tool_calls"]:
                    if "name" in c:
                        calls.append(_mk_call(c["name"],
                                              c.get("arguments", {})))
                content = str(obj.get("response", ""))
            elif "name" in obj and "arguments" in obj:
                calls.append(_mk_call(obj["name"], obj["arguments"]))
                content = ""

    return {"content": content, "reasoning_content": reasoning,
            "tool_calls": calls}


# ---------------------------------------------------------------------------
# Jinja chat templating (minja role)
# ---------------------------------------------------------------------------

def apply_jinja_template(template: str, messages: list[dict],
                         tools: list[dict] | None = None,
                         add_generation_prompt: bool = True,
                         bos_token: str = "", eos_token: str = "",
                         **extra) -> str:
    """Render a GGUF `tokenizer.chat_template` with jinja2 under the HF
    chat-template conventions (the reference renders these with vendored
    minja, common/chat.cpp common_chat_templates_apply)."""
    import datetime

    import jinja2

    env = jinja2.Environment(
        trim_blocks=True, lstrip_blocks=True,
        undefined=jinja2.ChainableUndefined,
    )

    def raise_exception(msg):
        raise jinja2.TemplateError(msg)

    def strftime_now(fmt):
        return datetime.datetime.now().strftime(fmt)

    env.globals.update(raise_exception=raise_exception,
                       strftime_now=strftime_now)
    env.filters["tojson"] = lambda x, **kw: json.dumps(x, **kw)
    return env.from_string(template).render(
        messages=messages, tools=tools or None,
        add_generation_prompt=add_generation_prompt,
        bos_token=bos_token, eos_token=eos_token, **extra)
