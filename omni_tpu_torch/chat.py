"""Chat templates per model family (the port's copy of omni_tpu/chat.py,
itself the counterpart of llama.cpp's src/llama-chat.cpp:
llm_chat_apply_template + llm_chat_detect_template): a registry of
hand-written renderers keyed by family name, and detection of the family
from a GGUF `tokenizer.chat_template` Jinja string by its markers, with
llama.cpp's precedence (no Jinja engine here). Every family renders byte
for byte as the JAX package's does.

Messages are [{"role": "system"|"user"|"assistant", "content": str}, ...].
"""

from __future__ import annotations

from typing import Callable

Renderer = Callable[[list[dict], bool], str]
_REGISTRY: dict[str, Renderer] = {}


def register(name: str):
    def deco(fn: Renderer) -> Renderer:
        _REGISTRY[name] = fn
        return fn
    return deco


def known_templates() -> list[str]:
    return sorted(_REGISTRY)


def apply_chat_template(template: str, messages: list[dict],
                        add_assistant: bool = True) -> str:
    """Render `messages` with a named family template, or auto-detect the
    family from a raw Jinja template string (llama_chat_apply_template)."""
    name = template if template in _REGISTRY else detect_template(template)
    if name is None:
        raise ValueError(f"unknown chat template {template[:80]!r}")
    return _REGISTRY[name](messages, add_assistant)


def detect_template(jinja: str) -> str | None:
    """Map a Jinja chat-template string to a family — same marker
    heuristics, same precedence, as llm_chat_detect_template
    (src/llama-chat.cpp:80-240)."""
    has = lambda s: s in jinja
    if has("<|im_start|>"):
        if has("<|im_sep|>"):
            return "phi4"
        if has("<end_of_utterance>"):
            return "smolvlm"
        return "chatml"
    if jinja.startswith("mistral") or has("[INST]"):
        # mistral/llama2 family precedence (llama-chat.cpp:101-135)
        if has("[SYSTEM_PROMPT]"):
            return "mistral-v7"
        if "' [INST] ' + system_message" in jinja or has("[AVAILABLE_TOOLS]"):
            if has(" [INST]"):
                return "mistral-v1"
            if has('"[INST]"'):
                return "mistral-v3-tekken"
            return "mistral-v3"
        if has("content.strip()"):
            return "llama2-sys-strip"
        if has("bos_token + '[INST]"):
            return "llama2-sys-bos"
        if has("<<SYS>>"):
            return "llama2-sys"
        return "llama2"
    if has("<|assistant|>") and has("<|end|>"):
        return "phi3"
    if has("[gMASK]<sop>"):
        return "chatglm4"
    if has("<|assistant|>") and has("<|user|>"):
        return "falcon3" if has("</s>") else "glmedge"
    if has("<|user|>") and has("<|endoftext|>"):
        return "zephyr"
    if has("bos_token + message['role']"):
        return "monarch"
    if has("<start_of_turn>"):
        return "gemma"
    if has("'\\n\\nAssistant: ' + eos_token"):
        return "orion"
    if has("GPT4 Correct "):
        return "openchat"
    if has("USER: ") and has("ASSISTANT: "):
        return "vicuna-orca" if has("SYSTEM: ") else "vicuna"
    if has("### Instruction:") and has("<|EOT|>"):
        return "deepseek-coder"
    if has("<|START_OF_TURN_TOKEN|>"):
        return "command-r"
    if has("<|start_header_id|>") and has("<|eot_id|>"):
        return "llama3"
    if has("[gMASK]sop"):
        return "chatglm3"
    if has("<用户>"):
        return "minicpm"
    if has("'Assistant: ' + message['content'] + eos_token"):
        return "deepseek2"
    if has("<｜Assistant｜>") and has("<｜User｜>"):
        return "deepseek3"
    if has("[|system|]") and has("[|endofturn|]"):
        return "exaone4" if has("[|tool|]") else "exaone3"
    if has("rwkv-world") or has("'User: ' + message['content']"):
        return "rwkv-world"
    if has("<|start_of_role|>"):
        return "granite"
    if has("additional_special_tokens[0] + message['content']"
           " + additional_special_tokens[1]"):
        return "gigachat"
    if has("<|role_start|>"):
        return "megrez"
    if has(" Ассистент:"):
        return "yandex"
    if has("<role>ASSISTANT</role>"):
        return "bailing"
    if has("<|header_start|>") and has("<|header_end|>"):
        return "llama4"
    if has("<|endofuserprompt|>"):
        return "dots1"
    if has("<|extra_0|>") and has("<|extra_4|>"):
        return "hunyuan-moe"
    if has("<|start|>") and has("<|channel|>"):
        return "gpt-oss"
    if has("hy_Assistant") or has("hy_place▁holder▁no▁2"):
        return "hunyuan-dense"
    if has("<|im_middle|>") and has("<|im_assistant|>"):
        return "kimi-k2"
    if has("<seed:bos>"):
        return "seed-oss"
    if has("<|separator|>") and has("Human: "):
        return "grok2"
    if has("请") or (has("User: ") and has("Assistant: ")):
        return "deepseek"
    return None


def _system_and_turns(messages: list[dict]) -> tuple[str, list[dict]]:
    sys_txt = ""
    turns = []
    for m in messages:
        if m["role"] == "system":
            sys_txt = m["content"]
        else:
            turns.append(m)
    return sys_txt, turns


@register("chatml")
def _chatml(messages, add_assistant):
    out = "".join(
        f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n" for m in messages)
    if add_assistant:
        out += "<|im_start|>assistant\n"
    return out


def _llama2_family(messages, *, support_system: bool,
                   bos_inside_history: bool, strip: bool) -> str:
    """The llama2 template and its three variants (llama-chat.cpp:271-307):
    base ignores <<SYS>> wrapping, -sys wraps the system message, -sys-bos
    re-emits <s> before each history [INST], -sys-strip trims contents.
    The leading BOS is the tokenizer's job (skipped here, like the ref)."""
    out = "[INST] "
    inside = True
    for m in messages:
        content = m["content"].strip() if strip else m["content"]
        role = m["role"]
        if not inside:
            inside = True
            out += "<s>[INST] " if bos_inside_history else "[INST] "
        if role == "system":
            if support_system:
                out += f"<<SYS>>\n{content}\n<</SYS>>\n\n"
            else:
                out += content + "\n"
        elif role == "user":
            out += content + " [/INST]"
        else:
            out += content + "</s>"
            inside = False
    return out


@register("llama2")
def _llama2(messages, add_assistant):
    return _llama2_family(messages, support_system=False,
                          bos_inside_history=False, strip=False)


@register("llama2-sys")
def _llama2_sys(messages, add_assistant):
    return _llama2_family(messages, support_system=True,
                          bos_inside_history=False, strip=False)


@register("llama2-sys-bos")
def _llama2_sys_bos(messages, add_assistant):
    return _llama2_family(messages, support_system=True,
                          bos_inside_history=True, strip=False)


@register("llama2-sys-strip")
def _llama2_sys_strip(messages, add_assistant):
    return _llama2_family(messages, support_system=True,
                          bos_inside_history=False, strip=True)


@register("llama3")
def _llama3(messages, add_assistant):
    out = "<|begin_of_text|>"
    for m in messages:
        out += (f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
                f"{m['content']}<|eot_id|>")
    if add_assistant:
        out += "<|start_header_id|>assistant<|end_header_id|>\n\n"
    return out


@register("mistral")
def _mistral(messages, add_assistant):
    sys_txt, turns = _system_and_turns(messages)
    out = "<s>"
    first = True
    for m in turns:
        if m["role"] == "user":
            inner = m["content"]
            if first and sys_txt:
                inner = f"{sys_txt}\n\n{inner}"
            out += f"[INST] {inner} [/INST]"
            first = False
        else:
            out += f" {m['content']}</s>"
    return out


def _mistral_vx(messages, *, lead: str, trail: str, trim_asst: bool) -> str:
    """Official mistral v1/v3/v3-tekken templates (llama-chat.cpp:253-270):
    v1 puts a space before [INST] and before [/INST]; v3 trims the
    assistant message; tekken drops the post-[INST] space."""
    out = ""
    inside = False
    for m in messages:
        if not inside:
            out += f"{lead}[INST]{trail}"
            inside = True
        role, content = m["role"], m["content"]
        if role == "system":
            out += content + "\n\n"
        elif role == "user":
            out += content + lead + "[/INST]"
        else:
            out += trail + (content.strip() if trim_asst else content) + "</s>"
            inside = False
    return out


@register("mistral-v1")
def _mistral_v1(messages, add_assistant):
    return _mistral_vx(messages, lead=" ", trail=" ", trim_asst=False)


@register("mistral-v3")
def _mistral_v3(messages, add_assistant):
    return _mistral_vx(messages, lead="", trail=" ", trim_asst=True)


@register("mistral-v3-tekken")
def _mistral_v3_tekken(messages, add_assistant):
    return _mistral_vx(messages, lead="", trail="", trim_asst=False)


def _mistral_v7x(messages, trail: str) -> str:
    """Official mistral v7 / v7-tekken (llama-chat.cpp:239-252):
    [SYSTEM_PROMPT] sections, per-message [INST] wrapping; tekken drops
    the space after each opening marker."""
    out = ""
    for m in messages:
        role, content = m["role"], m["content"]
        if role == "system":
            out += f"[SYSTEM_PROMPT]{trail}{content}[/SYSTEM_PROMPT]"
        elif role == "user":
            out += f"[INST]{trail}{content}[/INST]"
        else:
            out += f"{trail}{content}</s>"
    return out


@register("mistral-v7")
def _mistral_v7(messages, add_assistant):
    return _mistral_v7x(messages, " ")


@register("mistral-v7-tekken")
def _mistral_v7_tekken(messages, add_assistant):
    return _mistral_v7x(messages, "")


@register("gemma")
def _gemma(messages, add_assistant):
    sys_txt, turns = _system_and_turns(messages)
    out = ""
    for i, m in enumerate(turns):
        role = "model" if m["role"] == "assistant" else "user"
        inner = m["content"]
        if i == 0 and sys_txt and role == "user":
            inner = f"{sys_txt}\n\n{inner}"
        out += f"<start_of_turn>{role}\n{inner}<end_of_turn>\n"
    if add_assistant:
        out += "<start_of_turn>model\n"
    return out


@register("phi3")
def _phi3(messages, add_assistant):
    out = "".join(f"<|{m['role']}|>\n{m['content']}<|end|>\n" for m in messages)
    if add_assistant:
        out += "<|assistant|>\n"
    return out


@register("zephyr")
def _zephyr(messages, add_assistant):
    out = "".join(f"<|{m['role']}|>\n{m['content']}</s>\n" for m in messages)
    if add_assistant:
        out += "<|assistant|>\n"
    return out


@register("vicuna")
def _vicuna(messages, add_assistant):
    sys_txt, turns = _system_and_turns(messages)
    out = f"{sys_txt}\n\n" if sys_txt else ""
    for m in turns:
        if m["role"] == "user":
            out += f"USER: {m['content']}\n"
        else:
            out += f"ASSISTANT: {m['content']}</s>\n"
    if add_assistant:
        out += "ASSISTANT:"
    return out


@register("deepseek")
def _deepseek(messages, add_assistant):
    sys_txt, turns = _system_and_turns(messages)
    out = sys_txt + "\n\n" if sys_txt else ""
    for m in turns:
        if m["role"] == "user":
            out += f"User: {m['content']}\n\n"
        else:
            out += f"Assistant: {m['content']}<｜end▁of▁sentence｜>"
    if add_assistant:
        out += "Assistant:"
    return out


@register("command-r")
def _command_r(messages, add_assistant):
    role_map = {"system": "SYSTEM", "user": "USER", "assistant": "CHATBOT"}
    out = ""
    for m in messages:
        out += (f"<|START_OF_TURN_TOKEN|><|{role_map[m['role']]}_TOKEN|>"
                f"{m['content']}<|END_OF_TURN_TOKEN|>")
    if add_assistant:
        out += "<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>"
    return out


@register("granite")
def _granite(messages, add_assistant):
    out = "".join(
        f"<|start_of_role|>{m['role']}<|end_of_role|>{m['content']}<|end_of_text|>\n"
        for m in messages)
    if add_assistant:
        out += "<|start_of_role|>assistant<|end_of_role|>"
    return out


@register("minicpm")
def _minicpm(messages, add_assistant):
    # MiniCPM-3B-OpenHermes form (llama-chat.cpp:529-541). MiniCPM-o's omni
    # pipeline uses ChatML prompts directly (tools/omni/omni.cpp:3518-3538)
    # and never routes through this renderer.
    out = ""
    for m in messages:
        if m["role"] == "user":
            out += f"<用户>{_trim(m['content'])}<AI>"
        else:
            out += _trim(m["content"])
    return out


@register("deepseek2")
def _deepseek2(messages, add_assistant):
    # DeepSeek-V2 (llama-chat.cpp:542-557): like "deepseek" but the
    # assistant turn has no blank-line separator after User
    out = ""
    for m in messages:
        if m["role"] == "system":
            out += f"{m['content']}\n\n"
        elif m["role"] == "user":
            out += f"User: {m['content']}\n\n"
        else:
            out += f"Assistant: {m['content']}<｜end▁of▁sentence｜>"
    if add_assistant:
        out += "Assistant:"
    return out


def _trim(s: str) -> str:
    return s.strip()


@register("phi4")
def _phi4(messages, add_assistant):
    out = "".join(
        f"<|im_start|>{m['role']}<|im_sep|>{m['content']}<|im_end|>"
        for m in messages)
    if add_assistant:
        out += "<|im_start|>assistant<|im_sep|>"
    return out


@register("falcon3")
def _falcon3(messages, add_assistant):
    out = "".join(f"<|{m['role']}|>\n{m['content']}\n" for m in messages)
    if add_assistant:
        out += "<|assistant|>\n"
    return out


@register("monarch")
def _monarch(messages, add_assistant):
    out = ""
    for i, m in enumerate(messages):
        bos = "" if i == 0 else "<s>"
        out += f"{bos}{m['role']}\n{m['content']}</s>\n"
    if add_assistant:
        out += "<s>assistant\n"
    return out


@register("orion")
def _orion(messages, add_assistant):
    sys_txt, turns = _system_and_turns(messages)
    out = ""
    for m in turns:
        if m["role"] == "user":
            out += "Human: "
            if sys_txt:
                out += f"{sys_txt}\n\n"
                sys_txt = ""
            out += f"{m['content']}\n\nAssistant: </s>"
        else:
            out += f"{m['content']}</s>"
    return out


@register("openchat")
def _openchat(messages, add_assistant):
    out = ""
    for m in messages:
        if m["role"] == "system":
            out += f"{m['content']}<|end_of_turn|>"
        else:
            out += (f"GPT4 Correct {m['role'].capitalize()}: "
                    f"{m['content']}<|end_of_turn|>")
    if add_assistant:
        out += "GPT4 Correct Assistant:"
    return out


@register("vicuna-orca")
def _vicuna_orca(messages, add_assistant):
    sys_txt, turns = _system_and_turns(messages)
    out = f"SYSTEM: {sys_txt}\n" if sys_txt else ""
    for m in turns:
        if m["role"] == "user":
            out += f"USER: {m['content']}\n"
        else:
            out += f"ASSISTANT: {m['content']}</s>\n"
    if add_assistant:
        out += "ASSISTANT:"
    return out


@register("deepseek-coder")
def _deepseek_coder(messages, add_assistant):
    out = ""
    for m in messages:
        if m["role"] == "system":
            out += m["content"]
        elif m["role"] == "user":
            out += f"### Instruction:\n{m['content']}\n"
        else:
            out += f"### Response:\n{m['content']}\n<|EOT|>\n"
    if add_assistant:
        out += "### Response:\n"
    return out


@register("deepseek3")
def _deepseek3(messages, add_assistant):
    out = ""
    for m in messages:
        if m["role"] == "system":
            out += f"{m['content']}\n\n"
        elif m["role"] == "user":
            out += f"<｜User｜>{m['content']}"
        else:
            out += f"<｜Assistant｜>{m['content']}<｜end▁of▁sentence｜>"
    if add_assistant:
        out += "<｜Assistant｜>"
    return out


@register("chatglm3")
def _chatglm3(messages, add_assistant):
    out = "[gMASK]sop"
    out += "".join(f"<|{m['role']}|>\n {m['content']}" for m in messages)
    if add_assistant:
        out += "<|assistant|>"
    return out


@register("chatglm4")
def _chatglm4(messages, add_assistant):
    out = "[gMASK]<sop>"
    out += "".join(f"<|{m['role']}|>\n{m['content']}" for m in messages)
    if add_assistant:
        out += "<|assistant|>\n"
    return out


@register("glmedge")
def _glmedge(messages, add_assistant):
    out = "".join(f"<|{m['role']}|>\n{m['content']}" for m in messages)
    if add_assistant:
        out += "<|assistant|>"
    return out


@register("exaone3")
def _exaone3(messages, add_assistant):
    out = ""
    for m in messages:
        if m["role"] == "system":
            out += f"[|system|]{_trim(m['content'])}[|endofturn|]\n"
        elif m["role"] == "user":
            out += f"[|user|]{_trim(m['content'])}\n"
        elif m["role"] == "assistant":
            out += f"[|assistant|]{_trim(m['content'])}[|endofturn|]\n"
    if add_assistant:
        out += "[|assistant|]"
    return out


@register("exaone4")
def _exaone4(messages, add_assistant):
    # exaone3 surface plus the [|tool|] role (llama-chat.cpp:584-601)
    out = ""
    for m in messages:
        if m["role"] == "system":
            out += f"[|system|]{_trim(m['content'])}[|endofturn|]\n"
        elif m["role"] == "user":
            out += f"[|user|]{_trim(m['content'])}\n"
        elif m["role"] == "assistant":
            out += f"[|assistant|]{_trim(m['content'])}[|endofturn|]\n"
        elif m["role"] == "tool":
            out += f"[|tool|]{_trim(m['content'])}[|endofturn|]\n"
    if add_assistant:
        out += "[|assistant|]"
    return out


@register("rwkv-world")
def _rwkv_world(messages, add_assistant):
    out = ""
    for i, m in enumerate(messages):
        if m["role"] == "system":
            out += f"System: {_trim(m['content'])}\n\n"
        elif m["role"] == "user":
            out += f"User: {_trim(m['content'])}\n\n"
            if i == len(messages) - 1:
                out += "Assistant:"
        else:
            out += f"Assistant: {_trim(m['content'])}\n\n"
    return out


@register("gigachat")
def _gigachat(messages, add_assistant):
    out = "<s>"
    turns = messages
    if messages and messages[0]["role"] == "system":
        out += f"{messages[0]['content']}<|message_sep|>"
        turns = messages[1:]
    for m in turns:
        if m["role"] == "user":
            out += (f"user<|role_sep|>{m['content']}<|message_sep|>"
                    "available functions<|role_sep|>[]<|message_sep|>")
        elif m["role"] == "assistant":
            out += f"assistant<|role_sep|>{m['content']}<|message_sep|>"
    if add_assistant:
        out += "assistant<|role_sep|>"
    return out


@register("megrez")
def _megrez(messages, add_assistant):
    out = "".join(
        f"<|role_start|>{m['role']}<|role_end|>{m['content']}<|turn_end|>"
        for m in messages)
    if add_assistant:
        out += "<|role_start|>assistant<|role_end|>"
    return out


@register("yandex")
def _yandex(messages, add_assistant):
    out = ""
    for m in messages:
        if m["role"] == "user":
            out += f" Пользователь: {m['content']}\n\n"
        elif m["role"] == "assistant":
            out += f" Ассистент: {m['content']}\n\n"
    if add_assistant:
        out += " Ассистент:[SEP]"
    return out


@register("bailing")
def _bailing(messages, add_assistant):
    out = ""
    for m in messages:
        role = "HUMAN" if m["role"] == "user" else m["role"].upper()
        out += f"<role>{role}</role>{m['content']}"
    if add_assistant:
        out += "<role>ASSISTANT</role>"
    return out


@register("llama4")
def _llama4(messages, add_assistant):
    out = "".join(
        f"<|header_start|>{m['role']}<|header_end|>\n\n"
        f"{_trim(m['content'])}<|eot|>" for m in messages)
    if add_assistant:
        out += "<|header_start|>assistant<|header_end|>\n\n"
    return out


@register("smolvlm")
def _smolvlm(messages, add_assistant):
    out = "<|im_start|>"
    for m in messages:
        if m["role"] == "system":
            out += f"{m['content']}\n\n"
        elif m["role"] == "user":
            out += f"User: {m['content']}<end_of_utterance>\n"
        else:
            out += f"Assistant: {m['content']}<end_of_utterance>\n"
    if add_assistant:
        out += "Assistant:"
    return out


@register("dots1")
def _dots1(messages, add_assistant):
    out = ""
    for m in messages:
        if m["role"] == "system":
            out += f"<|system|>{m['content']}<|endofsystem|>"
        elif m["role"] == "user":
            out += f"<|userprompt|>{m['content']}<|endofuserprompt|>"
        else:
            out += f"<|response|>{m['content']}<|endofresponse|>"
    if add_assistant:
        out += "<|response|>"
    return out


@register("hunyuan-moe")
def _hunyuan_moe(messages, add_assistant):
    out = ""
    for m in messages:
        if m["role"] == "system":
            out += f"<|startoftext|>{m['content']}<|extra_4|>"
        elif m["role"] == "assistant":
            out += f"{m['content']}<|eos|>"
        else:
            out += f"<|startoftext|>{m['content']}<|extra_0|>"
    return out


@register("hunyuan-dense")
def _hunyuan_dense(messages, add_assistant):
    out = ""
    for i, m in enumerate(messages):
        if i == 0 and m["role"] == "system":
            out += f"{m['content']}<｜hy_place▁holder▁no▁3｜>"
        if m["role"] == "assistant":
            out += f"<｜hy_Assistant｜>{m['content']}<｜hy_place▁holder▁no▁2｜>"
        elif m["role"] == "user":
            out += f"<｜hy_User｜>{m['content']}<｜hy_Assistant｜>"
    return out


@register("gpt-oss")
def _gpt_oss(messages, add_assistant):
    # Harmony-derived surface form (OPENAI_MOE in the reference)
    out = ""
    for m in messages:
        end = "<|return|>" if m["role"] == "assistant" else "<|end|>"
        out += f"<|start|>{m['role']}<|message|>{m['content']}{end}"
    if add_assistant:
        out += "<|start|>assistant"
    return out


register("openai-moe")(_gpt_oss)  # enum-name alias (LLM_CHAT_TEMPLATE_OPENAI_MOE)


@register("kimi-k2")
def _kimi_k2(messages, add_assistant):
    role_tok = {"system": "<|im_system|>system", "user": "<|im_user|>user",
                "assistant": "<|im_assistant|>assistant",
                "tool": "<|im_system|>tool"}
    out = "".join(
        f"{role_tok[m['role']]}<|im_middle|>{m['content']}<|im_end|>"
        for m in messages)
    if add_assistant:
        out += "<|im_assistant|>assistant<|im_middle|>"
    return out


@register("seed-oss")
def _seed_oss(messages, add_assistant):
    out = ""
    for m in messages:
        c = _trim(m["content"]) if m["role"] == "assistant" else m["content"]
        out += f"<seed:bos>{m['role']}\n{c}<seed:eos>"
    if add_assistant:
        out += "<seed:bos>assistant\n"
    return out


@register("grok2")
def _grok2(messages, add_assistant):
    out = ""
    for m in messages:
        if m["role"] == "system":
            out += f"System: {_trim(m['content'])}<|separator|>\n\n"
        elif m["role"] == "user":
            out += f"Human: {_trim(m['content'])}<|separator|>\n\n"
        else:
            out += f"Assistant: {m['content']}<|separator|>\n\n"
    if add_assistant:
        out += "Assistant:"
    return out


# every family name, fixed once the renderers above are registered
TEMPLATE_NAMES = frozenset(_REGISTRY)
