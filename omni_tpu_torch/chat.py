"""Chat templates (counterpart of omni_tpu/chat.py, itself the counterpart
of llama.cpp's llm_chat_apply_template + llm_chat_detect_template): the
family of a GGUF `tokenizer.chat_template` Jinja string is detected by its
markers, with llama.cpp's precedence, and a family is rendered by a
hand-written renderer (no Jinja engine).

Only ChatML, the template of the Qwen family and of MiniCPM-o, is ported;
every other family is known by name and detected, and raises
NotImplementedError when rendered (they come with the server, ROADMAP
queue 1 item 6).

Messages are [{"role": "system"|"user"|"assistant", "content": str}, ...].
"""

from __future__ import annotations

# every family the JAX package renders (omni_tpu.chat.known_templates())
TEMPLATE_NAMES = frozenset((
    "bailing", "chatglm3", "chatglm4", "chatml", "command-r", "deepseek",
    "deepseek-coder", "deepseek2", "deepseek3", "dots1", "exaone3", "exaone4",
    "falcon3", "gemma", "gigachat", "glmedge", "gpt-oss", "granite", "grok2",
    "hunyuan-dense", "hunyuan-moe", "kimi-k2", "llama2", "llama2-sys",
    "llama2-sys-bos", "llama2-sys-strip", "llama3", "llama4", "megrez",
    "minicpm", "mistral", "mistral-v1", "mistral-v3", "mistral-v3-tekken",
    "mistral-v7", "mistral-v7-tekken", "monarch", "openai-moe", "openchat",
    "orion", "phi3", "phi4", "rwkv-world", "seed-oss", "smolvlm", "vicuna",
    "vicuna-orca", "yandex", "zephyr"))


def apply_chat_template(template: str, messages: list[dict],
                        add_assistant: bool = True) -> str:
    """Render `messages` with a named family template, or with the family
    detected in a raw Jinja template string (llama_chat_apply_template)."""
    name = template if template in TEMPLATE_NAMES else detect_template(template)
    if name is None:
        raise ValueError(f"unknown chat template {template[:80]!r}")
    if name != "chatml":
        raise NotImplementedError(
            f"chat template {name!r}: only chatml is ported (the other "
            "families come with the server, ROADMAP queue 1 item 6)")
    return _chatml(messages, add_assistant)


def detect_template(jinja: str) -> str | None:
    """Map a Jinja chat-template string to a family: the same marker
    heuristics, in the same order, as llm_chat_detect_template."""
    has = lambda s: s in jinja  # noqa: E731
    if has("<|im_start|>"):
        if has("<|im_sep|>"):
            return "phi4"
        if has("<end_of_utterance>"):
            return "smolvlm"
        return "chatml"
    if jinja.startswith("mistral") or has("[INST]"):
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


def _chatml(messages: list[dict], add_assistant: bool) -> str:
    out = "".join(
        f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n" for m in messages)
    if add_assistant:
        out += "<|im_start|>assistant\n"
    return out
