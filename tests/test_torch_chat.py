"""The port's chat families and tool-call parser (omni_tpu_torch.chat,
omni_tpu_torch.chat_parser) against omni_tpu's: every family in
TEMPLATE_NAMES renders byte for byte as omni_tpu.chat does, on message
lists with and without a system message and over several turns; and
`detect_format`, `parse_response` and `apply_jinja_template` equal
omni_tpu.chat_parser's on the strings of tests/test_chat_parser.py (read
from that file's source), each string parsed under every format."""

import ast
from pathlib import Path

import pytest

from omni_tpu import chat as jchat
from omni_tpu import chat_parser as jparser
from omni_tpu_torch import chat
from omni_tpu_torch import chat_parser as parser

MESSAGE_LISTS = [
    [{"role": "user", "content": "hi"}],
    [{"role": "system", "content": "You are terse."},
     {"role": "user", "content": "Hi there\nhow are you?"}],
    [{"role": "system", "content": "  sys with spaces  "},
     {"role": "user", "content": "one"},
     {"role": "assistant", "content": " answer one "},
     {"role": "user", "content": "two 一二三"},
     {"role": "assistant", "content": "answer two"},
     {"role": "user", "content": "three"}],
    [{"role": "user", "content": "q"}, {"role": "assistant", "content": "a"}],
]

SRC = Path(__file__).with_name("test_chat_parser.py").read_text()
STRINGS = sorted({n.value for n in ast.walk(ast.parse(SRC))
                  if isinstance(n, ast.Constant) and isinstance(n.value, str)
                  and len(n.value) > 1})
TEMPLATES = [s for s in STRINGS if "{%" in s or "{{" in s]
FORMATS = sorted({jparser.detect_format(s) for s in STRINGS}
                 | {"hermes", "mistral_nemo", "magistral", "llama_3_x",
                    "deepseek_r1", "functionary_v3_2", "functionary_v3_1",
                    "firefunction_v2", "command_r7b", "granite", "nemotron_v2",
                    "seed_oss", "gpt_oss", "apertus", "generic",
                    "content_only"})


def _render(mod, name, msgs, add):
    try:
        return mod.apply_chat_template(name, msgs, add)
    except Exception as e:  # noqa: BLE001 (a family refusing a role order)
        return type(e).__name__, str(e)


def test_template_names_are_jax_names():
    assert chat.TEMPLATE_NAMES == frozenset(jchat.known_templates())
    assert len(chat.TEMPLATE_NAMES) == 49


@pytest.mark.parametrize("name", sorted(jchat.known_templates()))
def test_family_renders_byte_equal(name):
    for msgs in MESSAGE_LISTS:
        for add in (True, False):
            assert _render(chat, name, msgs, add) == _render(jchat, name, msgs,
                                                             add)


def test_detect_template_on_parser_strings():
    for s in STRINGS:
        assert chat.detect_template(s) == jchat.detect_template(s), s


def test_detect_format_matches_jax():
    assert parser.detect_format(None) == jparser.detect_format(None)
    for s in STRINGS:
        assert parser.detect_format(s) == jparser.detect_format(s), s


def _strip_ids(parsed):
    """A parse with the random call ids (uuid) blanked."""
    return {**parsed, "tool_calls": [{**c, "id": ""} for c in parsed["tool_calls"]]}


@pytest.mark.parametrize("fmt", FORMATS)
def test_parse_response_matches_jax(fmt):
    for s in STRINGS:
        want = _strip_ids(jparser.parse_response(s, fmt))
        assert _strip_ids(parser.parse_response(s, fmt)) == want, (fmt, s)


def test_apply_jinja_template_matches_jax():
    assert len(TEMPLATES) >= 2
    tools = [{"type": "function", "function": {"name": "f1"}}]
    for tmpl in TEMPLATES:
        for msgs in MESSAGE_LISTS:
            for kw in ({}, {"tools": tools}, {"add_generation_prompt": False}):
                try:
                    want = jparser.apply_jinja_template(tmpl, msgs, **kw)
                except Exception as e:  # noqa: BLE001
                    with pytest.raises(type(e)):
                        parser.apply_jinja_template(tmpl, msgs, **kw)
                    continue
                assert parser.apply_jinja_template(tmpl, msgs, **kw) == want


def test_jinja2_is_imported_inside_the_function(monkeypatch):
    """The card's machine has no jinja2: the module imports without it, and
    only a render raises ImportError."""
    import importlib
    import sys

    monkeypatch.setitem(sys.modules, "jinja2", None)
    mod = importlib.reload(parser)
    try:
        assert mod.detect_format("<tool_call>") == "hermes"
        with pytest.raises(ImportError):
            mod.apply_jinja_template("{{ x }}", [])
    finally:
        monkeypatch.undo()
        importlib.reload(parser)
