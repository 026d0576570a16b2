"""The port's GGUF tokenizer and chat template (omni_tpu_torch.tokenizer,
omni_tpu_torch.chat) against omni_tpu's: the same ids on the tiny Qwen3
fixture's byte vocabulary and on a small synthesised Qwen2-style vocabulary
(with both the qwen2 and the gpt2 split), the hand-written splitters
against the `regex` patterns, decode as the inverse of encode, and the same
ChatML text. The hypothesis texts draw from every code point but the
surrogates, and also from the code points that the `regex` module's newer
Unicode counts as letters or numbers and Python's `unicodedata` leaves
unassigned (`unicode_ln.RANGES`, which the port's scanners read first)."""

import sys
from pathlib import Path


import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from omni_tpu import chat as jchat
from omni_tpu.core import GGMLType
from omni_tpu.core import GGUFReader as JaxReader
from omni_tpu.testing import write_tiny_qwen3
from omni_tpu.tokenizer import build_tokenizer as jax_build_tokenizer
from omni_tpu_torch import chat
from omni_tpu_torch.core.gguf import GGUFReader
from omni_tpu_torch.testing_synth import learn_merges, qwen2_vocab_kv
from omni_tpu_torch.tokenizer import build_tokenizer
from omni_tpu_torch.tokenizer import unicode_ln
from omni_tpu_torch.tokenizer.bpe import split_gpt2, split_qwen2

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from torch_unicode_table import regex_ranges  # noqa: E402

SMALL_VOCAB = (2048, 600)  # tokens, merges of the synthesised vocabulary

TEXTS = [
    "", " ", "  ", "Hello, world!", "I'm here; they'RE there, we'Ll go.",
    "don't DON'T Don'T 's 'S", "a  b   c    d", "line one\nline two\r\n\r\nend",
    "tabs\tand\x0bvertical\x0cfeeds \t\n", "  leading and trailing  ",
    "一二三 四五 123 4567 ١٢٣ Ⅻ ½", "naïve café ÉCOLE é ño",
    "emoji 😀👍🏽 and ‍joined", "<|im_start|>user\nHi<|im_end|>\n",
    "<|im_start|><|im_end|><think>\n\n</think>", "\x1c\x1d\x1e\x1f sep",
    "x y z　w\u0085v", "$$ 3.14e-10 -> [a]{b}(c) #tag @user",
    "\n\n\n", "'", "''", "'\n", " '", "a'b", "word's 's",
]


@pytest.fixture(scope="module")
def tiny_kv(tmp_path_factory):
    """The tiny fixture's metadata, read by each package's own reader."""
    path = tmp_path_factory.mktemp("torch_tok") / "tiny.gguf"
    write_tiny_qwen3(path, n_layers=1, d_model=256, n_heads=2, n_kv_heads=1,
                     head_dim=128, d_ff=256, n_vocab=300, qtype=GGMLType.F32,
                     byte_tokenizer=True)
    jr, tr = JaxReader(path), GGUFReader(path)
    pair = jax_build_tokenizer(jr.kv), build_tokenizer(tr.kv)
    tr.close()
    return pair


@pytest.fixture(scope="module", params=["qwen2", "gpt2"])
def synth_pair(request):
    kv = dict(qwen2_vocab_kv(*SMALL_VOCAB), **{"tokenizer.ggml.pre": request.param})
    return jax_build_tokenizer(kv), build_tokenizer(kv)


def test_synthesised_vocab_layout():
    kv = qwen2_vocab_kv(*SMALL_VOCAB)
    toks, types = kv["tokenizer.ggml.tokens"], kv["tokenizer.ggml.token_type"]
    assert len(toks) == len(types) == SMALL_VOCAB[0] == len(set(toks))
    assert len(kv["tokenizer.ggml.merges"]) == SMALL_VOCAB[1]
    assert toks[kv["tokenizer.ggml.eos_token_id"]] == "<|im_end|>"
    assert toks[-22:][:3] == ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
    assert set(types[-22:]) == {3} and set(types[:-22]) == {1}
    # deterministic: the same text gives the same merges
    text = "the theme of the thesis: the then-theory " * 3
    assert learn_merges(text, 20) == learn_merges(text, 20)


@pytest.mark.parametrize("text", TEXTS)
def test_ids_equal_jax_on_the_tiny_fixture(tiny_kv, text):
    jt, tt = tiny_kv
    assert tt.encode(text) == jt.encode(text)
    assert tt.encode(text, parse_special=False) == jt.encode(text, parse_special=False)
    assert tt.decode(tt.encode(text)) == text


@pytest.mark.parametrize("text", TEXTS + [open(__file__).read()[:4000]])
def test_ids_equal_jax_on_a_synthesised_vocab(synth_pair, text):
    jt, tt = synth_pair
    ids = tt.encode(text)
    assert ids == jt.encode(text)
    assert tt.decode(ids) == jt.decode(ids) == text


FRAGMENTS = st.sampled_from([
    "'s", "'S", "'t", "'T", "'re", "'RE", "'Re", "'ve", "'VE", "'m", "'M",
    "'ll", "'LL", "'lL", "'d", "'D", "'x", "\r\n", "\r\n\r\n", "\n", "\r",
    " \n ", "  ", "   ", "\t", " \t ", "一", "二十", "三百", "〇", "٣", "Ⅻ",
    "½", "é", "́", "̀́", "A", "Word", "word", " word",
    "123", " 45", "!!", " ?", "<|im_start|>", "<|im_end|>", " ",
    "　", "\x1c", "😀", "‍", "ß", "İ"])
# code points of the table: letters and numbers by `regex` only
TABLE_CHARS = st.sampled_from(unicode_ln.RANGES).flatmap(
    lambda r: st.integers(r[0], r[1])).map(chr)
TEXT = st.lists(st.one_of(
    FRAGMENTS, st.text(TABLE_CHARS, min_size=1, max_size=4),
    st.text(st.characters(exclude_categories=("Cs",)), max_size=8)),
    max_size=12).map("".join)


def test_table_is_the_installed_regex():
    """The committed table is what the installed `regex` gives, and holds
    the 9,661 code points of regex 2026.7.19 against unicodedata 15.0.0,
    every one a letter or a number by `regex` alone."""
    import unicodedata

    version, ranges = regex_ranges()
    assert (version, unicodedata.unidata_version) == (
        unicode_ln.REGEX_VERSION, unicode_ln.UNICODEDATA_VERSION)
    assert tuple(ranges) == unicode_ln.RANGES
    assert sum(b - a + 1 for a, b, _ in ranges) == 9661
    assert {k for _, _, k in ranges} <= {0, 1}


@pytest.mark.parametrize("first,last,kind", unicode_ln.RANGES[::3])
def test_table_ranges_encode_as_jax(first, last, kind):
    """One character of every third range of the table (its first, its
    last, one between), alone, in a word and beside digits: the same ids
    in both packages on both splits of the synthesised vocabulary."""
    js, ts = _synth_tokenizers()
    for cp in {first, (first + last) // 2, last}:
        c = chr(cp)
        for text in (c, f"ab{c}{c}cd", f" {c}1 2{c}", f"'s{c} ,{c}\n{c}!"):
            assert split_qwen2(text) == js[0].engine._pre_tokenize(text)
            assert split_gpt2(text) == js[1].engine._pre_tokenize(text)
            for j, t in zip(js, ts):
                assert t.encode(text) == j.encode(text), (hex(cp), text)


@settings(max_examples=200, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=TEXT)
def test_hypothesis_texts(tiny_kv, text):
    """Unicode text with CJK numerals, combining marks, \\r\\n runs,
    mixed-case contractions and runs of spaces: the splitters equal the
    regex patterns, the ids equal omni_tpu's on both vocabularies, and
    decode inverts encode."""
    jt, tt = tiny_kv
    js, ts = _synth_tokenizers()
    assert split_qwen2(text) == js[0].engine._pre_tokenize(text)
    assert split_gpt2(text) == js[1].engine._pre_tokenize(text)
    assert tt.encode(text) == jt.encode(text)
    for j, t in zip(js, ts):
        ids = t.encode(text)
        assert ids == j.encode(text)
        assert t.decode(ids) == text


_CACHE = {}


def _synth_tokenizers():
    """(JAX, port) tokenizers of the small vocabulary, qwen2 then gpt2."""
    if not _CACHE:
        kv = qwen2_vocab_kv(*SMALL_VOCAB)
        kvs = [kv, dict(kv, **{"tokenizer.ggml.pre": "gpt2"})]
        _CACHE["jax"] = [jax_build_tokenizer(k) for k in kvs]
        _CACHE["port"] = [build_tokenizer(k) for k in kvs]
    return _CACHE["jax"], _CACHE["port"]


def test_specials_and_eog(tiny_kv):
    jt, tt = tiny_kv
    assert tt.vocab.special_tokens() == jt.vocab.special_tokens()
    n = tt.vocab.n_tokens
    assert [tt.vocab.is_eog(i) for i in range(n)] == [jt.vocab.is_eog(i) for i in range(n)]
    assert tt.decode(range(n), skip_special=True) == jt.decode(range(n), skip_special=True)


@pytest.mark.parametrize("kv", [{"tokenizer.ggml.model": "llama"},
                                {"tokenizer.ggml.pre": "llama3"},
                                {"tokenizer.ggml.model": "bert"}])
def test_other_tokenizers_raise(kv):
    base = qwen2_vocab_kv(*SMALL_VOCAB)
    with pytest.raises(NotImplementedError, match="item 10"):
        build_tokenizer(dict(base, **kv))


MESSAGES = [{"role": "system", "content": "You are terse."},
            {"role": "user", "content": "Hi there\nhow are you?"},
            {"role": "assistant", "content": "Fine."},
            {"role": "user", "content": "一二三"}]


@pytest.mark.parametrize("add_assistant", [True, False])
def test_chatml_renders_the_same_text(add_assistant, tiny_kv):
    want = jchat.apply_chat_template("chatml", MESSAGES, add_assistant)
    jinja = "{% for m in messages %}<|im_start|>{{ m.role }}...{% endfor %}"
    assert chat.apply_chat_template("chatml", MESSAGES, add_assistant) == want
    assert chat.apply_chat_template(jinja, MESSAGES, add_assistant) == want
    jt, tt = tiny_kv
    assert tt.encode(want) == jt.encode(want)


def test_detect_template_matches_jax():
    assert chat.TEMPLATE_NAMES == frozenset(jchat.known_templates())
    jinjas = ["<|im_start|>", "<|im_start|><|im_sep|>", "[INST] <<SYS>>",
              "mistral [SYSTEM_PROMPT]", "<|assistant|><|end|>", "<start_of_turn>",
              "<|start_header_id|><|eot_id|>", "<用户>", "User: Assistant: ",
              "no markers", "[gMASK]<sop>", "<|user|><|endoftext|>"]
    for j in jinjas:
        assert chat.detect_template(j) == jchat.detect_template(j), j
    assert (chat.apply_chat_template("llama3", MESSAGES)
            == jchat.apply_chat_template("llama3", MESSAGES))
    with pytest.raises(ValueError):
        chat.apply_chat_template("no markers", MESSAGES)


def test_encode_is_cached_per_word():
    _, ts = _synth_tokenizers()
    eng = ts[0].engine
    eng.encode("cached words cached words")
    info = eng._encode_word.cache_info()
    assert info.hits >= 2 and info.currsize >= 2
