"""Byte-level BPE tokenizer of the gpt2 family, the Qwen2 variant of the
MiniCPM-o LLM included (counterpart of omni_tpu/tokenizer/bpe.py and of
llama.cpp's llm_tokenizer_bpe): the byte -> unicode alphabet, the
pre-tokenizer split of the model family, then lowest-rank-first pair
merging over the GGUF merge table.

The JAX package splits with the `regex` module's patterns; here the two
patterns are hand scanners over `unicodedata`, since Python's `re` has no
\\p{L} / \\p{N}:

    gpt2:  's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+
           |\\s+(?!\\S)|\\s+
    qwen2: (?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])
           |[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}| ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*
           |\\s*[\\r\\n]+|\\s+(?!\\S)|\\s+

Each scanner takes the first alternative that matches at a position, as
the regex engine does. \\p{L} is a character of category L*, \\p{N} of N*;
\\s is Unicode White_Space (`str.isspace()` less U+001C..U+001F, which
Python counts as space and the regex engine does not). The classes
follow the JAX package's `regex` module, whose Unicode is newer than
Python's `unicodedata`: the code points where the two differ (letters and
numbers that `unicodedata` leaves unassigned) are listed in
`unicode_ln.RANGES`, which `_kind` reads before `unicodedata`.
"""

from __future__ import annotations

import bisect
import functools
import unicodedata

from .unicode_ln import RANGES
from .vocab import Vocab

# character kinds of the split patterns
_L, _N, _S, _O = 0, 1, 2, 3  # \p{L}, \p{N}, \s, anything else
_NOT_WHITE_SPACE = frozenset("\x1c\x1d\x1e\x1f")
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


_RANGE_FIRST = [a for a, _, _ in RANGES]


def _kind_unicodedata(c: str) -> int:
    """The kind by Python's `unicodedata` alone."""
    cat = unicodedata.category(c)
    if cat[0] == "L":
        return _L
    if cat[0] == "N":
        return _N
    if c.isspace() and c not in _NOT_WHITE_SPACE:
        return _S
    return _O


@functools.lru_cache(maxsize=1 << 16)
def _kind(c: str) -> int:
    """The kind as the `regex` module's patterns see it: the table of the
    code points where it differs from `unicodedata`, then `unicodedata`."""
    cp = ord(c)
    i = bisect.bisect_right(_RANGE_FIRST, cp) - 1
    if i >= 0 and cp <= RANGES[i][1]:
        return RANGES[i][2]
    return _kind_unicodedata(c)


def _run(kinds: list[int], i: int, kind: int) -> int:
    """End of the run of `kind` that starts at i."""
    n = len(kinds)
    while i < n and kinds[i] == kind:
        i += 1
    return i


def _space_tail(kinds: list[int], i: int) -> int:
    """\\s+(?!\\S)|\\s+ at a space: the whole run at the end of the text
    or where it is one character, else the run less its last character
    (which goes with the next word)."""
    j = _run(kinds, i, _S)
    return j if j == len(kinds) or j - i == 1 else j - 1


def _contraction(text: str, i: int, fold: bool) -> int:
    """End of the contraction at text[i] == "'", or -1. `fold`: ASCII case
    folded ('[sS]'), as qwen2's pattern has it."""
    for suf in _CONTRACTIONS:
        part = text[i + 1:i + 1 + len(suf)]
        if part == suf or (fold and part.lower() == suf and part.isascii()):
            return i + 1 + len(suf)
    return -1


def split_gpt2(text: str) -> list[str]:
    kinds = [_kind(c) for c in text]
    n, i, out = len(text), 0, []
    while i < n:
        c = text[i]
        end = _contraction(text, i, fold=False) if c == "'" else -1
        if end < 0:
            k = kinds[i]
            if c == " " and i + 1 < n and kinds[i + 1] != _S:
                end = _run(kinds, i + 1, kinds[i + 1])  # ' ?' + a run
            elif k != _S:
                end = _run(kinds, i, k)
            else:
                end = _space_tail(kinds, i)
        out.append(text[i:end])
        i = end
    return out


def split_qwen2(text: str) -> list[str]:
    kinds = [_kind(c) for c in text]
    n, i, out = len(text), 0, []
    while i < n:
        c, k = text[i], kinds[i]
        end = _contraction(text, i, fold=True) if c == "'" else -1
        if end >= 0:
            pass
        elif k == _L:  # \p{L}+
            end = _run(kinds, i, _L)
        elif (k != _N and c not in "\r\n" and i + 1 < n
              and kinds[i + 1] == _L):  # [^\r\n\p{L}\p{N}]\p{L}+
            end = _run(kinds, i + 1, _L)
        elif k == _N:  # \p{N}
            end = i + 1
        elif k == _O or (c == " " and i + 1 < n and kinds[i + 1] == _O):
            # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
            end = _run(kinds, i + (k != _O), _O)
            while end < n and text[end] in "\r\n":
                end += 1
        else:  # a space
            j = _run(kinds, i, _S)
            nl = max(text.rfind("\r", i, j), text.rfind("\n", i, j))
            # '\s*[\r\n]+' ends after the run's last line break
            end = nl + 1 if nl >= 0 else _space_tail(kinds, i)
        out.append(text[i:end])
        i = end
    return out


# tokenizer.ggml.pre names whose split is one of the two patterns (the JAX
# package's PRE_REGEX entries that hold _GPT2 or _QWEN2)
PRE_SPLITTERS = {
    **dict.fromkeys(
        ("default", "gpt-2", "gpt2", "mpt", "olmo", "jais", "phi-2", "jina-es",
         "jina-de", "gigachat", "jina-v2-es", "jina-v2-de", "a.x-4.0",
         "mellum", "jina-v1-en", "jina-v2-code", "roberta-bpe", "exaone4",
         "trillion", "granite-docling"), split_gpt2),
    **dict.fromkeys(("qwen2", "stablelm2", "minicpm", "deepseek-r1-qwen",
                     "megrez", "hunyuan"), split_qwen2),
}


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2 byte <-> printable-unicode alphabet."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class BPEEngine:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        if vocab.merges is None:
            raise ValueError("BPE vocab without tokenizer.ggml.merges")
        self.ranks: dict[tuple[str, str], int] = {}
        for i, m in enumerate(vocab.merges):
            a, _, b = m.partition(" ")
            self.ranks[(a, b)] = i
        self.split = PRE_SPLITTERS.get(vocab.pre, split_gpt2)
        self.b2u = bytes_to_unicode()
        self.u2b = {c: b for b, c in self.b2u.items()}
        # per-engine word cache (the JAX engine keeps one too)
        self._encode_word = functools.lru_cache(maxsize=1 << 16)(
            self._encode_word_uncached)

    # ---- encode ------------------------------------------------------------
    def _pre_tokenize(self, text: str) -> list[str]:
        return [s for s in self.split(text) if s]

    def encode(self, text: str) -> list[int]:
        out: list[int] = []
        for m in self._pre_tokenize(text):
            out.extend(self._encode_word(m))
        return out

    def _encode_word_uncached(self, word: str) -> tuple[int, ...]:
        parts = [self.b2u[b] for b in word.encode("utf-8")]
        while len(parts) > 1:  # merge the lowest-ranked pair, leftmost first
            best_rank, best_i = None, None
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_i is None:
                break
            parts[best_i:best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        t2i = self.vocab.token_to_id
        ids: list[int] = []
        for p in parts:
            i = t2i.get(p)
            if i is not None:
                ids.append(i)
            else:  # resolve unmergeable pieces char by char
                for ch in p:
                    j = t2i.get(ch)
                    if j is not None:
                        ids.append(j)
                    elif self.vocab.unk_id is not None:
                        ids.append(self.vocab.unk_id)
        return tuple(ids)

    # ---- decode ------------------------------------------------------------
    def decode_token(self, token_id: int) -> bytes:
        s = self.vocab.tokens[token_id]
        return bytes(self.u2b.get(c, ord("?")) for c in s)
