"""Vocabulary and tokenizer construction from GGUF metadata (counterpart of
omni_tpu/tokenizer/vocab.py, itself the counterpart of llama.cpp's
llama_vocab): reads the tokenizer.ggml.* keys, exposes the special-token
ids and builds the byte-level BPE tokenizer of the gpt2 family. Special
tokens are matched literally before pre-tokenization when parse_special is
set, as llama_tokenize(..., parse_special) does.

Only the BPE model (`tokenizer.ggml.model` "gpt2") with the gpt2 or qwen2
pre-tokenizers is ported; the SentencePiece, Unigram and WordPiece models
come with the model families that use them."""

from __future__ import annotations

import dataclasses
from typing import Any

# token_type values (llama_token_attr / the GGUF constants)
TYPE_NORMAL = 1
TYPE_UNKNOWN = 2
TYPE_CONTROL = 3
TYPE_USER_DEFINED = 4
TYPE_UNUSED = 5
TYPE_BYTE = 6

EOG_NAMES = ("<|endoftext|>", "<|im_end|>", "</s>", "<|eot_id|>", "<|end|>")


@dataclasses.dataclass
class Vocab:
    tokens: list[str]
    token_types: list[int]
    scores: list[float] | None
    model: str  # "gpt2" (BPE)
    pre: str  # pre-tokenizer variant
    merges: list[str] | None
    bos_id: int | None
    eos_id: int | None
    unk_id: int | None
    pad_id: int | None
    add_bos: bool
    add_eos: bool
    add_space_prefix: bool
    token_to_id: dict[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.token_to_id:
            self.token_to_id = {t: i for i, t in enumerate(self.tokens)}

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    def special_tokens(self) -> dict[str, int]:
        return {self.tokens[i]: i for i, tt in enumerate(self.token_types)
                if tt in (TYPE_CONTROL, TYPE_USER_DEFINED)}

    def is_eog(self, token_id: int) -> bool:
        return token_id in (self.eos_id,) or (
            self.token_types[token_id] == TYPE_CONTROL
            and self.tokens[token_id] in EOG_NAMES)


def vocab_from_gguf(kv: dict[str, Any]) -> Vocab:
    """The Vocab of a GGUF file's metadata. Every array is copied out of
    the reader's map, so the Vocab outlives `GGUFReader.close()`."""
    tokens = list(kv["tokenizer.ggml.tokens"])
    n = len(tokens)
    tt = kv.get("tokenizer.ggml.token_type")
    token_types = [int(x) for x in tt] if tt is not None else [TYPE_NORMAL] * n
    scores = kv.get("tokenizer.ggml.scores")
    if scores is not None:
        scores = [float(s) for s in scores]

    def _id(key, default=None):
        v = kv.get(f"tokenizer.ggml.{key}")
        return int(v) if v is not None and int(v) >= 0 else default

    model = kv.get("tokenizer.ggml.model", "gpt2")
    return Vocab(
        tokens=tokens,
        token_types=token_types,
        scores=scores,
        model=model,
        pre=kv.get("tokenizer.ggml.pre", "default"),
        merges=(list(kv["tokenizer.ggml.merges"])
                if "tokenizer.ggml.merges" in kv else None),
        bos_id=_id("bos_token_id"),
        eos_id=_id("eos_token_id"),
        unk_id=_id("unknown_token_id"),
        pad_id=_id("padding_token_id"),
        add_bos=bool(kv.get("tokenizer.ggml.add_bos_token", model == "llama")),
        add_eos=bool(kv.get("tokenizer.ggml.add_eos_token", False)),
        add_space_prefix=bool(kv.get("tokenizer.ggml.add_space_prefix",
                                     model == "llama")),
    )


class Tokenizer:
    """Common encode/decode wrapper with special-token splitting."""

    def __init__(self, vocab: Vocab, engine):
        self.vocab = vocab
        self.engine = engine
        self._specials = vocab.special_tokens()
        # longest-first literal matching
        self._special_order = sorted(self._specials, key=len, reverse=True)

    def encode(self, text: str, add_special: bool = True,
               parse_special: bool = True) -> list[int]:
        ids: list[int] = []
        if add_special and self.vocab.add_bos and self.vocab.bos_id is not None:
            ids.append(self.vocab.bos_id)
        for is_special, piece in self._split_specials(text, parse_special):
            if is_special:
                ids.append(self._specials[piece])
            elif piece:
                ids.extend(self.engine.encode(piece))
        if add_special and self.vocab.add_eos and self.vocab.eos_id is not None:
            ids.append(self.vocab.eos_id)
        return ids

    def _split_specials(self, text: str, parse_special: bool):
        # USER_DEFINED ("added") tokens are always matched literally; CONTROL
        # tokens only when parse_special (llama.cpp tokenizer_st_partition)
        tt = self.vocab.token_types
        active = [tok for tok in self._special_order
                  if parse_special or tt[self._specials[tok]] == TYPE_USER_DEFINED]
        if not active:
            yield False, text
            return
        rest = text
        while rest:
            best_at, best_tok = None, None
            for tok in active:
                at = rest.find(tok)
                if at != -1 and (best_at is None or at < best_at or
                                 (at == best_at and len(tok) > len(best_tok))):
                    best_at, best_tok = at, tok
            if best_at is None:
                yield False, rest
                return
            yield False, rest[:best_at]
            yield True, best_tok
            rest = rest[best_at + len(best_tok):]

    def decode(self, ids, skip_special: bool = False) -> str:
        parts: list[bytes] = []
        for i in ids:
            i = int(i)
            if skip_special and self.vocab.token_types[i] == TYPE_CONTROL:
                continue
            parts.append(self.engine.decode_token(i))
        return b"".join(parts).decode("utf-8", errors="replace")


def build_tokenizer(kv: dict[str, Any]) -> Tokenizer:
    """The tokenizer a GGUF file's metadata describes. Raises
    NotImplementedError for any model or pre-tokenizer but BPE with the
    gpt2 or qwen2 split (ROADMAP queue 1 item 10: spm.py, ugm.py, wpm.py
    and the other pre-tokenizers come with their model families)."""
    from .bpe import PRE_SPLITTERS, BPEEngine

    vocab = vocab_from_gguf(kv)
    if vocab.model != "gpt2" or vocab.pre not in PRE_SPLITTERS:
        raise NotImplementedError(
            f"tokenizer model {vocab.model!r} with pre-tokenizer "
            f"{vocab.pre!r}: only BPE ('gpt2') with the gpt2 or qwen2 split "
            "is ported (ROADMAP queue 1 item 10: spm.py, ugm.py, wpm.py)")
    return Tokenizer(vocab, BPEEngine(vocab))
