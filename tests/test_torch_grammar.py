"""The port's grammar engine (omni_tpu_torch.grammar: parse_gbnf, Grammar,
VocabTrie, json_schema_to_gbnf) against omni_tpu.grammar on the grammars
and schemas of tests/test_grammar.py, read from that file's source: the
GBNF text must be equal, and `allowed_tokens`, `eos_allowed` and
`exhausted` must be equal after the same accepts, step by step along a
walk of allowed tokens and along each document the JAX tests accept."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest

from omni_tpu import grammar as jg
from omni_tpu_torch import grammar as tg

SRC = Path(__file__).with_name("test_grammar.py").read_text()


def _literals():
    """(GBNF strings, (schema, good docs, bad docs) triples) of
    test_grammar.py; a `roundtrip(schema, ...)` call reads the function's
    own `schema = {...}`."""
    tree = ast.parse(SRC)
    gbnfs, schemas = [], []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "::=" in node.value:
            gbnfs.append(node.value)
    for fn in (n for n in tree.body if isinstance(n, ast.FunctionDef)):
        named = {}
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                try:
                    named[node.targets[0].id] = ast.literal_eval(node.value)
                except ValueError:
                    pass
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "roundtrip"):
                schema, good, bad = (
                    named[a.id] if isinstance(a, ast.Name) else ast.literal_eval(a)
                    for a in node.args)
                schemas.append((schema, good, bad))
    return gbnfs, schemas


GBNFS, SCHEMAS = _literals()
# a vocabulary with single characters, words and JSON pieces, so that a
# walk meets both the per-character and the multi-character trie branches
VOCAB = ([chr(c) for c in range(32, 127)] + ["\n", "\t", "yes", "no", "es",
         "ab", "cd", "hi", "yo", "true", "false", "null", '{"', '":', '",',
         '"}', "[1", ", ", "12", "xx", "x", "+1", "aaa", "bb", "\\n", "<eos>"])


def _tries():
    pairs = list(enumerate(VOCAB))
    return jg.VocabTrie(pairs), tg.VocabTrie(pairs)


def _text(doc):
    return json.dumps(doc) if not isinstance(doc, str) else doc


def _state(g, trie):
    return sorted(g.allowed_tokens(trie)), g.eos_allowed, g.exhausted


def _walk(jgram, tgram, seed, steps=24):
    """Accept the same allowed tokens in both grammars (drawn from `seed`),
    comparing the allowed set, eos_allowed and exhausted at every step."""
    jt, tt = _tries()
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        want = _state(jgram, jt)
        assert _state(tgram, tt) == want
        if not want[0]:
            break
        tok = VOCAB[want[0][rng.integers(len(want[0]))]]
        jgram.accept(tok)
        tgram.accept(tok)


def _accept_both(jgram, tgram, text):
    """Accept `text` char by char; both must reject at the same place."""
    jt, tt = _tries()
    for ch in text:
        assert _state(tgram, tt) == _state(jgram, jt)
        try:
            jgram.accept(ch)
        except jg.GrammarError:
            with pytest.raises(tg.GrammarError):
                tgram.accept(ch)
            return False
        tgram.accept(ch)
    assert (tgram.eos_allowed, tgram.exhausted) == (jgram.eos_allowed,
                                                     jgram.exhausted)
    return jgram.eos_allowed


def test_literals_found():
    assert len(GBNFS) >= 10 and len(SCHEMAS) >= 12


@pytest.mark.parametrize("i", range(len(GBNFS)))
def test_gbnf_walk_matches_jax(i):
    text = GBNFS[i]
    try:
        jgram = jg.parse_gbnf(text)
    except jg.GrammarError as e:
        with pytest.raises(tg.GrammarError) as got:
            tg.parse_gbnf(text)
        assert str(got.value) == str(e)
        return
    tgram = tg.parse_gbnf(text)
    assert repr(tgram.rules) == repr(jgram.rules)
    assert tgram.root == jgram.root
    for seed in range(3):
        _walk(jgram.copy(), tgram.copy(), seed)


@pytest.mark.parametrize("i", range(len(SCHEMAS)))
def test_json_schema_matches_jax(i):
    schema, good, bad = SCHEMAS[i]
    text = jg.json_schema_to_gbnf(schema)
    assert tg.json_schema_to_gbnf(schema) == text
    jgram, tgram = jg.parse_gbnf(text), tg.parse_gbnf(text)
    for seed in range(2):
        _walk(jgram.copy(), tgram.copy(), seed)
    for doc in good:
        assert _accept_both(jgram.copy(), tgram.copy(), _text(doc))
    for doc in bad:
        assert not _accept_both(jgram.copy(), tgram.copy(), _text(doc))


def test_expansion_guard_kept():
    """The `_MAX_EXPANSION` guard is kept, and a left-recursive grammar
    fails in the port as in the JAX engine (Python's own recursion limit
    comes first there)."""
    from omni_tpu.grammar import gbnf as jgbnf
    from omni_tpu_torch.grammar import gbnf as tgbnf

    assert tgbnf._MAX_EXPANSION == jgbnf._MAX_EXPANSION
    text = 'root ::= root "a" | "b"'
    with pytest.raises((jg.GrammarError, RecursionError)) as want:
        jg.parse_gbnf(text)
    with pytest.raises((tg.GrammarError, RecursionError)) as got:
        tg.parse_gbnf(text)
    assert type(got.value).__name__ == type(want.value).__name__
