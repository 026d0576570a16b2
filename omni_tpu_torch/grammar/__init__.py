"""Constrained decoding: GBNF grammars + JSON-schema conversion (the
port's copy of omni_tpu/grammar/: pure host code, no JAX and no torch).

Counterpart of the reference's src/llama-grammar.cpp and
common/json-schema-to-grammar.cpp (see SURVEY.md §2.2, §2.5).
"""

from .gbnf import Grammar, GrammarError, VocabTrie, parse_gbnf
from .json_schema import json_schema_to_gbnf

__all__ = [
    "Grammar",
    "GrammarError",
    "VocabTrie",
    "parse_gbnf",
    "json_schema_to_gbnf",
]
