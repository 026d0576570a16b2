"""GBNF grammar engine: parser + incremental constrained-decoding matcher.

Counterpart of the reference's grammar subsystem (src/llama-grammar.cpp,
~1.2k LoC; the port's copy of omni_tpu/grammar/gbnf.py): GBNF text is parsed into
rules of alternates of elements (char-class terminals and rule refs), and
decoding maintains a set of pushdown stacks describing every viable parse
continuation. Logit filtering walks the vocab trie once per step, pruning
whole subtrees the moment a prefix is rejected — the same role as
llama_grammar_apply_impl but O(live trie nodes), not O(vocab x len).

Grammar filtering is host-side by design (it is inherently sequential and
data-dependent); the allowed ids join the device sampler chain through
`runtime.sampler.apply_allowed_mask`.

GBNF syntax supported (full reference syntax):
  rule ::= alternates ;  literals "..." ; char classes [a-z0-9] / [^..] ;
  ( groups ) ; a | b ; postfix * + ? {m} {m,} {m,n} ; # comments.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable


# ---------------------------------------------------------------------------
# compiled representation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Char:
    """Terminal: a set of codepoint ranges, optionally negated."""

    ranges: tuple[tuple[int, int], ...]
    negated: bool = False

    def matches(self, cp: int) -> bool:
        hit = any(lo <= cp <= hi for lo, hi in self.ranges)
        return hit != self.negated


@dataclasses.dataclass(frozen=True)
class Ref:
    """Nonterminal: reference to another rule by id."""

    rule: int


Element = Char | Ref
# rules[rule_id] = list of alternates; alternate = tuple of elements
Rules = list[list[tuple[Element, ...]]]

# a parse stack: tuple of frames, each frame = (rule_id, alt_idx, elem_idx);
# the LAST frame is active. () = grammar fully matched (EOS is legal).
Stack = tuple[tuple[int, int, int], ...]


class GrammarError(ValueError):
    pass


# ---------------------------------------------------------------------------
# GBNF parser
# ---------------------------------------------------------------------------

_ESCAPES = {"n": "\n", "r": "\r", "t": "\t", "\\": "\\", '"': '"',
            "[": "[", "]": "]", "-": "-", "^": "^"}


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.rule_ids: dict[str, int] = {}
        self.rules: Rules = []

    # -- lexing helpers ----------------------------------------------------
    def _ws(self, newlines: bool = True) -> None:
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c == "#":  # comment to end of line
                while self.pos < len(self.text) and self.text[self.pos] != "\n":
                    self.pos += 1
            elif c in " \t" or (newlines and c in "\r\n"):
                self.pos += 1
            else:
                break

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _expect(self, s: str) -> None:
        if not self.text.startswith(s, self.pos):
            raise GrammarError(
                f"expected {s!r} at offset {self.pos}: "
                f"...{self.text[self.pos:self.pos + 20]!r}")
        self.pos += len(s)

    def _name(self) -> str:
        start = self.pos
        while self._peek() and (self._peek().isalnum() or self._peek() in "-_"):
            self.pos += 1
        if self.pos == start:
            raise GrammarError(f"expected rule name at offset {self.pos}")
        return self.text[start:self.pos]

    def _rule_id(self, name: str) -> int:
        if name not in self.rule_ids:
            self.rule_ids[name] = len(self.rules)
            self.rules.append([])
        return self.rule_ids[name]

    def _fresh_rule(self, base: str) -> int:
        n = 1
        while f"{base}_{n}" in self.rule_ids:
            n += 1
        return self._rule_id(f"{base}_{n}")

    def _escaped_char(self) -> int:
        self._expect("\\")
        c = self._peek()
        self.pos += 1
        if c == "x":
            v = int(self.text[self.pos:self.pos + 2], 16)
            self.pos += 2
            return v
        if c == "u":
            v = int(self.text[self.pos:self.pos + 4], 16)
            self.pos += 4
            return v
        if c == "U":
            v = int(self.text[self.pos:self.pos + 8], 16)
            self.pos += 8
            return v
        if c in _ESCAPES:
            return ord(_ESCAPES[c])
        raise GrammarError(f"unknown escape \\{c} at offset {self.pos}")

    def _char(self) -> int:
        if self._peek() == "\\":
            return self._escaped_char()
        c = self._peek()
        if not c:
            raise GrammarError("unexpected end of grammar")
        self.pos += 1
        return ord(c)

    # -- grammar parsing ----------------------------------------------------
    def parse(self) -> tuple[Rules, int]:
        self._ws()
        while self.pos < len(self.text):
            self._parse_rule()
            self._ws()
        if "root" not in self.rule_ids:
            raise GrammarError("grammar has no 'root' rule")
        for name, rid in self.rule_ids.items():
            if not self.rules[rid]:
                raise GrammarError(f"undefined rule {name!r}")
        return self.rules, self.rule_ids["root"]

    def _parse_rule(self) -> None:
        name = self._name()
        self._ws(newlines=False)
        self._expect("::=")
        rid = self._rule_id(name)
        if self.rules[rid]:
            raise GrammarError(f"duplicate rule {name!r}")
        self.rules[rid] = self._parse_alternates(name)

    def _parse_alternates(self, base: str) -> list[tuple[Element, ...]]:
        alts = [self._parse_sequence(base)]
        self._ws(newlines=True)
        while self._peek() == "|":
            self.pos += 1
            alts.append(self._parse_sequence(base))
            self._ws(newlines=True)
        return alts

    def _parse_sequence(self, base: str) -> tuple[Element, ...]:
        seq: list[Element] = []
        self._ws(newlines=False)
        while True:
            c = self._peek()
            if c == '"':
                seq.extend(self._parse_literal())
            elif c == "[":
                seq.append(self._parse_char_class())
            elif c == "(":
                self.pos += 1
                inner = self._parse_alternates(base)
                self._ws()
                self._expect(")")
                rid = self._fresh_rule(base)
                self.rules[rid] = inner
                seq.append(Ref(rid))
            elif c and (c.isalnum() or c in "-_"):
                # could be the next rule definition: name ::=
                save = self.pos
                name = self._name()
                probe = self.pos
                self._ws(newlines=False)
                if self.text.startswith("::=", self.pos):
                    self.pos = save  # rewind: belongs to the next rule
                    break
                self.pos = probe
                seq.append(Ref(self._rule_id(name)))
            else:
                break
            seq = self._parse_repetition(seq, base)
            self._ws(newlines=False)
        return tuple(seq)

    def _parse_literal(self) -> list[Char]:
        self._expect('"')
        out = []
        while self._peek() != '"':
            cp = self._char()
            out.append(Char(ranges=((cp, cp),)))
        self._expect('"')
        return out

    def _parse_char_class(self) -> Char:
        self._expect("[")
        negated = self._peek() == "^"
        if negated:
            self.pos += 1
        ranges: list[tuple[int, int]] = []
        while self._peek() != "]":
            lo = self._char()
            if self._peek() == "-" and self.text[self.pos + 1:self.pos + 2] != "]":
                self.pos += 1
                hi = self._char()
            else:
                hi = lo
            ranges.append((lo, hi))
        self._expect("]")
        return Char(ranges=tuple(ranges), negated=negated)

    def _parse_repetition(self, seq: list[Element], base: str) -> list[Element]:
        c = self._peek()
        if not c or c not in "*+?{" or not seq:
            return seq
        last = seq[-1]
        if c == "{":
            self.pos += 1
            start = self.pos
            while self._peek().isdigit():
                self.pos += 1
            lo = int(self.text[start:self.pos] or "0")
            hi: int | None = lo
            if self._peek() == ",":
                self.pos += 1
                start = self.pos
                while self._peek().isdigit():
                    self.pos += 1
                hi = int(self.text[start:self.pos]) if self.pos > start else None
            self._expect("}")
        elif c == "*":
            self.pos += 1
            lo, hi = 0, None
        elif c == "+":
            self.pos += 1
            lo, hi = 1, None
        else:  # ?
            self.pos += 1
            lo, hi = 0, 1
        return seq[:-1] + self._build_repetition(last, lo, hi, base)

    def _build_repetition(self, el: Element, lo: int, hi: int | None,
                          base: str) -> list[Element]:
        out: list[Element] = [el] * lo
        if hi is None:
            # star: S ::= el S | <empty>
            rid = self._fresh_rule(base)
            self.rules[rid] = [(el, Ref(rid)), ()]
            out.append(Ref(rid))
        else:
            # bounded optional tail: (el (el (... )?)?)?
            tail: int | None = None
            for _ in range(hi - lo):
                rid = self._fresh_rule(base)
                inner = (el, Ref(tail)) if tail is not None else (el,)
                self.rules[rid] = [inner, ()]
                tail = rid
            if tail is not None:
                out.append(Ref(tail))
        return out


def parse_gbnf(text: str) -> "Grammar":
    rules, root = _Parser(text).parse()
    return Grammar(rules, root)


# ---------------------------------------------------------------------------
# matcher
# ---------------------------------------------------------------------------

_MAX_EXPANSION = 10_000  # guards against left recursion blowup


class Grammar:
    """Incremental matcher over parse stacks (llama_grammar counterpart)."""

    def __init__(self, rules: Rules, root: int):
        self.rules = rules
        self.root = root
        self.stacks: list[Stack] = []
        self.reset()

    def reset(self) -> None:
        init: set[Stack] = set()
        for alt in range(len(self.rules[self.root])):
            self._expand(((self.root, alt, 0),), init)
        self.stacks = sorted(init)

    # -- core ---------------------------------------------------------------
    def _expand(self, stack: Stack, out: set[Stack], depth: int = 0) -> None:
        """Drive `stack` until its active element is a terminal (or done)."""
        if depth > _MAX_EXPANSION:
            raise GrammarError("grammar expansion too deep (left recursion?)")
        if not stack:
            out.add(())
            return
        rid, alt, idx = stack[-1]
        seq = self.rules[rid][alt]
        if idx >= len(seq):  # frame exhausted: pop, continue in parent
            self._expand(stack[:-1], out, depth + 1)
            return
        el = seq[idx]
        if isinstance(el, Ref):
            rest = stack[:-1] + ((rid, alt, idx + 1),)
            for a2 in range(len(self.rules[el.rule])):
                self._expand(rest + ((el.rule, a2, 0),), out, depth + 1)
        else:
            out.add(stack)

    def _accept_cp(self, stacks: Iterable[Stack], cp: int) -> list[Stack]:
        nxt: set[Stack] = set()
        for stack in stacks:
            if not stack:
                continue
            rid, alt, idx = stack[-1]
            el = self.rules[rid][alt][idx]
            assert isinstance(el, Char)
            if el.matches(cp):
                self._expand(stack[:-1] + ((rid, alt, idx + 1),), nxt)
        return sorted(nxt)

    # -- public API -----------------------------------------------------------
    def accepts_prefix(self, text: str) -> bool:
        """True if `text` can extend the current match state."""
        stacks = self.stacks
        for ch in text:
            stacks = self._accept_cp(stacks, ord(ch))
            if not stacks:
                return False
        return True

    def accept(self, text: str) -> None:
        """Advance the grammar state by `text` (a sampled token's string)."""
        for ch in text:
            self.stacks = self._accept_cp(self.stacks, ord(ch))
            if not self.stacks:
                raise GrammarError(f"text {text!r} rejected by grammar")

    @property
    def eos_allowed(self) -> bool:
        return any(not s for s in self.stacks)

    @property
    def exhausted(self) -> bool:
        """Only the completed parse remains: every non-EOS token is rejected."""
        return all(not s for s in self.stacks)

    def copy(self) -> "Grammar":
        g = Grammar.__new__(Grammar)
        g.rules, g.root, g.stacks = self.rules, self.root, list(self.stacks)
        return g

    # -- vocab filtering ---------------------------------------------------
    def allowed_tokens(self, trie: "VocabTrie") -> list[int]:
        """Token ids whose text is a viable continuation right now."""
        out: list[int] = []
        self._walk(trie.root, self.stacks, out)
        return out

    def _walk(self, node: "_TrieNode", stacks: list[Stack],
              out: list[int]) -> None:
        out.extend(node.tokens)
        for cp, child in node.children.items():
            nxt = self._accept_cp(stacks, cp)
            if nxt:
                self._walk(child, nxt, out)


class _TrieNode:
    __slots__ = ("children", "tokens")

    def __init__(self):
        self.children: dict[int, _TrieNode] = {}
        self.tokens: list[int] = []


class VocabTrie:
    """Codepoint trie over token texts; built once per vocab."""

    def __init__(self, token_texts: Iterable[tuple[int, str]]):
        self.root = _TrieNode()
        for tok_id, text in token_texts:
            if not text:
                continue
            node = self.root
            for ch in text:
                cp = ord(ch)
                node = node.children.setdefault(cp, _TrieNode())
            node.tokens.append(tok_id)
