"""Write omni_tpu_torch/tokenizer/unicode_ln.py: the code points whose class
in the split patterns (\\p{L}, \\p{N}, \\s or neither) differs between the
installed `regex` module and Python's `unicodedata`.

    python3 tools/torch_unicode_table.py

The port's tokenizer classifies characters with `unicodedata` and reads
this table first, so its splits follow the `regex` module's Unicode
version, which the JAX package's patterns use, without importing `regex`.
"""

from __future__ import annotations

import sys
import unicodedata
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "omni_tpu_torch" / "tokenizer" / "unicode_ln.py"
KIND_NAMES = ("_L", "_N", "_S", "_O")


def regex_ranges() -> tuple[str, list[tuple[int, int, int]]]:
    """(regex version, [(first, last, kind)]): the maximal runs of code
    points where the `regex` kind differs from the `unicodedata` one."""
    import regex

    sys.path.insert(0, str(ROOT))
    from omni_tpu_torch.tokenizer.bpe import _kind_unicodedata

    pats = [regex.compile(p) for p in (r"\p{L}", r"\p{N}", r"\s")]
    out: list[list[int]] = []
    for cp in range(0x110000):
        if 0xD800 <= cp < 0xE000:  # surrogates: never in a str of text
            continue
        c = chr(cp)
        kind = next((i for i, p in enumerate(pats) if p.match(c)), 3)
        if kind == _kind_unicodedata(c):
            continue
        if out and out[-1][1] == cp - 1 and out[-1][2] == kind:
            out[-1][1] = cp
        else:
            out.append([cp, cp, kind])
    return regex.__version__, [tuple(r) for r in out]


def render(version: str, ranges) -> str:
    n = sum(b - a + 1 for a, b, _ in ranges)
    lines = [
        '"""Code points that the `regex` module %s (Unicode of its own) '
        "classifies\notherwise than Python's `unicodedata` %s for the split "
        "patterns:\n%d ranges, %d code points. Written by "
        'tools/torch_unicode_table.py;\ndo not edit."""' % (
            version, unicodedata.unidata_version, len(ranges), n),
        "",
        f'REGEX_VERSION = "{version}"',
        f'UNICODEDATA_VERSION = "{unicodedata.unidata_version}"',
        "",
        "# (first, last, kind): kind 0 = \\p{L}, 1 = \\p{N}, 2 = \\s, 3 = other",
        "RANGES = (",
    ]
    lines += [f"    (0x{a:05X}, 0x{b:05X}, {k})," for a, b, k in ranges]
    lines += [")", ""]
    return "\n".join(lines)


if __name__ == "__main__":
    OUT.write_text(render(*regex_ranges()))
    print(f"wrote {OUT}")
