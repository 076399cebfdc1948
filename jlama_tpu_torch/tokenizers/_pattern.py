"""Patterns of tokenizer.json files, written for the `regex` module, run on
the standard library's `re`.

`translate` rewrites the classes whose meaning differs between the two into
explicit code-point ranges taken from `regex` (`_uniclass.py`): `\\p{L}`,
`\\p{N}`, `\\p{P}` and their `\\P` complements, and `\\s`, `\\w`, `\\d` and
their complements, outside a class (as a bracketed class) and inside one (as
bare ranges spliced in). `re`'s own `\\s`, `\\w` and `\\d` never reach a
compiled pattern: their Unicode tables are older, and `\\w` and `\\s` are
defined otherwise. The rest of the dialect the files use (groups, lookahead,
fixed-width lookbehind, possessive and lazy quantifiers, the `i`, `m` and
`s` flags) means the same in both. Anything else raises `ValueError` naming
the construct, rather than matching other text.
"""

from __future__ import annotations

import functools
import re

from ._uniclass import CLASSES

# escapes that mean the same in `regex` and `re` (the rest of the letters and
# digits raise; an escaped punctuation character is a literal in both)
_SAME_OUTSIDE = set("nrtfva0123456789AZxuUN")
_SAME_INSIDE = set("nrtfvab01234567xuUN")
_SHORT = {"s": ("s", False), "S": ("s", True), "w": ("w", False), "W": ("w", True),
          "d": ("d", False), "D": ("d", True)}
_PROPERTIES = ("L", "N", "P")
_FLAGS = set("ims")
_RANGE = re.compile(r"\\(?:u([0-9a-f]{4})|U([0-9a-f]{8}))(?:-\\(?:u([0-9a-f]{4})|U([0-9a-f]{8})))?")


def _ranges(name: str) -> list[tuple[int, int]]:
    out = []
    for m in _RANGE.finditer(CLASSES[name]):
        lo = int(m.group(1) or m.group(2), 16)
        hi = int(m.group(3) or m.group(4), 16) if (m.group(3) or m.group(4)) else lo
        out.append((lo, hi))
    return out


def _escape(cp: int) -> str:
    return f"\\u{cp:04x}" if cp <= 0xFFFF else f"\\U{cp:08x}"


@functools.cache
def class_text(name: str, negated: bool = False) -> str:
    """The bare ranges of class `name` (a key of `_uniclass.CLASSES`), or of
    its complement, as text to splice inside `[...]`."""
    if not negated:
        return CLASSES[name]
    out, nxt = [], 0
    for lo, hi in _ranges(name):
        if lo > nxt:
            out.append((nxt, lo - 1))
        nxt = hi + 1
    if nxt <= 0x10FFFF:
        out.append((nxt, 0x10FFFF))
    return "".join(_escape(lo) if lo == hi else f"{_escape(lo)}-{_escape(hi)}"
                   for lo, hi in out)


def _escape_len(pat: str, j: int) -> int:
    """Length of the escape at pat[j] ('\\'), its argument included."""
    e = pat[j + 1]
    if e == "x":
        return 4
    if e == "u":
        return 6
    if e == "U":
        return 10
    if e == "N":
        end = pat.find("}", j)
        if pat[j + 2:j + 3] != "{" or end < 0:
            raise ValueError(f"pattern {pat!r}: \\N without a name at {j}")
        return end - j + 1
    return 2


def _class_escape(pat: str, j: int) -> tuple[tuple[str, bool] | None, int]:
    """At an escape pat[j] == '\\': ((class name, negated), length) for a
    class to translate, else (None, length)."""
    if j + 1 >= len(pat):
        raise ValueError(f"pattern {pat!r} ends in a lone backslash")
    e = pat[j + 1]
    if e in _SHORT:
        return _SHORT[e], 2
    if e in "pP":
        if pat[j + 2:j + 3] == "{":
            end = pat.find("}", j)
            if end < 0:
                raise ValueError(f"pattern {pat!r}: unterminated \\{e}{{ at {j}")
            name, n = pat[j + 3:end], end - j + 1
        else:
            name, n = pat[j + 2:j + 3], 3
        if name not in _PROPERTIES:
            raise ValueError(f"pattern {pat!r}: \\{e}{{{name}}} is not supported "
                             f"(only {', '.join(_PROPERTIES)})")
        return (name, e == "P"), n
    return None, _escape_len(pat, j)


def _bracket(pat: str, i: int) -> tuple[str, int, bool]:
    """Translate the class starting at pat[i] == '['; returns (text, end,
    whether a class was spliced in)."""
    j, out, spliced = i + 1, ["["], False
    if pat[j:j + 1] == "^":
        out.append("^")
        j += 1
    first = True
    while True:
        if j >= len(pat):
            raise ValueError(f"pattern {pat!r}: unterminated class at {i}")
        c = pat[j]
        if c == "]" and not first:
            return "".join(out) + "]", j + 1, spliced
        if c == "[":
            raise ValueError(f"pattern {pat!r}: nested set at {j}")
        if c in "&|~-" and pat[j + 1:j + 2] == c:
            raise ValueError(f"pattern {pat!r}: set operation {c * 2} at {j}")
        if c != "\\":
            out.append(c)
            j += 1
            first = False
            continue
        cls, n = _class_escape(pat, j)
        if cls is not None:
            before, after = pat[j - 1], pat[j + n:j + n + 1]
            if (before == "-" and not first and pat[j - 2] not in "[^") or \
                    (after == "-" and pat[j + n + 1:j + n + 2] != "]"):
                raise ValueError(f"pattern {pat!r}: a class as a range's end at {j}")
            out.append(class_text(*cls))
            spliced = True
        elif pat[j + 1] in _SAME_INSIDE or not pat[j + 1].isalnum():
            out.append(pat[j:j + n])
        else:
            raise ValueError(f"pattern {pat!r}: \\{pat[j + 1]} inside a class is not supported")
        j += n
        first = False


def translate(pat: str) -> str:
    """The `re` pattern that matches what `regex` matches with `pat`."""
    out, i = [], 0
    icase = [False]  # per open group: whether the i flag is on inside it
    while i < len(pat):
        c = pat[i]
        if c == "[":
            text, i, spliced = _bracket(pat, i)
            _check_case(pat, i, icase[-1] and spliced)
            out.append(text)
            continue
        if c == "(":
            on = icase[-1]
            m = re.match(r"\(\?([A-Za-z]*)(?:-([A-Za-z]*))?([:)])", pat[i:])
            if m:
                flags = set(m.group(1)) | set(m.group(2) or "")
                if flags - _FLAGS:
                    raise ValueError(f"pattern {pat!r}: flags {m.group(0)} at {i}: only "
                                     f"{''.join(sorted(_FLAGS))} are supported")
                on = ("i" in m.group(1) or on) and "i" not in (m.group(2) or "")
                if m.group(3) == ")":  # (?i) on the whole pattern
                    icase[0] = on
                    out.append(pat[i:i + m.end()])
                    i += m.end()
                    continue
            icase.append(on)
        elif c == ")" and len(icase) > 1:
            icase.pop()
        if c != "\\":
            out.append(c)
            i += 1
            continue
        cls, n = _class_escape(pat, i)
        if cls is not None:
            _check_case(pat, i, icase[-1])
            name, negated = cls
            out.append(f"[{'^' if negated else ''}{class_text(name)}]")
        elif pat[i + 1] in "bB":
            raise ValueError(f"pattern {pat!r}: \\{pat[i + 1]} (a word boundary by re's \\w) "
                             "is not supported")
        elif pat[i + 1] in _SAME_OUTSIDE or not pat[i + 1].isalnum():
            out.append(pat[i:i + n])
        else:
            raise ValueError(f"pattern {pat!r}: \\{pat[i + 1]} is not supported")
        i += n
    return "".join(out)


def _check_case(pat: str, i: int, icase: bool) -> None:
    """A translated class under the i flag would fold case by `re`'s tables,
    which differ from `regex`'s (on `\\P{L}`, for one)."""
    if icase:
        raise ValueError(f"pattern {pat!r}: a Unicode class under the i flag at {i} "
                         "is not supported")


@functools.lru_cache(maxsize=256)
def compile_pattern(pat: str) -> re.Pattern:
    """`re.compile(translate(pat))`, once per pattern; raises ValueError for
    what `re` cannot take (a variable-width lookbehind, say)."""
    try:
        return re.compile(translate(pat))
    except re.error as e:
        raise ValueError(f"pattern {pat!r}: {e}") from None
