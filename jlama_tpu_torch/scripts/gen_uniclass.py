"""Write `tokenizers/_uniclass.py`: the code-point ranges of the `regex`
module's `\\p{L}`, `\\p{N}`, `\\p{P}`, `\\s`, `\\w` and `\\d`.

    python -m jlama_tpu_torch.scripts.gen_uniclass [--out FILE]

tokenizer.json patterns are written for `regex`, whose Unicode tables are
newer than the standard library's `unicodedata`, and whose `\\w`, `\\s` and
`\\d` differ from `re`'s. The port translates those patterns for `re`
(`tokenizers/_pattern.py`) with the classes taken from `regex` here, so that
token ids do not depend on which Unicode tables the running Python has.
This script needs `regex`; nothing imports it, and the package runs without
`regex`.
"""

from __future__ import annotations

import argparse
from pathlib import Path

CLASSES = {"L": r"\p{L}", "N": r"\p{N}", "P": r"\p{P}", "s": r"\s", "w": r"\w", "d": r"\d"}
# a script that each Unicode version added: the newest one `regex` knows
# names the version of its tables
NEW_SCRIPTS = (("14.0.0", "Vithkuqi"), ("15.0.0", "Kawi"), ("16.0.0", "Garay"),
               ("17.0.0", "Sidetic"))
PER_LINE = 6
OUT = Path(__file__).resolve().parent.parent / "tokenizers" / "_uniclass.py"


def _escape(cp: int) -> str:
    return f"\\u{cp:04x}" if cp <= 0xFFFF else f"\\U{cp:08x}"


def ranges(regex, cls: str) -> list[tuple[int, int]]:
    """The maximal runs of code points that `cls` matches, over all of them."""
    every = "".join(map(chr, range(0x110000)))
    return [(m.start(), m.end() - 1) for m in regex.finditer(cls + "+", every)]


def unicode_version(regex) -> str:
    version = "unknown"
    for v, script in NEW_SCRIPTS:
        try:
            regex.compile(rf"\p{{Script={script}}}")
        except regex.error:
            break
        version = v
    return version


def render(regex) -> str:
    lines = [
        'r"""Code-point ranges of the `regex` module\'s classes, as `re` character-class',
        "text (`\\uXXXX` and `\\U000XXXXX` escapes, a range as lo-hi).",
        "",
        "Generated by `python -m jlama_tpu_torch.scripts.gen_uniclass`; do not edit.",
        '"""',
        "",
        f'REGEX_VERSION = "{regex.__version__}"',
        f'UNICODE_VERSION = "{unicode_version(regex)}"',
        "",
        "CLASSES = {",
    ]
    for name, cls in CLASSES.items():
        rs = [_escape(lo) if lo == hi else f"{_escape(lo)}-{_escape(hi)}"
              for lo, hi in ranges(regex, cls)]
        lines.append(f'    "{name}": (  # {cls}: {len(rs)} ranges')
        for i in range(0, len(rs), PER_LINE):
            lines.append('        r"' + "".join(rs[i:i + PER_LINE]) + '"')
        lines.append("    ),")
    lines.append("}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    import regex

    args.out.write_text(render(regex))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
