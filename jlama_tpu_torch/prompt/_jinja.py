"""A renderer for the subset of Jinja that Hugging Face chat templates use,
in the standard library only.

It is held to the environment of the JAX package's `render_chat_template`:
`trim_blocks`, `lstrip_blocks` and loop controls on; the `-` and `+`
whitespace controls; the globals `raise_exception`, `strftime_now`,
`namespace`, `range` and `dict`; the filter `tojson` (`json.dumps` with
`indent`, `ensure_ascii=False`). It covers `{{ }}` with attribute, subscript
and slice lookup (an attribute falls back to item access, so `m.role` reads a
dict; Python methods such as `.strip()` can be called), `if`/`elif`/`else`,
`for` (an `if` filter, `else`, `loop.index`, `index0`, `revindex`,
`revindex0`, `first`, `last`, `length`, `previtem`, `nextitem`, `depth`,
`depth0`, `cycle`), `break`, `continue`, `set` (names, tuples, a namespace's
attribute), the operators `and`, `or`, `not`, comparisons, `in`, `not in`,
`+ - * / // % **`, `~` and `a if b else c`, literals, a few tests and
filters, and Jinja's scoping (a `for` body is a scope of its own each
iteration; `if` is not) and undefined values (an undefined name renders as
empty and iterates as empty; an attribute, item or operation on it raises).

Anything else raises `TemplateError` naming the construct, when the template
is compiled or when the construct runs: it never renders other text than
Jinja would.
"""

from __future__ import annotations

import datetime
import functools
import json
import re
from collections import abc
from numbers import Number


class TemplateError(RuntimeError):
    pass


class Undefined:
    """Jinja's default undefined value."""

    __slots__ = ("_name",)

    def __init__(self, name: str = ""):
        self._name = name

    def _fail(self, *args, **kwargs):
        raise TemplateError(f"{self._name or 'a value'} is undefined")

    def __getattr__(self, name):
        if name[:2] == "__" and name[-2:] == "__":
            raise AttributeError(name)
        self._fail()

    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _fail
    __truediv__ = __rtruediv__ = __floordiv__ = __rfloordiv__ = _fail
    __mod__ = __rmod__ = __pos__ = __neg__ = __call__ = __getitem__ = _fail
    __lt__ = __le__ = __gt__ = __ge__ = __int__ = __float__ = __complex__ = _fail
    __pow__ = __rpow__ = _fail

    def __eq__(self, other):
        return type(self) is type(other)

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return id(type(self))

    def __str__(self):
        return ""

    def __len__(self):
        return 0

    def __iter__(self):
        yield from ()

    def __bool__(self):
        return False

    def __repr__(self):
        return "Undefined"


class Namespace:
    """`namespace(...)`: attributes that a `set` inside a loop can change."""

    def __init__(self, *args, **kwargs):
        object.__setattr__(self, "_attrs", dict(*args, **kwargs))

    def __getattr__(self, name):
        try:
            return self._attrs[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setitem__(self, name, value):
        self._attrs[name] = value

    def __repr__(self):
        return f"<Namespace {self._attrs!r}>"


class _Loop:
    """The `loop` variable of one iteration."""

    ATTRS = {"index", "index0", "revindex", "revindex0", "first", "last", "length",
             "previtem", "nextitem", "depth", "depth0", "cycle"}
    depth, depth0 = 1, 0

    def __init__(self, items: list, index0: int):
        self._items, self.index0 = items, index0

    index = property(lambda self: self.index0 + 1)
    length = property(lambda self: len(self._items))
    first = property(lambda self: self.index0 == 0)
    last = property(lambda self: self.index0 == len(self._items) - 1)
    revindex = property(lambda self: len(self._items) - self.index0)
    revindex0 = property(lambda self: len(self._items) - self.index0 - 1)

    @property
    def previtem(self):
        return self._items[self.index0 - 1] if self.index0 else Undefined("loop.previtem")

    @property
    def nextitem(self):
        i = self.index0 + 1
        return self._items[i] if i < len(self._items) else Undefined("loop.nextitem")

    def cycle(self, *args):
        if not args:
            raise TypeError("no items for cycling given")
        return args[self.index0 % len(args)]

    def __repr__(self):
        return f"<LoopContext {self.index}/{self.length}>"


# --------------------------------------------------------------------------
# the environment


def _raise_exception(msg):
    raise TemplateError(msg)


def _tojson(value, indent=None):
    return json.dumps(value, indent=indent, ensure_ascii=False)


def _strftime_now(fmt):
    return datetime.datetime.now().strftime(fmt)


def _first(seq):
    try:
        return next(iter(seq))
    except StopIteration:
        return Undefined("first item")


def _last(seq):
    try:
        return next(iter(reversed(seq)))
    except StopIteration:
        return Undefined("last item")


def _default(value, default_value="", boolean=False):
    return default_value if isinstance(value, Undefined) or (boolean and not value) else value


GLOBALS = {"raise_exception": _raise_exception, "strftime_now": _strftime_now,
           "namespace": Namespace, "range": range, "dict": dict}
# Jinja's other globals: a template that uses one raises
UNSUPPORTED_GLOBALS = {"lipsum", "cycler", "joiner"}
FILTERS = {
    "tojson": _tojson,
    "trim": lambda value, chars=None: str(value).strip(chars),
    "length": len, "count": len,
    "string": str,
    "upper": lambda s: str(s).upper(), "lower": lambda s: str(s).lower(),
    "default": _default, "d": _default,
    "join": lambda value, d="": str(d).join(map(str, value)),
    "first": _first, "last": _last, "list": list,
}
def _iterable(value):
    try:
        iter(value)
    except TypeError:
        return False
    return True


def _sequence(value):
    try:
        len(value)
        value.__getitem__  # noqa: B018 — Jinja's test reads the attribute
    except Exception:  # noqa: BLE001 — as Jinja's test
        return False
    return True


TESTS = {
    "defined": lambda v: not isinstance(v, Undefined),
    "undefined": lambda v: isinstance(v, Undefined),
    "none": lambda v: v is None,
    "string": lambda v: isinstance(v, str),
    "mapping": lambda v: isinstance(v, abc.Mapping),
    "number": lambda v: isinstance(v, Number),
    "boolean": lambda v: v is True or v is False,
    "true": lambda v: v is True,
    "false": lambda v: v is False,
    "iterable": _iterable,
    "sequence": _sequence,
}


def _getattr(obj, name):
    """Jinja's attribute lookup: the attribute, else the item, else undefined."""
    if isinstance(obj, Undefined):
        obj._fail()
    if isinstance(obj, _Loop) and name not in _Loop.ATTRS:
        raise TemplateError(f"loop.{name} is not supported")
    try:
        return getattr(obj, name)
    except AttributeError:
        pass
    try:
        return obj[name]
    except (TypeError, LookupError, AttributeError):
        return Undefined(f"{type(obj).__name__} attribute {name!r}")


def _getitem(obj, key):
    """Jinja's subscript: the item, else the attribute of that name, else undefined."""
    if isinstance(obj, Undefined):
        obj._fail()
    try:
        return obj[key]
    except (AttributeError, TypeError, LookupError):
        if isinstance(key, str):
            return _getattr(obj, key)
        return Undefined(f"{type(obj).__name__} item {key!r}")


# --------------------------------------------------------------------------
# lexer: the template into text, {{ }} and {% %} segments

_TAG = re.compile(r"\{([{%#])([-+]?)")
_WS = re.compile(r"\s+")
_TOKEN = re.compile(r"""
    (?P<ws>\s+)
  | (?P<float>\d+\.\d+(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+)
  | (?P<int>\d+)
  | (?P<name>[a-zA-Z_][a-zA-Z0-9_]*)
  | (?P<str>'[^'\\]*(?:\\.[^'\\]*)*'|"[^"\\]*(?:\\.[^"\\]*)*")
  | (?P<op>//|\*\*|==|!=|>=|<=|[-+/*%~\[\](){}<>=.:|,;])
""", re.X | re.S)
# trim_blocks: a block or comment tag eats the newline after it
_BLOCK_END = re.compile(r"\+%\}|-%\}\s*|%\}\n?")
_VAR_END = re.compile(r"-\}\}\s*|\}\}")
_COMMENT_END = re.compile(r"\+#\}|-#\}\s*|#\}\n?")
_CLOSE = {"(": ")", "[": "]", "{": "}"}


def _tag_tokens(src: str, pos: int, end: re.Pattern) -> tuple[list, re.Match]:
    toks, open_ = [], []
    while True:
        if not open_:
            m = end.match(src, pos)
            if m:
                return toks, m
        m = _TOKEN.match(src, pos)
        if m is None:
            raise TemplateError(f"unexpected {src[pos:pos + 20]!r} in a tag"
                                if pos < len(src) else "a tag is not closed")
        pos, kind, val = m.end(), m.lastgroup, m.group()
        if kind == "ws":
            continue
        if kind == "str":
            val = val[1:-1].encode("ascii", "backslashreplace").decode("unicode-escape")
        elif kind == "int":
            val = int(val)
        elif kind == "float":
            val = float(val)
        elif val in _CLOSE:
            open_.append(_CLOSE[val])
        elif val in ")]}":
            if not open_ or open_.pop() != val:
                raise TemplateError(f"unexpected {val!r} in a tag")
        toks.append((kind, val))


def _lex(src: str) -> list[tuple[str, object]]:
    lines = re.split(r"\r\n|\r|\n", src)
    if lines[-1] == "":  # one trailing newline goes (keep_trailing_newline off)
        del lines[-1]
    src = "\n".join(lines)
    out, pos, line_starting = [], 0, True
    while True:
        m = _TAG.search(src, pos)
        text = src[pos:m.start() if m else len(src)]
        if m is None:
            if text:
                out.append(("text", text))
            return out
        kind, sign = m.group(1), m.group(2)
        if sign == "-":
            text = text.rstrip()
        elif sign != "+" and kind != "{":  # lstrip_blocks
            start = text.rfind("\n") + 1
            if (start > 0 or line_starting) and _WS.fullmatch(text, start):
                text = text[:start]
        if text:
            out.append(("text", text))
        if kind == "#":
            end = _COMMENT_END.search(src, m.end())
            if end is None:
                raise TemplateError("a comment is not closed")
        else:
            toks, end = _tag_tokens(src, m.end(), _VAR_END if kind == "{" else _BLOCK_END)
            out.append(("var" if kind == "{" else "block", toks))
        pos, line_starting = end.end(), end.group().endswith("\n")


# --------------------------------------------------------------------------
# parser: segments into closures


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


# how a frame's name starts when the frame is entered (Jinja's idtracking)
_PARAM, _RESOLVE, _ALIAS, _UNDEF = range(4)
_MISSING = object()  # a name the frame has stored, but not yet
_UNSUPPORTED = object()


class _Symbols:
    """One frame's symbol table, built as Jinja's `idtracking.Symbols` is:
    it decides, per name, where the frame's value starts from."""

    def __init__(self, parent: "_Symbols | None" = None):
        self.parent, self.loads, self.stores = parent, {}, set()

    def copy(self) -> "_Symbols":
        c = _Symbols(self.parent)
        c.loads, c.stores = dict(self.loads), set(self.stores)
        return c

    def find(self, name) -> bool:
        s = self
        while s is not None:
            if name in s.loads:
                return True
            s = s.parent
        return False

    def load(self, name):
        if not self.find(name):
            self.loads[name] = _RESOLVE

    def store(self, name):
        self.stores.add(name)
        if name not in self.loads:
            outer = self.parent is not None and self.parent.find(name)
            self.loads[name] = _ALIAS if outer else _UNDEF

    def param(self, name):
        self.stores.add(name)
        self.loads[name] = _PARAM

    def branch_update(self, branches: list):
        stores: dict[str, int] = {}
        for b in branches:
            for name in b.stores - self.stores:
                stores[name] = stores.get(name, 0) + 1
        for b in branches:
            self.loads.update(b.loads)
            self.stores |= b.stores
        for name, n in stores.items():
            if n != len(branches):
                outer = self.parent is not None and self.parent.find(name)
                self.loads[name] = _ALIAS if outer else _RESOLVE

    def visit(self, events: list, fors: list):
        """Take a frame's events in order; its loops' frames come after."""
        for ev in events:
            if ev[0] == "load":
                self.load(ev[1])
            elif ev[0] == "store":
                self.store(ev[1])
            elif ev[0] == "if":
                self.visit(ev[1], fors)
                copies = []
                for branch in ev[2]:
                    c = self.copy()
                    c.visit(branch, fors)
                    copies.append(c)
                self.branch_update(copies)
            else:  # ("for", iterable's events, the loop): the iterable is this frame's
                self.visit(ev[1], fors)
                fors.append(ev[2])

    def plan(self) -> list:
        return [(name, kind) for name, kind in self.loads.items() if kind != _PARAM]


class _Scope:
    """The frames of a render: a dict each, holding every name its symbol
    table knows, so the innermost frame holding a name is the one Jinja's
    compiled code reads."""

    __slots__ = ("ctx", "frames")

    def __init__(self, ctx: dict):
        self.ctx, self.frames = ctx, []

    def resolve(self, name):
        if name in self.ctx:
            return self.ctx[name]
        if name in GLOBALS:
            return GLOBALS[name]
        return _UNSUPPORTED if name in UNSUPPORTED_GLOBALS else _MISSING

    def raw(self, name):
        for f in reversed(self.frames):
            if name in f:
                return f[name]
        return self.resolve(name)

    def lookup(self, name):
        v = self.raw(name)
        if v is _MISSING:
            return Undefined(repr(name))
        if v is _UNSUPPORTED:
            raise TemplateError(f"{name}() is not supported")
        return v

    def enter(self, plan: list) -> dict:
        frame = {name: self.resolve(name) if kind == _RESOLVE else
                 self.raw(name) if kind == _ALIAS else _MISSING for name, kind in plan}
        self.frames.append(frame)
        return frame


_CMP = {"==": lambda a, b: a == b, "!=": lambda a, b: a != b, "<": lambda a, b: a < b,
        "<=": lambda a, b: a <= b, ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
        "in": lambda a, b: a in b, "notin": lambda a, b: a not in b}
_MATH = {"+": lambda a, b: a + b, "-": lambda a, b: a - b, "*": lambda a, b: a * b,
         "/": lambda a, b: a / b, "//": lambda a, b: a // b, "%": lambda a, b: a % b,
         "**": lambda a, b: a ** b, "~": lambda a, b: str(a) + str(b)}
_SUPPORTED_TAGS = ("if", "elif", "else", "endif", "for", "endfor", "set", "break", "continue")


class _Parser:
    def __init__(self, toks: list):
        self.toks, self.i = toks, 0
        self.names: list[str] = []  # the names the expressions parsed so far load

    def loads(self) -> list:
        """The load events of the expressions parsed since the last call."""
        out, self.names = [("load", n) for n in self.names], []
        return out

    # -- the token stream
    def peek(self, k: int = 0):
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else (None, None)

    def is_op(self, val, k: int = 0):
        return self.peek(k) == ("op", val)

    def is_name(self, val, k: int = 0):
        return self.peek(k) == ("name", val)

    def take(self):
        t = self.peek()
        if t[0] is None:
            raise TemplateError("unexpected end of a tag")
        self.i += 1
        return t

    def expect_op(self, val):
        if not self.is_op(val):
            raise TemplateError(f"expected {val!r}, got {self.peek()[1]!r}")
        self.i += 1

    def expect_name(self):
        kind, val = self.take()
        if kind != "name":
            raise TemplateError(f"expected a name, got {val!r}")
        return val

    def done(self):
        if self.i != len(self.toks):
            raise TemplateError(f"unexpected {self.peek()[1]!r}")

    # -- expressions (Jinja's grammar and precedence)
    def tuple_(self, condexpr: bool = True, explicit: bool = False):
        parse = self.condexpr if condexpr else self.or_
        items, comma = [], False
        while True:
            if items:
                if not self.is_op(","):
                    break
                self.i += 1
                comma = True
            if explicit and self.is_op(")") or self.peek()[0] is None:
                break
            items.append(parse())
        if not comma and len(items) == 1:
            return items[0]
        if not comma and not explicit:
            raise TemplateError("expected an expression")
        return lambda s: tuple(f(s) for f in items)

    def condexpr(self):
        expr = self.or_()
        while self.is_name("if"):
            self.i += 1
            test = self.or_()
            other = None
            if self.is_name("else"):
                self.i += 1
                other = self.condexpr()
            expr = (lambda a, t, b: lambda s: a(s) if t(s) else
                    (b(s) if b else Undefined("the else branch")))(expr, test, other)
        return expr

    def or_(self):
        left = self.and_()
        while self.is_name("or"):
            self.i += 1
            left = (lambda a, b: lambda s: a(s) or b(s))(left, self.and_())
        return left

    def and_(self):
        left = self.not_()
        while self.is_name("and"):
            self.i += 1
            left = (lambda a, b: lambda s: a(s) and b(s))(left, self.not_())
        return left

    def not_(self):
        if self.is_name("not"):
            self.i += 1
            inner = self.not_()
            return lambda s: not inner(s)
        return self.compare()

    def compare(self):
        first = self.binary(0)
        ops = []
        while True:
            kind, val = self.peek()
            if kind == "op" and val in ("==", "!=", "<", "<=", ">", ">="):
                self.i += 1
            elif self.is_name("in"):
                self.i += 1
            elif self.is_name("not") and self.is_name("in", 1):
                self.i += 2
                val = "notin"
            else:
                break
            ops.append((_CMP[val], self.binary(0)))
        if not ops:
            return first

        def chain(s):
            a = first(s)
            for op, f in ops:
                b = f(s)
                if not op(a, b):
                    return False
                a = b
            return True
        return chain

    # math1 (+ -), concat (~), math2 (* / // %), pow (**), as Jinja nests them
    _LEVELS = (("+", "-"), ("~",), ("*", "/", "//", "%"), ("**",))

    def binary(self, level: int):
        if level == len(self._LEVELS):
            return self.unary()
        left = self.binary(level + 1)
        while self.peek()[0] == "op" and self.peek()[1] in self._LEVELS[level]:
            op = _MATH[self.take()[1]]
            left = (lambda o, a, b: lambda s: o(a(s), b(s)))(op, left, self.binary(level + 1))
        return left

    def unary(self, with_filter: bool = True):
        if self.is_op("-") or self.is_op("+"):
            neg = self.take()[1] == "-"
            inner = self.unary(False)
            node = (lambda s: -inner(s)) if neg else (lambda s: +inner(s))
        else:
            node = self.primary()
        node = self.postfix(node)
        return self.filters(node) if with_filter else node

    def primary(self):
        kind, val = self.take()
        if kind == "name":
            if val in ("true", "True", "false", "False", "none", "None"):
                const = {"t": True, "T": True, "f": False, "F": False}.get(val[0])
                return lambda s: const
            self.names.append(val)
            return lambda s: s.lookup(val)
        if kind == "str":
            while self.peek()[0] == "str":  # adjacent strings concatenate
                val += self.take()[1]
            return lambda s: val
        if kind in ("int", "float"):
            return lambda s: val
        if val == "(":
            node = self.tuple_(explicit=True)
            self.expect_op(")")
            return node
        if val == "[":
            items = self.items("]", self.condexpr)
            return lambda s: [f(s) for f in items]
        if val == "{":
            def pair():
                k = self.condexpr()
                self.expect_op(":")
                return k, self.condexpr()
            pairs = self.items("}", pair)
            return lambda s: {k(s): v(s) for k, v in pairs}
        raise TemplateError(f"unexpected {val!r}")

    def items(self, close, parse):
        out = []
        while not self.is_op(close):
            if out:
                self.expect_op(",")
                if self.is_op(close):
                    break
            out.append(parse())
        self.i += 1
        return out

    def postfix(self, node):
        while True:
            if self.is_op("."):
                self.i += 1
                kind, val = self.take()
                if kind == "name":
                    node = (lambda n, a: lambda s: _getattr(n(s), a))(node, val)
                elif kind == "int":
                    node = (lambda n, k: lambda s: _getitem(n(s), k))(node, val)
                else:
                    raise TemplateError(f"unexpected {val!r} after '.'")
            elif self.is_op("["):
                self.i += 1
                key = self.subscript()
                self.expect_op("]")
                node = (lambda n, k: lambda s: _getitem(n(s), k(s)))(node, key)
            elif self.is_op("("):
                node = self.call(node)
            else:
                return node

    def subscript(self):
        parts, cur = [], None
        while True:
            if self.is_op(":"):
                self.i += 1
                parts.append(cur)
                cur = None
            elif self.is_op("]"):
                break
            else:
                if cur is not None:
                    raise TemplateError("a subscript of several values is not supported")
                cur = self.condexpr()
        if not parts:
            if cur is None:
                raise TemplateError("an empty subscript")
            return cur
        parts.append(cur)
        if len(parts) > 3:
            raise TemplateError("a slice of more than three parts")
        parts += [None] * (3 - len(parts))
        return lambda s: slice(*(p(s) if p else None for p in parts))

    def args(self):
        self.expect_op("(")
        args, kwargs = [], []
        while not self.is_op(")"):
            if args or kwargs:
                self.expect_op(",")
                if self.is_op(")"):
                    break
            if self.is_op("*") or self.is_op("**"):
                raise TemplateError("*args and **kwargs in a call are not supported")
            if self.peek()[0] == "name" and self.is_op("=", 1):
                name = self.take()[1]
                self.i += 1
                kwargs.append((name, self.condexpr()))
            elif kwargs:
                raise TemplateError("a positional argument after a keyword argument")
            else:
                args.append(self.condexpr())
        self.i += 1
        return args, kwargs

    def call(self, node):
        args, kwargs = self.args()
        return lambda s: node(s)(*[a(s) for a in args], **{k: v(s) for k, v in kwargs})

    def filters(self, node):
        while True:
            if self.is_op("|"):
                self.i += 1
                name = self.expect_name()
                if name not in FILTERS:
                    raise TemplateError(f"the filter {name!r} is not supported")
                fn = FILTERS[name]
                args, kwargs = self.args() if self.is_op("(") else ([], [])
                node = (lambda f, n, a, kw: lambda s: f(n(s), *[x(s) for x in a],
                                                        **{k: v(s) for k, v in kw})
                        )(fn, node, args, kwargs)
            elif self.is_name("is"):
                node = self.test(node)
            elif self.is_op("("):
                node = self.call(node)
            else:
                return node

    def test(self, node):
        self.i += 1
        negated = self.is_name("not")
        self.i += negated
        name = self.expect_name()
        if name not in TESTS:
            raise TemplateError(f"the test {name!r} is not supported")
        kind, val = self.peek()
        if self.is_op("(") or (kind in ("name", "str", "int", "float") or val in ("[", "{")) \
                and val not in ("else", "or", "and"):
            raise TemplateError(f"arguments of the test {name!r} are not supported")
        fn = TESTS[name]
        return (lambda s: not fn(node(s))) if negated else (lambda s: fn(node(s)))

    # -- assignment targets: names, a tuple of names, or namespace.attr
    def target(self, allow_attr: bool):
        names = [self.expect_name()]
        if allow_attr and self.is_op("."):
            self.i += 1
            return ("attr", names[0], self.expect_name())
        while self.is_op(","):
            self.i += 1
            names.append(self.expect_name())
        return ("names", names)


def _assign(scope: _Scope, frame: dict, target, value):
    if target[0] == "attr":
        ns = scope.lookup(target[1])
        if not isinstance(ns, Namespace):
            raise TemplateError("cannot assign attribute on non-namespace object")
        ns[target[2]] = value
        return
    names = target[1]
    if len(names) == 1:
        frame[names[0]] = value
        return
    values = tuple(value)
    if len(values) != len(names):
        raise TemplateError(f"cannot unpack {len(values)} values into {len(names)} names")
    frame.update(zip(names, values))


def _body(segments: list, pos: int, ends: tuple, loops: int):
    """Compile statements from segments[pos] until a block tag named in
    `ends`; returns (statements, their symbol events, position of that tag,
    its parser, its name)."""
    stmts, events = [], []
    while pos < len(segments):
        kind, val = segments[pos]
        if kind == "text":
            stmts.append((lambda t: lambda s, out: out.append(t))(val))
            pos += 1
            continue
        p = _Parser(val)
        if kind == "var":
            expr = p.tuple_()
            p.done()
            stmts.append((lambda e: lambda s, out: out.append(str(e(s))))(expr))
            events += p.loads()
            pos += 1
            continue
        if p.peek()[0] != "name":
            raise TemplateError("a block tag without a name")
        tag = p.take()[1]
        if tag in ends:
            return stmts, events, pos, p, tag
        if tag not in _SUPPORTED_TAGS or tag in ("elif", "else", "endif", "endfor"):
            raise TemplateError(f"{{% {tag} %}} is not supported here")
        stmt, evs, pos = _STATEMENTS[tag](segments, pos + 1, p, loops)
        stmts.append(stmt)
        events += evs
    if ends:
        raise TemplateError(f"missing {{% {ends[-1]} %}}")
    return stmts, events, pos, None, None


def _run(stmts, scope, out):
    for st in stmts:
        st(scope, out)


def _if(segments, pos, p, loops):
    branches, elifs, other = [], [], []
    test = p.tuple_(condexpr=False)
    test_events = p.loads()
    p.done()
    tag = "if"
    while tag != "endif":
        body, evs, pos, p, nxt = _body(segments, pos, ("elif", "else", "endif"), loops)
        branches.append((test, body))
        if tag == "if":
            first = evs
        elif tag == "elif":
            elifs.append(("if", elif_events, [evs, [], []]))
        else:
            other = evs
        if nxt == "elif":
            test = p.tuple_(condexpr=False)
            elif_events = p.loads()
        elif nxt == "else":
            test = None
        if tag == "else" and nxt != "endif":
            raise TemplateError(f"{{% {nxt} %}} after {{% else %}}")
        tag = nxt
        p.done()
        pos += 1

    def run(scope, out):
        for t, body in branches:
            if t is None or t(scope):
                _run(body, scope, out)
                return
    return run, [("if", test_events, [first, elifs, other])], pos


class _ForFrames:
    """A loop's frames: the body's (entered each iteration), the filter's and
    the else branch's, planned once the enclosing frame is known."""

    def __init__(self, targets, body_events, test_events, else_events):
        self.targets, self.body_events = targets, body_events
        self.test_events, self.else_events = test_events, else_events
        self.body = self.test = self.other = ()

    def analyze(self, parent: _Symbols):
        body = _Symbols(parent)
        body.param("loop")
        for t in self.targets:
            body.param(t)
        fors: list = []
        body.visit(self.body_events, fors)
        self.body = body.plan()
        test = _Symbols(parent)
        for t in self.targets:
            test.param(t)
        test.visit(self.test_events, [])
        self.test = test.plan()
        other = _Symbols(parent)
        other_fors: list = []
        other.visit(self.else_events, other_fors)
        self.other = other.plan()
        for f in fors:
            f.analyze(body)
        for f in other_fors:
            f.analyze(other)


def _for(segments, pos, p, loops):
    target = p.target(allow_attr=False)
    if not p.is_name("in"):
        raise TemplateError("expected 'in' in a for tag")
    p.i += 1
    iterable = p.tuple_(condexpr=False)
    iter_events = p.loads()
    cond = None
    if p.is_name("if"):
        p.i += 1
        cond = p.tuple_(condexpr=False)
    test_events = p.loads()
    if p.is_name("recursive"):
        raise TemplateError("recursive loops are not supported")
    p.done()
    body, body_events, pos, p, tag = _body(segments, pos, ("else", "endfor"), loops + 1)
    p.done()
    pos += 1
    otherwise, else_events = [], []
    if tag == "else":
        otherwise, else_events, pos, p, _ = _body(segments, pos, ("endfor",), loops)
        p.done()
        pos += 1
    frames = _ForFrames(target[1], body_events, test_events, else_events)

    def run(scope, out):
        items = list(iterable(scope))
        if cond is not None:
            frame = scope.enter(frames.test)
            try:
                kept = []
                for item in items:
                    _assign(scope, frame, target, item)
                    if cond(scope):
                        kept.append(item)
            finally:
                scope.frames.pop()
            items = kept
        completed = False  # as in Jinja, else runs unless a body ran to its end
        for i, item in enumerate(items):
            frame = scope.enter(frames.body)
            frame["loop"] = _Loop(items, i)
            try:
                _assign(scope, frame, target, item)
                _run(body, scope, out)
                completed = True
            except _Continue:
                pass
            except _Break:
                break
            finally:
                scope.frames.pop()
        if not completed and otherwise:
            scope.enter(frames.other)
            try:
                _run(otherwise, scope, out)
            finally:
                scope.frames.pop()
    return run, [("for", iter_events, frames)], pos


def _set(segments, pos, p, loops):
    target = p.target(allow_attr=True)
    if not p.is_op("="):
        raise TemplateError("{% set %} blocks are not supported (only set x = ...)")
    p.i += 1
    value = p.tuple_()
    p.done()
    events = p.loads()  # the value first, then the target, as Jinja visits them
    events += [("load", target[1])] if target[0] == "attr" else \
        [("store", n) for n in target[1]]
    return (lambda scope, out: _assign(scope, scope.frames[-1], target, value(scope))), \
        events, pos


def _loop_control(exc):
    def parse(segments, pos, p, loops):
        p.done()
        if not loops:
            raise TemplateError(f"{exc.__name__[1:].lower()} outside a loop")

        def run(scope, out):
            raise exc()
        return run, [], pos
    return parse


_STATEMENTS = {"if": _if, "for": _for, "set": _set, "break": _loop_control(_Break),
               "continue": _loop_control(_Continue)}


@functools.lru_cache(maxsize=64)
def compile_template(src: str):
    """The template's statements and its top frame's plan, compiled once per
    source."""
    stmts, events = _body(_lex(src), 0, (), 0)[:2]
    root, fors = _Symbols(), []
    root.visit(events, fors)
    for f in fors:
        f.analyze(root)
    return stmts, root.plan()


def render(src: str, ctx: dict) -> str:
    stmts, plan = compile_template(src)
    scope, out = _Scope(ctx), []
    scope.enter(plan)
    _run(stmts, scope, out)
    return "".join(out)
