"""CEL-subset evaluator for DRA device selectors (the JAX package's
``pkg/cel.py``, kept here as the port's own copy: the same subset, the
same errors at compile and at evaluation; ``tests/test_torch_cel.py``
holds the two to equal answers).

The scheduler side of DRA evaluates each ``selectors[].cel.expression``
against a ``device`` variable (KEP-4381; upstream
k8s.io/dynamic-resource-allocation/cel/compile.go builds the real env).
The reference driver never evaluates CEL itself -- it only *emits*
devices and lets kube-scheduler match them -- but proving our published
slices against our shipped selectors requires a scheduler, and a
scheduler requires an evaluator. This implements the grammar that DRA
selectors actually use:

- literals: strings, ints, floats, booleans
- ``device.driver``, ``device.attributes["<driver>"].<name>`` (and
  index form), ``device.capacity["<driver>"].<name>``
- ``"name" in device.attributes["<driver>"]``
- ``!``, ``&&``, ``||`` with CEL's error-absorption semantics
  (``false && error == false``, ``true || error == true``)
- comparisons ``== != < <= > >=``
- ``quantity("1Gi")`` and quantity methods ``compareTo``,
  ``isGreaterThan``, ``isLessThan``, ``asInteger``
- string methods ``matches``, ``startsWith``, ``endsWith``,
  ``contains``

Attribute values arrive in DRA's typed-union wire form
(``{"string": s} | {"int": n} | {"bool": b} | {"version": v}``) and are
unwrapped to CEL scalars, mirroring the real env's attribute binding.

Anything outside the subset raises ``CelParseError`` at compile time --
loud, so a selector we cannot faithfully evaluate is a test failure,
not a silent mismatch.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from functools import lru_cache


class CelParseError(Exception):
    """The expression is outside the supported CEL subset."""


class CelEvalError(Exception):
    """Runtime evaluation error (missing key, type mismatch).

    Real CEL propagates errors unless absorbed by && / ||; the DRA
    scheduler treats an errored selector as "device does not match".
    """


# -- quantities ---------------------------------------------------------------

_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<digits>[0-9]+(?:\.[0-9]+)?)"
    r"(?P<suffix>Ki|Mi|Gi|Ti|Pi|Ei|k|M|G|T|P|E|m|)$")

_SUFFIX = {
    "": 1, "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12,
    "P": 10**15, "E": 10**18,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40,
    "Pi": 2**50, "Ei": 2**60,
}


@dataclass(frozen=True)
class Quantity:
    """A k8s resource.Quantity scaled to milli-units internally so the
    ``m`` suffix and decimal forms compare exactly."""

    milli: int

    @classmethod
    def parse(cls, s: str) -> "Quantity":
        s = str(s).strip()
        # Scientific notation (129e6) used by canonical quantities.
        m = re.match(r"^([+-]?[0-9]+(?:\.[0-9]+)?)e([0-9]+)$", s)
        if m:
            return cls(milli=int(float(m.group(1)) * 10**int(m.group(2))
                                 * 1000))
        m = _QUANTITY_RE.match(s)
        if not m:
            raise CelEvalError(f"unparseable quantity {s!r}")
        sign = -1 if m.group("sign") == "-" else 1
        digits = m.group("digits")
        suffix = m.group("suffix")
        if suffix == "m":
            if "." in digits:
                raise CelEvalError(f"fractional milli quantity {s!r}")
            return cls(milli=sign * int(digits))
        scale = _SUFFIX[suffix]
        value = float(digits) if "." in digits else int(digits)
        return cls(milli=int(sign * value * scale * 1000))

    def compare_to(self, other: "Quantity") -> int:
        return (self.milli > other.milli) - (self.milli < other.milli)

    def as_integer(self) -> int:
        if self.milli % 1000:
            raise CelEvalError("asInteger() on fractional quantity")
        return self.milli // 1000


# -- lexer --------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<string>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')
  | (?P<float>[0-9]+\.[0-9]+)
  | (?P<int>[0-9]+)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>&&|\|\||==|!=|<=|>=|[!<>()\[\].,])
""", re.VERBOSE)

_KEYWORDS = {"true": True, "false": False}


def _lex(src: str) -> list[tuple[str, object]]:
    out: list[tuple[str, object]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise CelParseError(f"bad character at {pos}: {src[pos:pos+10]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        if kind == "string":
            body = text[1:-1]
            out.append(("string", re.sub(r"\\(.)", r"\1", body)))
        elif kind == "float":
            out.append(("number", float(text)))
        elif kind == "int":
            out.append(("number", int(text)))
        elif kind == "ident":
            if text in _KEYWORDS:
                out.append(("bool", _KEYWORDS[text]))
            elif text == "in":
                out.append(("op", "in"))
            else:
                out.append(("ident", text))
        else:
            out.append(("op", text))
    out.append(("eof", None))
    return out


# -- parser (precedence climbing) --------------------------------------------

# AST nodes: ("lit", v) ("var", name) ("member", obj, name)
# ("index", obj, key) ("call", obj_or_None, name, args)
# ("not", e) ("and", l, r) ("or", l, r) ("cmp", op, l, r) ("in", l, r)


class _Parser:
    def __init__(self, tokens: list[tuple[str, object]]):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        tok = self.toks[self.i]
        self.i += 1
        return tok

    def expect_op(self, op: str):
        kind, val = self.next()
        if kind != "op" or val != op:
            raise CelParseError(f"expected {op!r}, got {val!r}")

    def parse(self):
        e = self.parse_or()
        if self.peek()[0] != "eof":
            raise CelParseError(f"trailing tokens at {self.peek()!r}")
        return e

    def parse_or(self):
        left = self.parse_and()
        while self.peek() == ("op", "||"):
            self.next()
            left = ("or", left, self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_cmp()
        while self.peek() == ("op", "&&"):
            self.next()
            left = ("and", left, self.parse_cmp())
        return left

    _CMP = {"==", "!=", "<", "<=", ">", ">="}

    def parse_cmp(self):
        left = self.parse_unary()
        kind, val = self.peek()
        if kind == "op" and val in self._CMP:
            self.next()
            return ("cmp", val, left, self.parse_unary())
        if kind == "op" and val == "in":
            self.next()
            return ("in", left, self.parse_unary())
        return left

    def parse_unary(self):
        if self.peek() == ("op", "!"):
            self.next()
            return ("not", self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self):
        e = self.parse_primary()
        while True:
            kind, val = self.peek()
            if (kind, val) == ("op", "."):
                self.next()
                nkind, name = self.next()
                if nkind != "ident":
                    raise CelParseError(f"expected member name, got {name!r}")
                if self.peek() == ("op", "("):
                    e = ("call", e, name, self.parse_args())
                else:
                    e = ("member", e, name)
            elif (kind, val) == ("op", "["):
                self.next()
                key = self.parse_or()
                self.expect_op("]")
                e = ("index", e, key)
            else:
                return e

    def parse_args(self):
        self.expect_op("(")
        args = []
        if self.peek() != ("op", ")"):
            args.append(self.parse_or())
            while self.peek() == ("op", ","):
                self.next()
                args.append(self.parse_or())
        self.expect_op(")")
        return args

    def parse_primary(self):
        kind, val = self.next()
        if kind in ("string", "number", "bool"):
            return ("lit", val)
        if kind == "ident":
            if self.peek() == ("op", "("):
                return ("call", None, val, self.parse_args())
            return ("var", val)
        if (kind, val) == ("op", "("):
            e = self.parse_or()
            self.expect_op(")")
            return e
        raise CelParseError(f"unexpected token {val!r}")


# -- evaluation ---------------------------------------------------------------


_UNION_KEYS = {"string", "int", "bool", "version", "value"}


@dataclass(frozen=True)
class SemVer:
    """A version-typed attribute: compares by semver components, not
    lexicographically (matching the real DRA CEL env's semver type)."""

    raw: str

    @property
    def key(self):
        core = self.raw.split("+", 1)[0]
        core, _, pre = core.partition("-")
        nums = tuple(int(p) for p in core.split(".") if p.isdigit())
        # A pre-release sorts before the release itself (semver 11).
        return (nums, 0 if pre else 1, pre)

    def compare_to(self, other: "SemVer") -> int:
        return (self.key > other.key) - (self.key < other.key)


def _unwrap_attr(value):
    """DRA typed-union attribute value -> CEL scalar; intermediate maps
    (attributes, capacity, per-driver maps) pass through unchanged.

    A union is exactly one key from the wire schema with a SCALAR
    payload -- both conditions matter, or a per-driver map containing a
    single attribute literally named "version"/"string"/... would be
    misread as a union and collapse the whole map."""
    if isinstance(value, dict) and len(value) == 1:
        key, v = next(iter(value.items()))
        if key in _UNION_KEYS and isinstance(v, (str, int, float, bool)):
            if key == "version":
                return SemVer(str(v))
            if key == "int":
                return int(v)
            if key == "value":
                return Quantity.parse(str(v))
            return v
    return value


class _Eval:
    def __init__(self, env: dict):
        self.env = env

    def run(self, node):
        op = node[0]
        return getattr(self, "_" + op)(node)

    def _lit(self, n):
        return n[1]

    def _var(self, n):
        if n[1] not in self.env:
            raise CelEvalError(f"unknown variable {n[1]!r}")
        return self.env[n[1]]

    def _member(self, n):
        obj = self.run(n[1])
        if isinstance(obj, dict):
            if n[2] not in obj:
                raise CelEvalError(f"no such key {n[2]!r}")
            return _unwrap_attr(obj[n[2]])
        raise CelEvalError(f"member access on {type(obj).__name__}")

    def _index(self, n):
        obj = self.run(n[1])
        key = self.run(n[2])
        if isinstance(obj, dict):
            if key not in obj:
                raise CelEvalError(f"no such key {key!r}")
            return _unwrap_attr(obj[key])
        raise CelEvalError(f"index on {type(obj).__name__}")

    def _not(self, n):
        v = self.run(n[1])
        if not isinstance(v, bool):
            raise CelEvalError("! on non-bool")
        return not v

    def _and(self, n):
        # CEL error absorption: false on either side wins.
        try:
            left = self.run(n[1])
        except CelEvalError:
            left = None
        if left is False:
            return False
        right = self.run(n[2])
        if right is False:
            return False
        if left is None:
            raise CelEvalError("errored && non-false")
        if not isinstance(left, bool) or not isinstance(right, bool):
            raise CelEvalError("&& on non-bool")
        return left and right

    def _or(self, n):
        try:
            left = self.run(n[1])
        except CelEvalError:
            left = None
        if left is True:
            return True
        right = self.run(n[2])
        if right is True:
            return True
        if left is None:
            raise CelEvalError("errored || non-true")
        if not isinstance(left, bool) or not isinstance(right, bool):
            raise CelEvalError("|| on non-bool")
        return left or right

    def _in(self, n):
        key = self.run(n[1])
        obj = self.run(n[2])
        if isinstance(obj, (dict, list)):
            return key in obj
        raise CelEvalError(f"'in' on {type(obj).__name__}")

    def _cmp(self, n):
        _, op, ln, rn = n
        left, right = self.run(ln), self.run(rn)
        if isinstance(left, SemVer) or isinstance(right, SemVer):
            if isinstance(left, str):
                left = SemVer(left)
            if isinstance(right, str):
                right = SemVer(right)
            if not (isinstance(left, SemVer) and isinstance(right, SemVer)):
                raise CelEvalError("version compared to non-version")
            c = left.compare_to(right)
            return {"==": c == 0, "!=": c != 0, "<": c < 0,
                    "<=": c <= 0, ">": c > 0, ">=": c >= 0}[op]
        if isinstance(left, Quantity) or isinstance(right, Quantity):
            raise CelEvalError("quantities compare via compareTo()")
        if isinstance(left, bool) != isinstance(right, bool):
            raise CelEvalError("bool compared to non-bool")
        num = (int, float)
        if not (isinstance(left, num) and isinstance(right, num)):
            if type(left) is not type(right):
                # CEL: comparing different types is an error, not False.
                raise CelEvalError(
                    f"type mismatch {type(left).__name__} {op} "
                    f"{type(right).__name__}")
        try:
            return {
                "==": left == right, "!=": left != right,
                "<": left < right, "<=": left <= right,
                ">": left > right, ">=": left >= right,
            }[op]
        except TypeError as e:  # e.g. < on bools
            raise CelEvalError(str(e)) from e

    def _call(self, n):
        _, obj_node, name, arg_nodes = n
        args = [self.run(a) for a in arg_nodes]
        if obj_node is None:
            if name == "quantity" and len(args) == 1:
                return Quantity.parse(args[0])
            if name == "semver" and len(args) == 1:
                return SemVer(str(args[0]))
            raise CelEvalError(f"unknown function {name}()")
        obj = self.run(obj_node)
        if isinstance(obj, SemVer):
            if name == "compareTo" and len(args) == 1:
                other = args[0]
                if isinstance(other, str):
                    other = SemVer(other)
                if not isinstance(other, SemVer):
                    raise CelEvalError("compareTo non-version")
                return obj.compare_to(other)
        if isinstance(obj, Quantity):
            if name == "compareTo" and len(args) == 1:
                return obj.compare_to(_as_quantity(args[0]))
            if name == "isGreaterThan" and len(args) == 1:
                return obj.compare_to(_as_quantity(args[0])) > 0
            if name == "isLessThan" and len(args) == 1:
                return obj.compare_to(_as_quantity(args[0])) < 0
            if name == "asInteger" and not args:
                return obj.as_integer()
        if isinstance(obj, str):
            if name == "matches" and len(args) == 1:
                return re.search(args[0], obj) is not None
            if name == "startsWith" and len(args) == 1:
                return obj.startswith(args[0])
            if name == "endsWith" and len(args) == 1:
                return obj.endswith(args[0])
            if name == "contains" and len(args) == 1:
                return args[0] in obj
        raise CelEvalError(
            f"unsupported method .{name}() on {type(obj).__name__}")


def _as_quantity(v) -> Quantity:
    if isinstance(v, Quantity):
        return v
    if isinstance(v, (int, str)):
        return Quantity.parse(str(v))
    raise CelEvalError(f"not a quantity: {v!r}")


@lru_cache(maxsize=1024)
def _compile_ast(expression: str):
    """Memoized lex+parse keyed by source text. Selector expressions
    repeat across candidate devices within a scheduling pass AND across
    passes (the same DeviceClass/request selectors are evaluated for
    every device every sync), so the AST is compiled once per distinct
    source string. ASTs are immutable tuples -- safe to share across
    threads and CelProgram instances. Parse failures are NOT cached
    (lru_cache does not memoize exceptions); callers that want negative
    caching layer it on top (schedcache.CompiledSelectors does)."""
    return _Parser(_lex(expression)).parse()


class CelProgram:
    """A compiled selector expression, reusable across devices."""

    def __init__(self, expression: str):
        self.expression = expression
        self._ast = _compile_ast(expression)

    def evaluate(self, env: dict):
        return _Eval(env).run(self._ast)

    def matches_device(self, device: dict, driver: str, pool: str = "",
                       node: str = "") -> bool:
        """Evaluate against a published ResourceSlice device entry.

        Builds the same ``device`` variable the scheduler binds
        (driver/attributes/capacity keyed by the owning driver name).
        Errors mean "does not match", as in the real scheduler.
        """
        env = {"device": {
            "driver": driver,
            "attributes": {driver: dict(device.get("attributes", {}))},
            "capacity": {driver: {
                name: (val if isinstance(val, dict) else {"value": val})
                for name, val in device.get("capacity", {}).items()
            }},
        }}
        try:
            result = self.evaluate(env)
        except CelEvalError:
            return False
        if not isinstance(result, bool):
            return False
        return result


def compile_expression(expression: str) -> CelProgram:
    return CelProgram(expression)
