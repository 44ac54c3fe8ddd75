"""A jsonnet evaluator for the subset robogym's configs use.

Counterpart of `robogym_tpu/utils/jsonnet.py`, copied so that the port
depends on nothing of the JAX package. robogym evaluates its holdout and
material configs with the C++ `_jsonnet` library; this pure-Python module
implements the subset of jsonnet those configs use:

  * object literals with `:` / hidden `::` / merge `+:` fields
  * object composition `+` with late-bound `$` (root of the final merged
    object) and `self`
  * `local` bindings (top-level, in objects, and in expressions)
  * `import "file"` (relative to the importing file)
  * conditional fields `[if cond then 'name']: value`, `if/then/else`
  * `assert cond : message` (top-level object asserts)
  * arithmetic/comparison/boolean operators, string concat with `+`
  * arrays, indexing, field access
  * std.floor, std.length, std.format / `%`, std.join, std.ceil, std.max,
    std.min, std.abs

It is an eager evaluator with lazy object fields (thunks memoized per
object). Not supported: functions/closures, std.* beyond the list above,
`super`, tailstrict.
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|//[^\n]*|\#[^\n]*|/\*.*?\*/)
  | (?P<num>\d+\.\d+|\d+|\.\d+)
  | (?P<id>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<str>'(?:\\.|[^'\\])*'|"(?:\\.|[^"\\])*")
  | (?P<op>\|\||&&|==|!=|<=|>=|\+:+|::|[{}\[\]():,;.+\-*/%<>=!$])
    """,
    re.VERBOSE | re.DOTALL,
)

KEYWORDS = {
    "local", "import", "importstr", "if", "then", "else", "true", "false",
    "null", "self", "assert", "function", "super", "error", "in",
}


def _lex(src: str) -> List[Tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise SyntaxError(f"jsonnet lex error at {src[pos:pos+30]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        val = m.group()
        kind = m.lastgroup
        if kind == "id" and val in KEYWORDS:
            kind = "kw"
        out.append((kind, val))
    out.append(("eof", ""))
    return out


# ---------------------------------------------------------------------------
# AST  (tuples: (tag, ...))
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val):
        k, v = self.next()
        if v != val:
            raise SyntaxError(f"jsonnet: expected {val!r}, got {v!r}")

    def accept(self, val) -> bool:
        if self.peek()[1] == val:
            self.next()
            return True
        return False

    # -- expression grammar -------------------------------------------------
    def parse(self):
        e = self.expr()
        if self.peek()[0] != "eof":
            raise SyntaxError(f"jsonnet: trailing tokens {self.peek()!r}")
        return e

    def expr(self):
        if self.peek()[1] == "local":
            self.next()
            binds = [self.bind()]
            while self.accept(","):
                binds.append(self.bind())
            self.expect(";")
            body = self.expr()
            return ("local", binds, body)
        if self.peek()[1] == "assert":
            self.next()
            cond = self.expr()
            msg = None
            if self.accept(":"):
                msg = self.expr()
            self.expect(";")
            body = self.expr()
            return ("assert", cond, msg, body)
        if self.peek()[1] == "if":
            self.next()
            cond = self.expr()
            self.expect("then")
            then = self.expr()
            els = ("lit", None)
            if self.accept("else"):
                els = self.expr()
            return ("if", cond, then, els)
        return self.or_()

    def bind(self):
        k, name = self.next()
        assert k == "id", f"bad local bind {name!r}"
        self.expect("=")
        return (name, self.expr())

    def or_(self):
        e = self.and_()
        while self.peek()[1] == "||":
            self.next()
            e = ("or", e, self.and_())
        return e

    def and_(self):
        e = self.cmp()
        while self.peek()[1] == "&&":
            self.next()
            e = ("and", e, self.cmp())
        return e

    def cmp(self):
        e = self.add()
        if self.peek()[1] in ("==", "!=", "<", "<=", ">", ">="):
            op = self.next()[1]
            e = ("cmp", op, e, self.add())
        return e

    def add(self):
        e = self.mul()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            e = ("bin", op, e, self.mul())
        return e

    def mul(self):
        e = self.unary()
        while self.peek()[1] in ("*", "/", "%"):
            op = self.next()[1]
            e = ("bin", op, e, self.unary())
        return e

    def unary(self):
        if self.peek()[1] == "-":
            self.next()
            return ("neg", self.unary())
        if self.peek()[1] == "!":
            self.next()
            return ("not", self.unary())
        return self.postfix()

    def postfix(self):
        e = self.primary()
        while True:
            if self.accept("."):
                k, name = self.next()
                e = ("index", e, ("lit", name))
            elif self.peek()[1] == "[":
                self.next()
                idx = self.expr()
                self.expect("]")
                e = ("index", e, idx)
            elif self.peek()[1] == "(":
                self.next()
                args = []
                if self.peek()[1] != ")":
                    args.append(self.expr())
                    while self.accept(","):
                        args.append(self.expr())
                self.expect(")")
                e = ("call", e, args)
            else:
                return e

    def primary(self):
        kind, val = self.peek()
        if val == "{":
            return self.object_()
        if val == "[":
            self.next()
            items = []
            if self.peek()[1] != "]":
                items.append(self.expr())
                if self.peek()[1] == "for":
                    # array comprehension: [ expr for ident in arr ]
                    self.next()
                    k, name = self.next()
                    assert k == "id", name
                    self.expect("in")
                    arr = self.expr()
                    self.expect("]")
                    return ("comp", items[0], name, arr)
                while self.accept(","):
                    if self.peek()[1] == "]":
                        break
                    items.append(self.expr())
            self.expect("]")
            return ("array", items)
        if val == "(":
            self.next()
            e = self.expr()
            self.expect(")")
            return e
        if val == "$":
            self.next()
            return ("dollar",)
        if kind == "num":
            self.next()
            return ("lit", float(val) if "." in val else int(val))
        if kind == "str":
            self.next()
            return ("lit", _unquote(val))
        if val in ("true", "false"):
            self.next()
            return ("lit", val == "true")
        if val == "null":
            self.next()
            return ("lit", None)
        if val == "self":
            self.next()
            return ("self",)
        if val in ("import", "importstr"):
            self.next()
            k2, v2 = self.next()
            assert k2 == "str"
            return ("import" if val == "import" else "importstr", _unquote(v2))
        if val == "if":
            return self.expr()
        if kind == "id":
            self.next()
            return ("var", val)
        raise SyntaxError(f"jsonnet: unexpected token {val!r}")

    def object_(self):
        self.expect("{")
        fields = []   # (key_expr_or_name, op, hidden, value_expr, cond_expr)
        locals_ = []
        asserts = []
        while self.peek()[1] != "}":
            if self.peek()[1] == "local":
                self.next()
                locals_.append(self.bind())
            elif self.peek()[1] == "assert":
                self.next()
                cond = self.expr()
                msg = None
                if self.accept(":"):
                    msg = self.expr()
                asserts.append((cond, msg))
            else:
                fields.append(self.field())
            if not self.accept(","):
                break
        self.expect("}")
        return ("object", fields, locals_, asserts)

    def field(self):
        kind, val = self.peek()
        cond = None
        if val == "[":
            # [expr]: value  or  [if cond then 'key']: value
            self.next()
            if self.peek()[1] == "if":
                self.next()
                cond = self.expr()
                self.expect("then")
                key = self.expr()
            else:
                key = self.expr()
            self.expect("]")
        elif kind in ("id", "str") or kind == "kw":
            self.next()
            key = ("lit", _unquote(val) if kind == "str" else val)
        else:
            raise SyntaxError(f"jsonnet: bad field {val!r}")
        op = self.next()[1]
        if op not in (":", "::", "+:", "+::"):
            raise SyntaxError(f"jsonnet: bad field op {op!r}")
        value = self.expr()
        return (key, op, value, cond)


def _unquote(s: str) -> str:
    if s and s[0] in "'\"":
        body = s[1:-1]
        return (
            body.replace("\\n", "\n").replace("\\t", "\t")
            .replace("\\'", "'").replace('\\"', '"').replace("\\\\", "\\")
        )
    return s


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------


class JsonnetObject:
    """Lazy object: ordered field bindings; merging appends bindings."""

    def __init__(self, layers):
        # layers: list of dicts: key -> (op, hidden, expr, env) in merge order
        self.layers = layers
        self._cache: Dict[str, Any] = {}
        self.root: Optional["JsonnetObject"] = None  # set at materialization

    def keys(self, include_hidden=False):
        seen = []
        for layer in self.layers:
            for k, (op, hidden, expr, env) in layer.items():
                if k not in seen and (include_hidden or not self._hidden(k)):
                    seen.append(k)
        return seen

    def _hidden(self, key) -> bool:
        h = False
        for layer in self.layers:
            if key in layer:
                op, hidden, expr, env = layer[key]
                h = hidden
        return h

    def lookup(self, key):
        if key in self._cache:
            return self._cache[key]
        vals = []
        for layer in self.layers:
            if key in layer:
                vals.append(layer[key])
        if not vals:
            raise KeyError(key)
        # evaluate last binding; `+:` merges with what came before
        result = None
        have = False
        for op, hidden, expr, env in vals:
            v = _eval(expr, dict(env, __self=self, __root=self.root or self))
            if op.startswith("+") and have:
                result = _merge_values(result, v)
            else:
                result = v
                have = True
        self._cache[key] = result
        return result

    def to_python(self):
        return {k: _to_python(self.lookup(k)) for k in self.keys()}


def _merge_values(a, b):
    if isinstance(a, JsonnetObject) and isinstance(b, JsonnetObject):
        merged = JsonnetObject(a.layers + b.layers)
        # `$` binding: a top-level merge is its own root; merging NESTED
        # objects (e.g. `make_env +: {...}`) must keep the enclosing root
        if a.root is not None and a.root is not a:
            merged.root = a.root
        elif b.root is not None and b.root is not b:
            merged.root = b.root
        else:
            merged.root = merged
        return merged
    if isinstance(a, dict) and isinstance(b, dict):
        out = dict(a)
        out.update(b)
        return out
    if isinstance(a, list) and isinstance(b, list):
        return a + b
    if isinstance(a, str) or isinstance(b, str):
        return _to_str(a) + _to_str(b)
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a + b
    return b


def _to_str(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v == int(v):
        return str(int(v))
    return str(v)


def _to_python(v):
    if isinstance(v, JsonnetObject):
        return v.to_python()
    if isinstance(v, list):
        return [_to_python(x) for x in v]
    return v


def _std_call(name, args):
    if name == "floor":
        return math.floor(args[0])
    if name == "ceil":
        return math.ceil(args[0])
    if name == "length":
        a = args[0]
        return len(a.keys()) if isinstance(a, JsonnetObject) else len(a)
    if name == "abs":
        return abs(args[0])
    if name == "max":
        return max(args[0], args[1])
    if name == "min":
        return min(args[0], args[1])
    if name == "join":
        sep, arr = args
        return sep.join(_to_str(x) for x in arr)
    if name == "format":
        fmt, vals = args
        if isinstance(vals, list):
            return fmt % tuple(vals)
        return fmt % vals
    if name == "toString":
        return _to_str(args[0])
    raise NotImplementedError(f"std.{name} not in the jsonnet subset")


def _eval(node, env):
    tag = node[0]
    if tag == "lit":
        return node[1]
    if tag == "array":
        return [_eval(e, env) for e in node[1]]
    if tag == "object":
        fields, locals_, asserts = node[1], node[2], node[3]
        obj_env = dict(env)
        layer = {}
        obj = JsonnetObject([layer])
        # nested object literals inherit the enclosing root for `$`;
        # top-level objects are their own root until merged
        obj.root = env.get("__root") or obj
        # locals see self/$ of THIS object
        for name, expr in locals_:
            obj_env[name] = ("__thunk", expr, obj)
        for key, op, value, cond in fields:
            if cond is not None and not _truthy(_eval(cond, dict(
                    obj_env, __self=obj, __root=obj.root))):
                continue
            kname = _eval(key, dict(obj_env, __self=obj, __root=obj.root))
            hidden = op in ("::", "+::")
            fop = "+:" if op.startswith("+") else ":"
            layer[kname] = (fop, hidden, value, obj_env)
        for cond, msg in asserts:
            pass  # asserts checked lazily at materialization (see evaluate())
        obj._asserts = [(c, m, obj_env) for c, m in asserts]
        return obj
    if tag == "local":
        new_env = dict(env)
        for name, expr in node[1]:
            new_env[name] = ("__thunk", expr, None)
        return _eval(node[2], new_env)
    if tag == "assert":
        cond = _eval(node[1], env)
        if not _truthy(cond):
            msg = _eval(node[2], env) if node[2] else "assert failed"
            raise AssertionError(f"jsonnet assert: {msg}")
        return _eval(node[3], env)
    if tag == "if":
        return (
            _eval(node[2], env) if _truthy(_eval(node[1], env))
            else _eval(node[3], env)
        )
    if tag == "var":
        name = node[1]
        if name == "std":
            return ("__std",)
        if name in env:
            v = env[name]
            if isinstance(v, tuple) and v and v[0] == "__thunk":
                _, expr, obj = v
                e2 = dict(env)
                if obj is not None:
                    e2["__self"] = obj
                    e2["__root"] = obj.root or obj
                return _eval(expr, e2)
            return v
        raise NameError(f"jsonnet: unknown variable {name!r}")
    if tag == "self":
        return env["__self"]
    if tag == "dollar":
        return env["__root"]
    if tag == "index":
        base = _eval(node[1], env)
        key = _eval(node[2], env)
        if isinstance(base, tuple) and base == ("__std",):
            return ("__stdfn", key)
        if isinstance(base, JsonnetObject):
            return base.lookup(key)
        return base[key]
    if tag == "call":
        fn = _eval(node[1], env)
        args = [_eval(a, env) for a in node[2]]
        if isinstance(fn, tuple) and fn[0] == "__stdfn":
            return _std_call(fn[1], args)
        raise NotImplementedError("jsonnet subset: only std.* calls")
    if tag == "neg":
        return -_eval(node[1], env)
    if tag == "not":
        return not _truthy(_eval(node[1], env))
    if tag == "and":
        return _truthy(_eval(node[1], env)) and _truthy(_eval(node[2], env))
    if tag == "or":
        return _truthy(_eval(node[1], env)) or _truthy(_eval(node[2], env))
    if tag == "cmp":
        op, a, b = node[1], _eval(node[2], env), _eval(node[3], env)
        if op == "==":
            return a == b
        if op == "!=":
            return a != b
        if op == "<":
            return a < b
        if op == "<=":
            return a <= b
        if op == ">":
            return a > b
        return a >= b
    if tag == "bin":
        op = node[1]
        a = _eval(node[2], env)
        b = _eval(node[3], env)
        if op == "+":
            return _merge_values(a, b)
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            return a / b
        if op == "%":
            if isinstance(a, str):
                return _std_call("format", [a, b])
            return a % b
    if tag == "comp":
        body, name, arr = node[1], node[2], node[3]
        out = []
        for item in _eval(arr, env):
            out.append(_eval(body, dict(env, **{name: item})))
        return out
    if tag == "import":
        path = node[1]
        base = env.get("__file__")
        # resolve relative to the importing file, falling back to ancestor
        # directories (robogym's configs import "base.libsonnet" from
        # nested dirs, resolved by _jsonnet's library path)
        full = path
        if base:
            d = os.path.dirname(os.path.abspath(base))
            while True:
                cand = os.path.normpath(os.path.join(d, path))
                if os.path.exists(cand):
                    full = cand
                    break
                parent = os.path.dirname(d)
                if parent == d:
                    break
                d = parent
        return _eval_file_expr(full, env)
    if tag == "importstr":
        base = env.get("__file__")
        full = os.path.normpath(os.path.join(os.path.dirname(base), node[1]))
        with open(full) as f:
            return f.read()
    raise NotImplementedError(f"jsonnet node {tag!r}")


def _truthy(v) -> bool:
    return bool(v)


_import_cache: Dict[str, Any] = {}


def _eval_file_expr(path: str, env):
    ast = _Parser(_lex(open(path).read())).parse()
    return _eval(ast, {"__file__": path})


def evaluate_file(path: str) -> Any:
    """Evaluate a .jsonnet/.libsonnet file to plain Python data."""
    result = _eval_file_expr(os.path.abspath(path), {})
    if isinstance(result, JsonnetObject):
        result.root = result
        for cond, msg, env in getattr(result, "_asserts", []):
            if not _truthy(_eval(cond, dict(
                    env, __self=result, __root=result))):
                m = _eval(msg, dict(env, __self=result, __root=result)) \
                    if msg else "assert failed"
                raise AssertionError(f"jsonnet assert: {m}")
        return result.to_python()
    return _to_python(result)


def evaluate_snippet(src: str, path: str = "<snippet>") -> Any:
    result = _eval(_Parser(_lex(src)).parse(), {"__file__": path})
    if isinstance(result, JsonnetObject):
        result.root = result
        return result.to_python()
    return _to_python(result)
