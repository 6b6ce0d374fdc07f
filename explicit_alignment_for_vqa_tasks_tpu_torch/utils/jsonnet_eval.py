"""Dependency-free evaluator for the jsonnet subset used by our config files.

The reference evaluates configs with the `_jsonnet` C extension
(reference: src/utils/config_system.py:35). That package is not available
here, and the configs only exercise a small, well-defined subset of jsonnet:

  * ``//``, ``#`` and ``/* */`` comments
  * top-level ``local name = expr;`` bindings
  * ``import 'relative/path.jsonnet'``
  * object / array / string / number / boolean / null literals
    (object keys may be bare identifiers)
  * ``std.mergePatch(a, b)`` and a handful of other std functions
  * ``+`` on strings / numbers / arrays, and a final result expression

We evaluate that subset by translating a config file to a short Python
program and exec'ing it in a restricted namespace. This keeps full schema
parity with the reference's jsonnet configs (inheritance via
``std.mergePatch(base_env, override)``) without any native dependency.

The port's own copy of
explicit_alignment_for_vqa_tasks_tpu/utils/jsonnet_eval.py, held against it by
tests/test_torch_config.py.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, List, Optional


class JsonnetError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Source transformation
# ---------------------------------------------------------------------------

def _strip_comments(src: str) -> str:
    """Remove //, # and /* */ comments, preserving string literals."""
    out: List[str] = []
    i, n = 0, len(src)
    in_string: Optional[str] = None
    while i < n:
        ch = src[i]
        if in_string is not None:
            out.append(ch)
            if ch == "\\" and i + 1 < n:
                out.append(src[i + 1])
                i += 2
                continue
            if ch == in_string:
                in_string = None
            i += 1
            continue
        if ch in "'\"":
            in_string = ch
            out.append(ch)
            i += 1
            continue
        if ch == "/" and i + 1 < n and src[i + 1] == "/":
            while i < n and src[i] != "\n":
                i += 1
            continue
        if ch == "#":
            while i < n and src[i] != "\n":
                i += 1
            continue
        if ch == "/" and i + 1 < n and src[i + 1] == "*":
            i += 2
            while i + 1 < n and not (src[i] == "*" and src[i + 1] == "/"):
                i += 1
            i += 2
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def _split_statements(src: str) -> List[str]:
    """Split on ';' at bracket depth 0 (outside strings).

    jsonnet files have the shape ``local a = e; local b = e; final_expr``.
    """
    chunks: List[str] = []
    depth = 0
    in_string: Optional[str] = None
    start = 0
    i, n = 0, len(src)
    while i < n:
        ch = src[i]
        if in_string is not None:
            if ch == "\\":
                i += 2
                continue
            if ch == in_string:
                in_string = None
            i += 1
            continue
        if ch in "'\"":
            in_string = ch
        elif ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        elif ch == ";" and depth == 0:
            chunks.append(src[start:i])
            start = i + 1
        i += 1
    tail = src[start:]
    if tail.strip():
        chunks.append(tail)
    return chunks


_IDENT_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
_KEYWORD_MAP = {"true": "True", "false": "False", "null": "None"}

# jsonnet constructs OUTSIDE the supported subset. These must hard-error:
# a best-effort transform could silently produce a valid-but-wrong Python
# expression (e.g. a comprehension, a `self` reference, an if/else).
_UNSUPPORTED_KEYWORDS = frozenset({
    "function", "self", "super", "assert", "error", "if", "then", "else",
    "for", "in", "tailstrict", "local", "importstr", "importbin",
})


def _unsupported(construct: str, context: str) -> JsonnetError:
    return JsonnetError(
        f"unsupported jsonnet construct {construct!r} (only the documented "
        f"subset is evaluated; use the real jsonnet package for full "
        f"language support) near: {context[:60]!r}"
    )


def _transform_expr(src: str) -> str:
    """Quote bare object keys; map jsonnet keywords / std. / import to Python."""
    out: List[str] = []
    i, n = 0, len(src)
    in_string: Optional[str] = None
    last_sig = ""  # last significant (non-space) char emitted
    while i < n:
        ch = src[i]
        if in_string is not None:
            out.append(ch)
            if ch == "\\" and i + 1 < n:
                out.append(src[i + 1])
                i += 2
                continue
            if ch == in_string:
                in_string = None
            i += 1
            continue
        if ch in "'\"":
            in_string = ch
            out.append(ch)
            last_sig = ch
            i += 1
            continue
        if ch.isalpha() or ch == "_":
            j = i
            while j < n and src[j] in _IDENT_CHARS:
                j += 1
            ident = src[i:j]
            # lookahead for ':' (object key) — skip spaces
            k = j
            while k < n and src[k] in " \t":
                k += 1
            if (
                k < n
                and src[k] == ":"
                and k + 1 < n
                and src[k + 1] == ":"
                and last_sig in ("{", ",", "")
            ):
                raise _unsupported("hidden field '::'", src[i:])
            is_key = (
                k < n
                and src[k] == ":"
                and (k + 1 >= n or src[k + 1] != ":")
                and last_sig in ("{", ",", "")
            )
            if is_key:
                out.append(f'"{ident}"')
                last_sig = '"'
            elif ident == "import":
                # import 'path'  ->  _import('path')
                k2 = j
                while k2 < n and src[k2] in " \t\n":
                    k2 += 1
                if k2 < n and src[k2] in "'\"":
                    quote = src[k2]
                    k3 = k2 + 1
                    while k3 < n and src[k3] != quote:
                        k3 += 1
                    path = src[k2 + 1 : k3]
                    out.append(f"_import({path!r})")
                    last_sig = ")"
                    i = k3 + 1
                    continue
                raise JsonnetError("`import` must be followed by a string literal")
            elif ident == "std":
                out.append("_std")
                last_sig = "d"
            elif ident in _KEYWORD_MAP:
                out.append(_KEYWORD_MAP[ident])
                last_sig = "e"
            elif ident in _UNSUPPORTED_KEYWORDS:
                raise _unsupported(ident, src[i:])
            else:
                out.append(ident)
                last_sig = ident[-1]
            i = j
            continue
        if ch == "$":
            raise _unsupported("'$' (root reference)", src[i:])
        if ch == "|" and i + 2 < n and src[i + 1] == "|" and src[i + 2] == "|":
            raise _unsupported("'|||' text block", src[i:])
        if ch == "|" and i + 1 < n and src[i + 1] == "|":
            raise _unsupported("'||' operator", src[i:])
        if ch == "&" and i + 1 < n and src[i + 1] == "&":
            raise _unsupported("'&&' operator", src[i:])
        if ch == "!" and not (i + 1 < n and src[i + 1] == "="):
            raise _unsupported("'!' operator", src[i:])
        out.append(ch)
        if not ch.isspace():
            last_sig = ch
        i += 1
    return "".join(out)


# ---------------------------------------------------------------------------
# jsonnet std library (the subset our configs use)
# ---------------------------------------------------------------------------

def merge_patch(target: Any, patch: Any) -> Any:
    """jsonnet std.mergePatch semantics (RFC 7386 JSON Merge Patch).

    Object fields in `patch` override `target` recursively; a `null`
    (None) value removes the key.
    """
    if not isinstance(patch, dict):
        return _strip_nulls(copy.deepcopy(patch))
    result = dict(copy.deepcopy(target)) if isinstance(target, dict) else {}
    for key, value in patch.items():
        if value is None:
            result.pop(key, None)
        elif isinstance(value, dict):
            result[key] = merge_patch(result.get(key, {}), value)
        else:
            result[key] = copy.deepcopy(value)
    return result


def _strip_nulls(value: Any) -> Any:
    if isinstance(value, dict):
        return {k: _strip_nulls(v) for k, v in value.items() if v is not None}
    return value


class _Std:
    """Minimal `std` namespace."""

    def __init__(self, ext_vars: Optional[Dict[str, str]] = None):
        self._ext_vars = ext_vars or {}

    @staticmethod
    def mergePatch(target: Any, patch: Any) -> Any:
        return merge_patch(target, patch)

    def extVar(self, name: str) -> str:
        try:
            return self._ext_vars[name]
        except KeyError as exc:
            raise JsonnetError(f"undefined external variable: {name}") from exc

    @staticmethod
    def length(x: Any) -> int:
        return len(x)

    @staticmethod
    def join(sep: Any, arr: List[Any]) -> Any:
        if isinstance(sep, str):
            return sep.join(arr)
        out: List[Any] = []
        for i, item in enumerate(arr):
            if i:
                out.extend(sep)
            out.extend(item)
        return out

    @staticmethod
    def format(fmt: str, args: Any) -> str:
        if isinstance(args, (list, tuple)):
            return fmt % tuple(args)
        return fmt % args

    @staticmethod
    def toString(x: Any) -> str:
        if isinstance(x, str):
            return x
        return json.dumps(x)

    @staticmethod
    def objectHas(obj: dict, key: str) -> bool:
        return key in obj

    @staticmethod
    def get(obj: dict, key: str, default: Any = None) -> Any:
        return obj.get(key, default)

    def __getattr__(self, name: str) -> Any:
        raise JsonnetError(
            f"unsupported std function: std.{name} (supported: "
            "mergePatch, extVar, length, join, format, toString, "
            "objectHas, get)"
        )


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def evaluate_snippet(
    src: str,
    base_dir: str = ".",
    ext_vars: Optional[Dict[str, str]] = None,
    _seen: Optional[frozenset] = None,
) -> Any:
    src = _strip_comments(src)
    chunks = _split_statements(src)
    if not chunks:
        raise JsonnetError("empty jsonnet source")

    lines: List[str] = []
    for idx, chunk in enumerate(chunks):
        stripped = chunk.strip()
        if not stripped:
            continue
        is_last = idx == len(chunks) - 1
        if stripped.startswith("local") and stripped[5:6].isspace():
            body = _transform_expr(stripped[5:].strip())
            if "=" not in body:
                raise JsonnetError(f"malformed local binding: {stripped[:60]}")
            # jsonnet permits `obj.field` access; wrap values in an
            # attribute-access dict so translated Python supports it too.
            name, expr = body.split("=", 1)
            lines.append(f"{name.strip()} = _attr({expr.strip()})")
        elif is_last:
            lines.append("__result__ = _attr(" + _transform_expr(stripped) + ")")
        else:
            raise JsonnetError(
                f"unsupported top-level statement: {stripped[:60]}"
            )
    if not lines or not lines[-1].startswith("__result__"):
        raise JsonnetError("jsonnet file has no result expression")

    seen = _seen or frozenset()

    def _import(rel_path: str) -> Any:
        path = os.path.normpath(os.path.join(base_dir, rel_path))
        if path in seen:
            raise JsonnetError(f"circular import: {path}")
        return evaluate_file(path, ext_vars, _seen=seen | {path})

    from .attr_dict import AttrDict

    namespace: Dict[str, Any] = {
        "__builtins__": {},
        "_std": _Std(ext_vars),
        "_import": _import,
        "_attr": AttrDict._wrap,
    }
    try:
        exec("\n".join(lines), namespace)  # noqa: S102 — config files are trusted
    except JsonnetError:
        raise
    except Exception as exc:
        raise JsonnetError(f"error evaluating jsonnet: {exc}") from exc
    return namespace["__result__"]


def evaluate_file(
    path: str,
    ext_vars: Optional[Dict[str, str]] = None,
    _seen: Optional[frozenset] = None,
) -> Any:
    with open(path, "r", encoding="utf-8") as fh:
        src = fh.read()
    if path.endswith(".json"):
        return json.loads(src)
    return evaluate_snippet(
        src, base_dir=os.path.dirname(os.path.abspath(path)), ext_vars=ext_vars,
        _seen=_seen,
    )
