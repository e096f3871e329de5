"""Parser for hydra-style override values.

The reference drives experiments through newline-separated override files
(``expts/*.txt``, read by ``run.py:18-27`` in the reference) whose values use
OmegaConf flow syntax: nested ``{k:v, ...}`` dicts (with or without spaces),
``[...]`` lists, ``${a.b.c}`` interpolations and bare scalars. This module
parses that syntax without depending on hydra/omegaconf.
"""

from __future__ import annotations

from typing import Any

_NULLS = {"null", "none", "~"}
_TRUES = {"true"}
_FALSES = {"false"}


class ValueParseError(ValueError):
    pass


def parse_scalar(text: str) -> Any:
    """Type-infer a bare scalar the way OmegaConf does."""
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in ("'", '"'):
        return s[1:-1]
    low = s.lower()
    if low in _NULLS:
        return None
    if low in _TRUES:
        return True
    if low in _FALSES:
        return False
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def error(self, msg: str):
        raise ValueParseError(f"{msg} at pos {self.pos} in {self.text!r}")

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def skip_ws(self):
        while self.pos < len(self.text) and self.text[self.pos].isspace():
            self.pos += 1

    def parse_value(self) -> Any:
        self.skip_ws()
        ch = self.peek()
        if ch == "{":
            return self.parse_dict()
        if ch == "[":
            return self.parse_list()
        return self.parse_scalar_until(",]}")

    def parse_dict(self) -> dict:
        assert self.peek() == "{"
        self.pos += 1
        out: dict = {}
        self.skip_ws()
        if self.peek() == "}":
            self.pos += 1
            return out
        while True:
            self.skip_ws()
            key = self.parse_key()
            self.skip_ws()
            if self.peek() != ":":
                self.error("expected ':' after dict key")
            self.pos += 1
            out[key] = self.parse_value()
            self.skip_ws()
            ch = self.peek()
            if ch == ",":
                self.pos += 1
                continue
            if ch == "}":
                self.pos += 1
                return out
            self.error("expected ',' or '}' in dict")

    def parse_key(self) -> str:
        # A key runs until ':' at depth 0; ${...} may contain ':' in theory
        # but hydra paths do not, so scan to the first ':'.
        start = self.pos
        while self.pos < len(self.text):
            ch = self.text[self.pos]
            if ch == ":":
                break
            if ch in ",{}[]":
                self.error("unexpected delimiter in dict key")
            self.pos += 1
        key = self.text[start:self.pos].strip()
        if len(key) >= 2 and key[0] == key[-1] and key[0] in ("'", '"'):
            key = key[1:-1]
        if not key:
            self.error("empty dict key")
        return key

    def parse_list(self) -> list:
        assert self.peek() == "["
        self.pos += 1
        out: list = []
        self.skip_ws()
        if self.peek() == "]":
            self.pos += 1
            return out
        while True:
            out.append(self.parse_value())
            self.skip_ws()
            ch = self.peek()
            if ch == ",":
                self.pos += 1
                continue
            if ch == "]":
                self.pos += 1
                return out
            self.error("expected ',' or ']' in list")

    def parse_scalar_until(self, stops: str) -> Any:
        start = self.pos
        depth = 0  # ${...} nesting
        while self.pos < len(self.text):
            ch = self.text[self.pos]
            if ch == "$" and self.text[self.pos:self.pos + 2] == "${":
                depth += 1
                self.pos += 2
                continue
            if depth > 0:
                if ch == "}":
                    depth -= 1
                self.pos += 1
                continue
            if ch in stops:
                break
            self.pos += 1
        return parse_scalar(self.text[start:self.pos])


def parse_value(text: str) -> Any:
    """Parse a full override value (dict / list / scalar)."""
    p = _Parser(text.strip())
    val = p.parse_value()
    p.skip_ws()
    if p.pos != len(p.text):
        raise ValueParseError(f"trailing garbage after value: {p.text[p.pos:]!r}")
    return val
