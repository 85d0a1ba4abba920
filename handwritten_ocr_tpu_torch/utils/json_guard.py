"""Incremental JSON viability checking for constrained decoding (a copy
of ``handwritten_ocr_tpu/utils/json_guard.py``; the dense
``Qwen3Model.generate_json`` commits through it).

``is_viable_prefix(s)`` — can ``s`` be extended into a syntactically valid
JSON document? Single-pass pushdown scanner (container frame stack +
string/escape/number/literal sub-states); :class:`JsonScanner` is
restartable for per-token incremental checks during decode.

``is_complete(s)`` — is ``s`` already one complete JSON value (with at
most surrounding whitespace)?
"""

from __future__ import annotations

import re

_WS = " \t\n\r"
_LITERALS = ("true", "false", "null")
_NUM_PREFIX = re.compile(r"-?(0|[1-9][0-9]*)?(\.[0-9]*)?([eE][+-]?[0-9]*)?")
_NUM_FULL = re.compile(r"-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?")

# Frame states.
_VALUE = "value"                  # a value must come next
_FIRST_OR_CLOSE = "first"         # first element, or immediate close
_KEY = "key"                      # object: a key string must come next
_COLON = "colon"
_COMMA_OR_CLOSE = "comma"
_DONE = "done"                    # top-level value finished


class JsonScanner:
    """Pushdown JSON prefix scanner; ``feed`` returns False on dead input."""

    def __init__(self) -> None:
        # Stack of ("obj" | "arr", state); bottom pseudo-frame is "top".
        self.frames: list[list] = [["top", _VALUE]]
        self.in_string = False
        self.string_is_key = False
        self.escaped = False
        self.literal = ""
        self.dead = False

    # ── public ────────────────────────────────────────────────────
    def feed(self, text: str) -> bool:
        if self.dead:
            return False
        for ch in text:
            if not self._step(ch):
                self.dead = True
                return False
        return True

    def viable(self) -> bool:
        if self.dead:
            return False
        if self.literal and self.literal[0] in "tfn":
            return any(lit.startswith(self.literal) for lit in _LITERALS)
        return True

    def complete(self) -> bool:
        if self.dead or self.in_string or len(self.frames) > 1:
            return False
        kind, state = self.frames[0]
        if self.literal:
            if state != _VALUE:
                return False
            if self.literal[0] in "tfn":
                return self.literal in _LITERALS
            return bool(_NUM_FULL.fullmatch(self.literal))
        return state == _DONE

    # ── transitions ───────────────────────────────────────────────
    def _step(self, ch: str) -> bool:
        if self.in_string:
            return self._string_step(ch)
        if self.literal:
            if self._literal_extends(ch):
                self.literal += ch
                return True
            if not self._finish_literal():
                return False
            return self._step(ch)          # re-dispatch terminator char

        if ch in _WS:
            return True

        kind, state = self.frames[-1]

        if state == _DONE:
            return False
        if state == _COLON:
            if ch == ":":
                self.frames[-1][1] = _VALUE
                return True
            return False
        if state == _KEY:
            if ch == '"':
                self.in_string = True
                self.string_is_key = True
                return True
            return False
        if state == _COMMA_OR_CLOSE:
            if ch == ",":
                self.frames[-1][1] = _KEY if kind == "obj" else _VALUE
                return True
            return self._close(ch)
        # state in (_VALUE, _FIRST_OR_CLOSE)
        if kind == "obj" and state == _FIRST_OR_CLOSE:
            if ch == '"':
                self.in_string = True
                self.string_is_key = True
                return True
            if ch == "}":
                return self._close(ch)
            return False
        if kind == "arr" and state == _FIRST_OR_CLOSE and ch == "]":
            return self._close(ch)
        return self._begin_value(ch)

    def _begin_value(self, ch: str) -> bool:
        if ch == '"':
            self.in_string = True
            self.string_is_key = False
            return True
        if ch == "{":
            self.frames.append(["obj", _FIRST_OR_CLOSE])
            return True
        if ch == "[":
            self.frames.append(["arr", _FIRST_OR_CLOSE])
            return True
        if ch == "-" or ch.isdigit() or ch in "tfn":
            self.literal = ch
            return True
        return False

    def _close(self, ch: str) -> bool:
        kind = self.frames[-1][0]
        if (kind == "obj" and ch == "}") or (kind == "arr" and ch == "]"):
            self.frames.pop()
            self._value_finished()
            return True
        return False

    def _string_step(self, ch: str) -> bool:
        if self.escaped:
            self.escaped = False
            return True
        if ch == "\\":
            self.escaped = True
            return True
        if ch == '"':
            self.in_string = False
            if self.string_is_key:
                self.frames[-1][1] = _COLON
                self.string_is_key = False
            else:
                self._value_finished()
            return True
        return ch not in ("\n", "\r")

    def _literal_extends(self, ch: str) -> bool:
        candidate = self.literal + ch
        if candidate[0] in "tfn":
            return any(lit.startswith(candidate) for lit in _LITERALS)
        return bool(_NUM_PREFIX.fullmatch(candidate))

    def _finish_literal(self) -> bool:
        text, self.literal = self.literal, ""
        if text[0] in "tfn":
            if text not in _LITERALS:
                return False
        elif not _NUM_FULL.fullmatch(text):
            return False
        self._value_finished()
        return True

    def _value_finished(self) -> None:
        kind = self.frames[-1][0]
        self.frames[-1][1] = _DONE if kind == "top" else _COMMA_OR_CLOSE


def is_viable_prefix(text: str) -> bool:
    """True when ``text`` can still extend to valid JSON."""
    scanner = JsonScanner()
    scanner.feed(text)
    return scanner.viable()


def is_complete(text: str) -> bool:
    """True when ``text`` is one complete JSON value (modulo whitespace)."""
    scanner = JsonScanner()
    if not scanner.feed(text):
        return False
    return scanner.complete()
