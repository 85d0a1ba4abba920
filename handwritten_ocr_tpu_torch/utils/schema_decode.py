"""Template-based schema-constrained decoding (host-side state machines).

Copied from ``handwritten_ocr_tpu/utils/schema_decode.py``. Compiles a
plain JSON-schema dict (the agent contracts' ``json_schema()``, the same
dict pydantic's ``model_json_schema()`` gives) into a generation plan where
the JSON scaffolding (braces, keys, colons, quotes) is FORCED token by
token and only the values are model-chosen, each under its type rule:

  string   free greedy decode until an unescaped '"' appears (or EOS)
  integer  digit tokens, clamped into [minimum, maximum] at assembly
  enum     option picked by scanning the step's top-k for an option's
           first token; the full option text is then forced
  array    after '[' and after each element, a continue/close decision
           read off the top-k (','-ish vs ']'-ish candidates)

The host assembles the final document from the typed values, so the
output ALWAYS validates against the schema — strictly stronger than a
server-side ``format=json_schema``, whose output can truncate
mid-document. If the model emits EOS (or the token
budget dies) before a required field is reached, the session reports
``complete=False`` and the caller's parse ladder takes over rather than
fabricating content.

Pure host logic: the device interaction is "here is this step's top-k,
give me the one token to commit", which the serving layer batches across
slots (one dispatch per step for the whole agent batch).
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Iterator

_MAX_ARRAY_ITEMS = 16
_DIGITS = re.compile(r"[0-9]+")


# ── schema compilation ───────────────────────────────────────────────

@dataclasses.dataclass
class FieldSpec:
    name: str
    kind: str                        # string | integer | enum | array
    required: bool = False
    default: Any = None
    lo: int | None = None
    hi: int | None = None
    options: list[str] | None = None
    item_kind: str | None = None     # for arrays: "string" | "object"
    item_spec: "ObjectSpec | None" = None


@dataclasses.dataclass
class ObjectSpec:
    fields: list[FieldSpec]


def compile_schema(schema: dict) -> ObjectSpec:
    """Walk a pydantic-v2-shaped JSON schema into an ObjectSpec."""
    defs = schema.get("$defs", {})

    def resolve(node: dict) -> dict:
        while "$ref" in node:
            node = defs[node["$ref"].split("/")[-1]]
        return node

    def build_object(node: dict) -> ObjectSpec:
        node = resolve(node)
        required = set(node.get("required", []))
        fields = []
        for name, prop in node.get("properties", {}).items():
            prop = resolve(prop)
            spec = FieldSpec(name=name, kind="string",
                             required=name in required,
                             default=prop.get("default"))
            if "enum" in prop or "const" in prop:
                spec.kind = "enum"
                spec.options = ([prop["const"]] if "const" in prop
                                else list(prop["enum"]))
            elif prop.get("type") == "integer":
                spec.kind = "integer"
                spec.lo = prop.get("minimum", prop.get("exclusiveMinimum"))
                spec.hi = prop.get("maximum", prop.get("exclusiveMaximum"))
            elif prop.get("type") == "array":
                spec.kind = "array"
                item = resolve(prop.get("items", {}))
                if item.get("type") == "string" or not item.get("properties"):
                    spec.item_kind = "string"
                else:
                    spec.item_kind = "object"
                    spec.item_spec = build_object(item)
            elif prop.get("type") == "object" and prop.get("properties"):
                spec.kind = "object"
                spec.item_spec = build_object(prop)
            fields.append(spec)
        return ObjectSpec(fields=fields)

    return build_object(schema)


# ── string-span helpers ──────────────────────────────────────────────

def find_unescaped_quote(text: str) -> int:
    """Index of the first '"' not preceded by an odd run of backslashes."""
    i = 0
    while i < len(text):
        ch = text[i]
        if ch == "\\":
            i += 2
            continue
        if ch == '"':
            return i
        i += 1
    return -1


def _parse_string_value(raw: str) -> str:
    """Interpret the model's in-string text as JSON string content."""
    try:
        return json.loads(f'"{raw}"', strict=False)
    except Exception:
        return raw.replace("\\", "")


# ── the per-request session ──────────────────────────────────────────

class SchemaSession:
    """Drives one request's schema-guided generation.

    Protocol (one committed token per decode step):
      token = session.next_token(top_ids)   # list[int] | None when done
    ``top_ids`` is this step's top-k token ids for the session's slot; it
    is consulted only when the session is inside a value span — scaffold
    steps ignore it and return the next forced token.
    """

    def __init__(self, spec: ObjectSpec, tokenizer, eos_token_id: int,
                 max_tokens: int):
        self.tokenizer = tokenizer
        self.eos = eos_token_id
        self.budget = max_tokens
        self.exhausted = False       # EOS or budget death
        self._values: list[tuple[tuple, Any]] = []
        self._missing_required = False
        self._forced: list[int] = []
        self._action: tuple | None = None
        self._string_ids: list[int] = []
        self._int_digits = ""
        self._decode_cache: dict[int, str] = {}
        self._result: Any = None
        self.truncated_arrays: list[str] = []
        self._gen = self._walk_object(spec)
        self._pump(None)

    # ── generator pump ────────────────────────────────────────────
    def _pump(self, send_value) -> None:
        """Advance the plan generator, accumulating forced text, until a
        value action is pending or the plan finishes."""
        try:
            while True:
                kind, payload = self._gen.send(send_value)
                send_value = None
                if kind == "force":
                    self._forced.extend(self.tokenizer.encode(payload))
                    continue
                self._action = (kind, payload)
                return
        except StopIteration as stop:
            self._result = stop.value
            self._action = None

    # ── the plan (a generator yielding actions) ───────────────────
    def _walk_object(self, spec: ObjectSpec):
        obj = {}
        yield ("force", "{")
        for index, field in enumerate(spec.fields):
            prefix = ("" if index == 0 else ", ") + json.dumps(field.name) + ": "
            if self.exhausted:
                self._fill_default(obj, field)
                continue
            if field.kind == "string":
                yield ("force", prefix + '"')
                raw = yield ("string", None)
                obj[field.name] = _parse_string_value(raw)
            elif field.kind == "integer":
                yield ("force", prefix)
                digits = yield ("integer", field)
                obj[field.name] = self._clamp_int(digits, field)
            elif field.kind == "enum":
                yield ("force", prefix + '"')
                choice = yield ("enum", field.options)
                yield ("force", choice + '"')
                obj[field.name] = choice
            elif field.kind == "array":
                yield ("force", prefix + "[")
                items = []
                while len(items) < _MAX_ARRAY_ITEMS and not self.exhausted:
                    open_token = "{" if field.item_kind == "object" else '"'
                    proceed = yield ("decision",
                                     ("first" if not items else "next",
                                      open_token))
                    if not proceed:
                        break
                    if field.item_kind == "object":
                        if items:
                            yield ("force", ", ")
                        value = yield from self._walk_object(field.item_spec)
                    else:
                        yield ("force", (", " if items else "") + '"')
                        raw = yield ("string", None)
                        value = _parse_string_value(raw)
                    items.append(value)
                if len(items) >= _MAX_ARRAY_ITEMS and not self.exhausted:
                    # Silent caps are worse than noisy ones: record + log
                    # when the item ceiling (not the model) ended the
                    # array so truncation is visible to callers.
                    self.truncated_arrays.append(field.name)
                    print(f"[schema] array '{field.name}' truncated at "
                          f"{_MAX_ARRAY_ITEMS} items (cap)")
                yield ("force", "]")
                obj[field.name] = items
            elif field.kind == "object":
                yield ("force", prefix)
                obj[field.name] = yield from self._walk_object(field.item_spec)
        yield ("force", "}")
        return obj

    def _fill_default(self, obj: dict, field: FieldSpec) -> None:
        if field.default is not None:
            obj[field.name] = field.default
        elif field.kind == "array":
            obj[field.name] = []
        elif field.required:
            self._missing_required = True

    @staticmethod
    def _clamp_int(digits: str, field: FieldSpec) -> int:
        if not digits:
            value = field.default if isinstance(field.default, int) else \
                (field.lo or 0)
        else:
            value = int(digits[:12])
        if field.lo is not None:
            value = max(value, field.lo)
        if field.hi is not None:
            value = min(value, field.hi)
        return value

    # ── token-level driver interface ──────────────────────────────
    def _decode_one(self, token: int) -> str:
        text = self._decode_cache.get(token)
        if text is None:
            text = self.tokenizer.decode([token])
            self._decode_cache[token] = text
        return text

    def _finish_exhausted(self) -> None:
        """EOS / budget death: resolve the pending span with whatever was
        accumulated, then fast-forward the plan (the ``exhausted`` flag
        makes remaining fields default-fill without further yields)."""
        self.exhausted = True
        action, self._action = self._action, None
        if action is None:
            send = None
        elif action[0] == "string":
            send = self.tokenizer.decode(self._string_ids)
            self._string_ids = []
        elif action[0] == "integer":
            send = self._int_digits
            self._int_digits = ""
        elif action[0] == "enum":
            send = action[1][0]
        else:                         # decision
            send = False
        guard = 0
        while self._result is None and guard < 10_000:
            self._pump(send)
            self._forced.clear()
            send = None if self._action is None else self._default_send()
            self._action = None
            guard += 1

    def _default_send(self):
        kind, payload = self._action
        if kind in ("string", "integer"):
            return ""
        if kind == "enum":
            return payload[0]
        return False

    @property
    def done(self) -> bool:
        return self._result is not None

    def next_token(self, top_ids) -> int | None:
        """Commit one token for this step (None = session finished)."""
        if self.done:
            return None
        if self.budget <= 0 and not self.exhausted:
            self._finish_exhausted()
            return None
        self.budget -= 1

        if self._forced:
            return self._forced.pop(0)

        kind, payload = self._action
        if kind == "string":
            return self._string_step(top_ids)
        if kind == "integer":
            return self._integer_step(top_ids)
        if kind == "enum":
            return self._enum_step(top_ids)
        return self._decision_step(payload, top_ids)

    # ── bulk string absorption (device-chunked spans) ─────────────
    def in_string_span(self) -> bool:
        """True when the next step will free-generate string content —
        the serving layer may then advance this slot with the chunked
        device loop instead of per-token host guidance."""
        return (not self.done and not self.exhausted and not self._forced
                and self._action is not None and self._action[0] == "string")

    def absorb_string_tokens(self, tokens) -> None:
        """Ingest a device-chunk's worth of string tokens (already written
        to the model's context). Tokens after the span-closing quote are
        never present — the device loop stalls ON the quote-bearing token.
        EOS (or an empty chunk at zero budget) exhausts the session,
        keeping the partial value, exactly like the per-token path."""
        assert self._action is not None and self._action[0] == "string"
        for token in tokens:
            token = int(token)
            self.budget -= 1
            if token == self.eos or self.budget < 0:
                self._finish_exhausted()
                return
            self._string_ids.append(token)
        text = self.tokenizer.decode(self._string_ids)
        quote = find_unescaped_quote(text)
        if quote >= 0:
            value = text[:quote]
            self._string_ids = []
            self._action = None
            self._pump(value)
        elif self.budget <= 0:
            self._finish_exhausted()

    # ── value-span steps ──────────────────────────────────────────
    def _string_step(self, top_ids) -> int | None:
        token = int(top_ids[0])
        if token == self.eos:
            self._finish_exhausted()
            return None
        self._string_ids.append(token)
        text = self.tokenizer.decode(self._string_ids)
        quote = find_unescaped_quote(text)
        if quote >= 0:
            value = text[:quote]
            self._string_ids = []
            self._action = None
            self._pump(value)
            return token              # the quote-bearing token joins context
        return token

    def _integer_step(self, top_ids) -> int | None:
        field = self._action[1]
        max_digits = len(str(field.hi if field.hi is not None else 999))
        candidate = None
        for token in top_ids:
            token = int(token)
            if token == self.eos:
                break
            text = self._decode_one(token).strip()
            if text and _DIGITS.fullmatch(text) and \
                    len(self._int_digits) + len(text) <= max_digits:
                candidate = (token, text)
                break
        if candidate is not None:
            self._int_digits += candidate[1]
            if len(self._int_digits) < max_digits:
                return candidate[0]   # may extend next step
            self._conclude_int()
            return candidate[0]
        if not self._int_digits and int(top_ids[0]) == self.eos:
            self._finish_exhausted()
            return None
        # No (further) digits: conclude and emit the next scaffold token.
        self._conclude_int()
        return self._forced.pop(0) if self._forced else None

    def _conclude_int(self) -> None:
        digits, self._int_digits = self._int_digits, ""
        # The digit tokens are already in the model's context; resume the
        # plan with the accumulated text.
        self._action = None
        self._pump(digits)

    def _enum_step(self, top_ids) -> int | None:
        options = self._action[1]
        choice = None
        for token in top_ids:
            token = int(token)
            if token == self.eos:
                break
            text = self._decode_one(token).strip()
            if not text:
                continue
            for option in options:
                # tolerate merged tokenizations ('accept"' vs 'acce')
                if option.startswith(text) or text.startswith(option):
                    choice = option
                    break
            if choice is not None:
                break
        if choice is None:
            choice = options[0]
        self._action = None
        self._pump(choice)            # plan forces the full option text
        return self._forced.pop(0) if self._forced else None

    def _decision_step(self, payload, top_ids) -> int | None:
        _, open_token = payload
        proceed = None
        for token in top_ids:
            token = int(token)
            if token == self.eos:
                proceed = False
                break
            text = self._decode_one(token).strip()
            if not text:
                continue
            if text[0] in ",":
                proceed = True
                break
            if text[0] in "]}":
                proceed = False
                break
            if text[0] in ('"', "{") and text[0] == open_token:
                proceed = True
                break
        if proceed is None:
            proceed = False
        self._action = None
        self._pump(proceed)
        return self._forced.pop(0) if self._forced else None

    # ── results ───────────────────────────────────────────────────
    def result(self) -> tuple[dict | None, bool]:
        """(assembled object or None, complete?). complete=False when a
        required field was never reached before EOS/budget."""
        if self._result is None:
            return None, False
        return self._result, not self._missing_required

    def result_text(self) -> str | None:
        obj, complete = self.result()
        if obj is None or not complete:
            return None
        return json.dumps(obj)
