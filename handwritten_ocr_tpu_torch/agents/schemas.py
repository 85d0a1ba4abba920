"""Output contracts of the three reasoning agents, without pydantic.

Port of ``handwritten_ocr_tpu/agents/schemas.py``, whose classes are
pydantic models; the card's machine has no pydantic, so each contract
here is a plain class over a tuple of :class:`Field` s that reproduces
the three things the pipeline uses:

- ``json_schema()``: the dict pydantic v2's ``model_json_schema()``
  gives (``$defs`` / ``$ref``, ``default``, ``minimum`` / ``maximum``,
  ``enum``, ``title``, ``required``, keys in the same order);
- ``validate(raw)``: accepts and rejects what pydantic v2's lax mode
  does on JSON values: extra keys ignored, missing optional fields
  defaulted; integers also from an integral float, a bool, or a decimal
  string (surrounding whitespace, ``_`` between digits and a zero
  fraction allowed), then held to their bounds; strings only from
  strings; enum values exact; lists only from lists (or tuples); nested
  objects from dicts. It raises :class:`ValidationError`;
- ``dump()``: the dict ``model_dump()`` gives.

Field names, types, bounds and defaults are the JAX package's contract:
every model ignores extra keys and defaults every optional field, so
partially valid LLM JSON still validates.
"""

from __future__ import annotations

import copy
import math
import re
from typing import Any, ClassVar

_REQUIRED = object()
# pydantic strips the Unicode White_Space set (Rust's str::trim) from an
# integer's text before parsing it.
_WHITESPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680" + "".join(
    chr(c) for c in range(0x2000, 0x200B)) + "\u2028\u2029\u202f\u205f\u3000")
_INT_TEXT = re.compile(r"[+-]?[0-9]+(?:_[0-9]+)*(?:\.0+)?")


class ValidationError(ValueError):
    """A value does not satisfy its contract (pydantic's ValidationError
    counterpart)."""


class Field:
    """One field of a contract.

    kind: "string", "integer", "enum" (``options``) or "array" (``item``:
    "string" or a :class:`Contract` subclass). ``ge`` / ``le`` bound an
    integer. A field without ``default`` is required.
    """

    def __init__(self, name: str, kind: str, default: Any = _REQUIRED, *,
                 ge: int | None = None, le: int | None = None,
                 options: tuple[str, ...] = (), item: Any = None):
        self.name = name
        self.kind = kind
        self.default = default
        self.ge = ge
        self.le = le
        self.options = options
        self.item = item

    @property
    def required(self) -> bool:
        return self.default is _REQUIRED

    def schema(self) -> dict:
        """This field's property schema, keys in pydantic's order."""
        out: dict[str, Any] = {}
        if not self.required:
            out["default"] = copy.deepcopy(self.default)
        if self.kind == "enum":
            out["enum"] = list(self.options)
        if self.kind == "array":
            out["items"] = ({"type": "string"} if self.item == "string"
                            else {"$ref": f"#/$defs/{self.item.__name__}"})
        if self.le is not None:
            out["maximum"] = self.le
        if self.ge is not None:
            out["minimum"] = self.ge
        out["title"] = self.name.replace("_", " ").title()
        out["type"] = {"string": "string", "enum": "string",
                       "integer": "integer", "array": "array"}[self.kind]
        return out

    def coerce(self, value: Any, where: str) -> Any:
        if self.kind == "string":
            return _string(value, where)
        if self.kind == "integer":
            number = _integer(value, where)
            if self.ge is not None and number < self.ge:
                raise ValidationError(f"{where}: {number} < {self.ge}")
            if self.le is not None and number > self.le:
                raise ValidationError(f"{where}: {number} > {self.le}")
            return number
        if self.kind == "enum":
            if not (isinstance(value, str) and value in self.options):
                raise ValidationError(
                    f"{where}: {value!r} is not one of {list(self.options)}")
            return value
        if not isinstance(value, (list, tuple)):
            raise ValidationError(f"{where}: a list is required, got "
                                  f"{type(value).__name__}")
        if self.item == "string":
            return [_string(v, f"{where}[{i}]") for i, v in enumerate(value)]
        return [self.item.validate(v, f"{where}[{i}]")
                for i, v in enumerate(value)]


def _string(value: Any, where: str) -> str:
    if not isinstance(value, str):
        raise ValidationError(f"{where}: a string is required, got "
                              f"{type(value).__name__}")
    return value


def _integer(value: Any, where: str) -> int:
    if isinstance(value, bool):
        return int(value)
    if isinstance(value, int):
        return value
    if isinstance(value, float):
        if not math.isfinite(value):
            raise ValidationError(f"{where}: {value} is not finite")
        if not value.is_integer():
            raise ValidationError(f"{where}: {value} has a fraction")
        return int(value)
    if isinstance(value, str):
        text = value.strip(_WHITESPACE)
        if _INT_TEXT.fullmatch(text):
            return int(text.split(".")[0].replace("_", ""))
        raise ValidationError(f"{where}: {value!r} is not an integer")
    raise ValidationError(f"{where}: an integer is required, got "
                          f"{type(value).__name__}")


class Contract:
    """Base of the agent contracts: ``FIELDS`` in declaration order."""

    FIELDS: ClassVar[tuple[Field, ...]] = ()

    def __init__(self, **values: Any):
        for field in self.FIELDS:
            if field.name in values:
                value = field.coerce(values[field.name],
                                     f"{type(self).__name__}.{field.name}")
            elif field.required:
                raise ValidationError(
                    f"{type(self).__name__}.{field.name}: field required")
            else:
                value = copy.deepcopy(field.default)
            setattr(self, field.name, value)

    @classmethod
    def validate(cls, raw: Any, where: str | None = None) -> "Contract":
        """``raw`` (a dict, or an instance) as a validated instance."""
        if isinstance(raw, cls):
            return raw
        if not isinstance(raw, dict):
            raise ValidationError(f"{where or cls.__name__}: an object is "
                                  f"required, got {type(raw).__name__}")
        names = {field.name for field in cls.FIELDS}
        return cls(**{k: v for k, v in raw.items() if k in names})

    def dump(self) -> dict:
        """Plain dict of every field, nested contracts as dicts."""
        return {field.name: _dump(getattr(self, field.name))
                for field in self.FIELDS}

    @classmethod
    def json_schema(cls) -> dict:
        """The JSON schema pydantic v2's ``model_json_schema()`` gives."""
        defs: dict[str, dict] = {}
        body = cls._object_schema(defs)
        return ({"$defs": dict(sorted(defs.items()))} | body) if defs else body

    @classmethod
    def _object_schema(cls, defs: dict) -> dict:
        for field in cls.FIELDS:
            if field.kind == "array" and field.item != "string":
                defs[field.item.__name__] = field.item._object_schema(defs)
        out: dict[str, Any] = {
            "properties": {f.name: f.schema() for f in cls.FIELDS}}
        required = [f.name for f in cls.FIELDS if f.required]
        if required:
            out["required"] = required
        out["title"] = cls.__name__
        out["type"] = "object"
        return out


def _dump(value: Any) -> Any:
    if isinstance(value, Contract):
        return value.dump()
    if isinstance(value, list):
        return [_dump(v) for v in value]
    return value


def _confidence(name: str, default: int) -> Field:
    return Field(name, "integer", default, ge=0, le=100)


class CriticIssue(Contract):
    FIELDS = (
        Field("description", "string", ""),
        Field("severity", "enum", "minor",
              options=("critical", "minor", "cosmetic")),
        Field("suggestion", "string", ""),
    )


class CriticSegment(Contract):
    FIELDS = (
        Field("text", "string", ""),
        _confidence("confidence", 50),
        Field("issues", "array", [], item=CriticIssue),
    )


class CriticResult(Contract):
    FIELDS = (
        _confidence("overall_confidence", 0),
        Field("segments", "array", [], item=CriticSegment),
        Field("verdict", "enum", "needs_editing",
              options=("accept", "needs_editing", "needs_reocr")),
        Field("reasoning", "string", ""),
    )


class EditorChange(Contract):
    FIELDS = (
        Field("original", "string", ""),
        Field("corrected", "string", ""),
        Field("reason", "string", ""),
        _confidence("confidence", 50),
    )


class EditorResult(Contract):
    FIELDS = (
        Field("corrected_text", "string"),
        Field("changes", "array", [], item=EditorChange),
        Field("unresolved", "array", [], item="string"),
    )


class ArbitratorDecision(Contract):
    FIELDS = (
        Field("segment", "string", ""),
        Field("chosen_version", "integer", 1, ge=1),
        Field("reason", "string", ""),
    )


class ArbitratorResult(Contract):
    FIELDS = (
        Field("final_text", "string"),
        Field("decisions", "array", [], item=ArbitratorDecision),
        _confidence("confidence", 0),
        Field("uncertain_segments", "array", [], item="string"),
    )
