"""Render a human-readable JSON example from an agent contract.

Port of ``handwritten_ocr_tpu/agents/schema_prompt.py``, which walks a
pydantic model's annotations; this one walks the port's
:class:`~handwritten_ocr_tpu_torch.agents.schemas.Contract` fields and
emits the same text. The text is embedded in agent prompts so the LLM
sees the expected shape, e.g. for ``CriticResult``::

    {
      "overall_confidence": <0-100>,
      ...
      "verdict": "accept" | "needs_editing" | "needs_reocr",
    }
"""

from __future__ import annotations

from handwritten_ocr_tpu_torch.agents.schemas import Contract, Field

_INDENT = 2


def schema_example(model: type[Contract]) -> str:
    """Human-readable JSON example for ``model``."""
    return "\n".join(_render_model(model, depth=0))


def _placeholder_token(field: Field) -> str:
    """Unquoted placeholder text for a scalar field."""
    if field.kind == "enum":
        return " | ".join(f'"{v}"' for v in field.options)
    if field.kind == "integer":
        if field.ge is not None and field.le is not None:
            return f"<{field.ge}-{field.le}>"
        return "<integer>"
    return "<string>"


def _render_value(field: Field | None, item, depth: int) -> list[str]:
    """Lines for one value (a field, or an array's ``item`` when ``field``
    is None); the first line carries no indentation prefix."""
    if field is not None and field.kind == "array":
        inner_lines = _render_value(None, field.item, depth + 1)
        pad = " " * (_INDENT * (depth + 1))
        return ["[", pad + inner_lines[0], *inner_lines[1:],
                " " * (_INDENT * depth) + "]"]
    if field is None:
        if item == "string":
            return ["<string>"]
        return _render_model(item, depth)
    return [_placeholder_token(field)]


def _render_model(model: type[Contract], depth: int) -> list[str]:
    pad = " " * (_INDENT * (depth + 1))
    lines = ["{"]
    fields = model.FIELDS
    for idx, field in enumerate(fields):
        value_lines = _render_value(field, None, depth + 1)
        comma = "," if idx < len(fields) - 1 else ""
        lines.append(f'{pad}"{field.name}": {value_lines[0]}'
                     + ("" if len(value_lines) > 1 else comma))
        if len(value_lines) > 1:
            lines.extend(value_lines[1:-1])
            lines.append(value_lines[-1] + comma)
    lines.append(" " * (_INDENT * depth) + "}")
    return lines
