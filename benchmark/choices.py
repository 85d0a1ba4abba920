"""The choices of schema-guided decode, held against the reference.

Outside string values, every token guided decode commits comes from one
top-k step: the host's schema session (``utils/schema_decode.py``)
either forces a scaffold token or makes a **choice** from the step's
top-k: an enum option, an integer digit (or the integer's end), an
array's continue or stop. It scans the top-k in order and the first
token that decides something decides (``decider``, a copy of the
session's scans; EOS decides the default).

``walk`` replays a turn's committed tokens through a fresh session and
tells each position's kind (forced, string, or the choice's state); it
gives the session the program's own top-k at each choice, so a replay
that does not commit the program's token is counted as a mismatch.
At a choice the reference decides on its own top-k in a fresh session
replayed to that position (``reference_pick``); the **choice gap** is the
reference's logit of its deciding token minus its logit of the
program's deciding token (where a scan finds none, the last token it
scanned): a sound program differs from the reference only at near-ties,
a wrong choice by the logits' scale.

The session is the port's, the comparison's one use of program code: it
says what the schema accepted at each position, host logic that the
port's tests hold against the JAX package on the CPU.
"""

from __future__ import annotations

import re

_DIGITS = re.compile(r"[0-9]+")


def _session(spec, tokenizer, eos: int, budget: int):
    from handwritten_ocr_tpu_torch.utils.schema_decode import SchemaSession
    return SchemaSession(spec, tokenizer, eos, budget)


def state(session):
    """None where the next token is forced (or the session is done),
    "string" inside a string value, else the choice's (kind, payload,
    digits so far)."""
    if session.done or session._forced or session._action is None:
        return None
    kind, payload = session._action
    if kind == "string":
        return "string"
    return kind, payload, session._int_digits


def decider(choice, order, decode, eos: int) -> int | None:
    """The token of ``order`` that decides ``choice`` under the session's
    scan, or None where none does."""
    kind, payload, digits = choice
    if kind == "integer":
        most = len(str(payload.hi if payload.hi is not None else 999))
    for token in order:
        token = int(token)
        if token == eos:
            return token
        text = decode([token]).strip()
        if not text:
            continue
        if kind == "enum":
            if any(o.startswith(text) or text.startswith(o) for o in payload):
                return token
        elif kind == "integer":
            if _DIGITS.fullmatch(text) and len(digits) + len(text) <= most:
                return token
        elif text[0] in ",]}" or (text[0] in '"{' and text[0] == payload[1]):
            return token
    return None


def walk(tokens, rows: dict, spec, tokenizer, eos: int, budget: int):
    """(each position's state, replay mismatches) of a turn's committed
    ``tokens``; ``rows``: the program's top-k ids by token index. A token
    past the budget is the filler EOS of a string chunk that the budget
    stalled (``run_guided``'s ``string_chunk_round``), no token the model
    chose: its state is None."""
    session = _session(spec, tokenizer, eos, budget)
    states, mismatches = [], 0
    for index, token in enumerate(tokens):
        if index >= budget:
            states.append(None)
            continue
        now = state(session)
        states.append(now)
        top = rows.get(index, [token]) if isinstance(now, tuple) else [token]
        want = None if now == "string" and token == eos else token
        mismatches += session.next_token(top) != want
    return states, mismatches


def reference_pick(tokens, rows: dict, index: int, order, spec, tokenizer,
                   eos: int, budget: int) -> int | None:
    """The token a fresh session commits at ``index`` from the
    reference's top-k ``order``, replayed to there on the committed
    tokens."""
    session = _session(spec, tokenizer, eos, budget)
    for i, token in enumerate(tokens[:index]):
        session.next_token(rows.get(i, [token]))
    return session.next_token([int(t) for t in order])


def gap(logits, choice, program_order, reference_order, decode,
        eos: int) -> float:
    """The choice gap at one position (``logits``: the reference's, [V])."""
    def decisive(order):
        token = decider(choice, order, decode, eos)
        return int(order[-1]) if token is None else token
    return float(logits[decisive(reference_order)]
                 - logits[decisive(program_order)])
