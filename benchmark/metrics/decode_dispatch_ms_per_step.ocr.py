"""Host ms a decode step spends enqueuing its work: the port's
``decode.step`` spans (each step's forward, token write and done update,
from the flag read to the next) over its ``decode_steps`` counter. Where
it nears ``decode_step_ms.ocr`` the step is bound by the host's
dispatch, which a captured step would remove."""

from benchmark.program_spans import seconds


def read(m):
    steps = m.counters.get("decode_steps")
    spent = seconds(m, "decode.step")
    return spent / steps * 1e3 if steps and spent is not None else None
