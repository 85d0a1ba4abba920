"""Host ms the schema sessions take a committed token: the batcher's
``session_s`` (every call into ``SchemaSession``: its start, each
``next_token`` and each string chunk's absorption) over its
``guided_tokens``."""


def read(m):
    tokens = m.counters.get("guided_tokens")
    spent = m.counters.get("session_s")
    return spent / tokens * 1e3 if tokens and spent is not None else None
