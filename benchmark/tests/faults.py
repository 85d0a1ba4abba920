"""Faults planted underneath the timed path, for the tests of the
comparison that decides ``correct``: each is a fault a served cell can
have, and each must turn ``correct`` false."""

import contextlib


def altered_token(name, args, out, batcher):
    """A token altered where it is produced: each live slot's first token
    of every decode chunk is another id than the one the step chose (the
    step goes on from the chosen one)."""
    if name != "decode_chunk":
        return out
    tokens = out[0].clone()
    live = tokens[:, 0] != batcher.program.eos_token_id
    tokens[live, 0] = (tokens[live, 0] + 1) % 151000
    return (tokens, *out[1:])


def one_altered_token():
    """A fault that alters one token of each read: the first token of the
    first decode chunk that serves it, as ``altered_token`` does. At the
    cells' size a read has hundreds of tokens, and one wrong token among
    them barely moves their mean gap."""
    altered: set = set()

    def fault(name, args, out, batcher):
        if name != "decode_chunk":
            return out
        tokens = out[0].clone()
        eos = batcher.program.eos_token_id
        for slot, request in batcher._slot_req.items():
            if id(request) in altered or int(tokens[slot, 0]) == eos:
                continue
            altered.add(id(request))
            tokens[slot, 0] = (tokens[slot, 0] + 1) % 151000
        return (tokens, *out[1:])
    return fault


@contextlib.contextmanager
def stale_cache():
    """A step that returns its state unchanged: every decode-shaped
    forward leaves the KV pools and the lengths as it found them, so each
    step sees the prompt alone, at the same position."""
    from handwritten_ocr_tpu_torch.engine import serving
    original = serving.paged_forward

    def unchanged(params, cfg, embeds, position_ids, cache, *args, **kw):
        if kw.get("fresh"):
            return original(params, cfg, embeds, position_ids, cache, *args,
                            **kw)
        saved = {name: getattr(cache, name).clone()
                 for name in ("k", "v", "k_scale", "v_scale", "lengths")
                 if getattr(cache, name) is not None}
        out = original(params, cfg, embeds, position_ids, cache, *args, **kw)
        for name, tensor in saved.items():
            getattr(cache, name).copy_(tensor)
        return out
    serving.paged_forward = unchanged
    try:
        yield
    finally:
        serving.paged_forward = original
