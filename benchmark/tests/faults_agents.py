"""Faults planted underneath guided decode's timed path, for the tests of
the agent cell's comparison: each must turn ``correct`` false. (A step
that returns its state unchanged is ``faults.stale_cache``, shared with
the OCR cells.)"""

import torch

from benchmark.reference.chat import DenseTokenizer

# the scaffold before the critic's first choice, the first digit of
# ``overall_confidence``: its first token comes with the prefill, and each
# top-k step commits one more
FIRST_CHOICE = len(DenseTokenizer().encode('{"overall_confidence": '))


def wrong_choice(step: int = FIRST_CHOICE - 1):
    """A wrong choice at one constrained position: at the ``step``-th
    top-k step of the window (0-based; by default the one that commits
    the first digit of each session admitted first), every slot's top-k
    is the ids of the characters ' ' to '_' in order, so each session at
    a choice decides by ids the model does not rank there."""
    calls = [0]

    def fault(name, args, out, batcher):
        if name != "step_topk":
            return out
        calls[0] += 1
        if calls[0] - 1 != step:
            return out
        out = out.clone()
        out[:] = torch.arange(32, 32 + out.shape[1], device=out.device)
        return out
    return fault


def one_altered_string_token():
    """One string token of each turn altered where it is produced: the
    first token of the first string chunk that serves it becomes another
    id of the same character (+256), so the session reads the same text
    and the turn goes on as before; only the id differs."""
    altered: set = set()

    def fault(name, args, out, batcher):
        if name != "string_chunk":
            return out
        tokens = out[0].clone()
        auto = args[2]
        vocab = batcher.program.cfg.vocab_size
        eos = batcher.program.eos_token_id
        for slot, request in batcher._slot_req.items():
            token = int(tokens[slot, 0])
            if id(request) in altered or not bool(auto[slot]) or token == eos:
                continue
            altered.add(id(request))
            other = token + 256
            if other >= vocab - vocab % 256 or other == eos:
                other = token - 256
            tokens[slot, 0] = other
        return (tokens, *out[1:])
    return fault
