"""The numbers compared with their limits.

``gaps``: over the served tokens that greedy decoding chose, the amount
by which the reference's logit of each served token lies below the
reference's best logit at that position. A sound program only loses
near-ties, by its rounding; a wrong one loses by the scale of the logits.
The cells compare two numbers of them:

- their mean (``mean_logit_gap``): steady over a few thousand tokens, it
  grows as the square of the logits' error (more near-ties lost, each by
  more), so a program a precision below the configuration's fails it;
- their largest (``max_logit_gap``): one wrong token reads the scale of
  the logits, where a mean over a few thousand tokens hides it.
"""

from __future__ import annotations

import torch


def gaps(logits: torch.Tensor, tokens) -> torch.Tensor:
    """By how much the reference's logit of each served token lies below
    its best logit at that position."""
    tokens = torch.as_tensor(list(tokens), dtype=torch.long,
                             device=logits.device)
    rows = torch.arange(len(tokens), device=logits.device)
    return logits.max(-1).values - logits[rows, tokens]
