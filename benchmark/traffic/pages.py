"""Folders of synthetic page photographs and the token budget of each.

``synthetic_pages`` follows ``bench.py:117`` (and ``chip_smoke.py:427``):
paper-like noise N(235, 8) clipped to [180, 255], with dark horizontal
strokes (3 rows high, 30-109 pixels long, gray 10-59) standing in for
handwriting. It is drawn on the card in a few calls from a generator
seeded by ``--seed`` and handed to the program as host arrays, as a
decoded page file would be.

``page_budgets`` follows ``bench.py:131`` (``page_token_budgets``): a
lognormal around a typical page's length, clipped, standing in for the
EOS of real pages (random weights rarely emit it). Every seed gets the
same set of budgets, the lognormal's quantiles at (i + 0.5) / n, in its
own order, so that seeds change which page waits for which and not how
much work a folder is (and, with ``block``, not how much work a stretch
of it is).
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np
import torch


def synthetic_pages(n_pages: int, height: int, width: int, strokes: int,
                    seed: int, device) -> list[np.ndarray]:
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    pages = torch.randn((n_pages, height, width, 3), generator=gen,
                        device=device).mul_(8).add_(235).clamp_(180, 255)
    pages = pages.to(torch.uint8)
    shape = (n_pages, strokes)
    ys = torch.randint(20, height - 20, shape, generator=gen, device=device)
    xs = torch.randint(10, width - 120, shape, generator=gen, device=device)
    lengths = torch.randint(30, 110, shape, generator=gen, device=device)
    values = torch.randint(10, 60, shape, generator=gen, device=device)
    host = pages.cpu().numpy()
    for page, y, x, n, value in zip(host, ys.tolist(), xs.tolist(),
                                    lengths.tolist(), values.tolist()):
        for yy, xx, nn, vv in zip(y, x, n, value):
            page[yy:yy + 3, xx:xx + nn] = vv
    return list(host)


def lognormal_set(n: int, median: float, sigma: float, low: int,
                  high: int) -> list[int]:
    """The lognormal's quantiles at (i + 0.5) / n, clipped and rounded."""
    normal = NormalDist()
    return [int(min(max(median * math.exp(sigma * normal.inv_cdf((i + 0.5) / n)),
                        low), high)) for i in range(n)]


def page_budgets(n_pages: int, budget: dict, rng: np.random.Generator) -> list[int]:
    """The folder's budgets: the lognormal's set in the seed's order, or,
    with ``block``, in one order for every seed. There every ``block``
    consecutive pages (one admission of the batcher's slots) take one
    budget from each ``block``-th of the sorted set, rotated so that the
    stretches carry like loads, short and long pages alternating within
    each. Where a folder is read to its end, the order of the long pages
    sets how long its last reads run alone: drawn per seed, it moved a
    48-page folder's steps by a third (3113-4259 in a simulation of the
    slots), so the seed draws the pages and the weights, not this order."""
    values = lognormal_set(n_pages, budget["median"], budget["sigma"],
                           budget["min"], budget["max"])
    block = budget.get("block")
    if not block:
        return [values[i] for i in rng.permutation(n_pages)]
    if n_pages % block:
        raise ValueError(f"{n_pages} pages do not split into blocks of {block}")
    n_blocks = n_pages // block
    groups = [values[g * n_blocks:(g + 1) * n_blocks] for g in range(block)]
    # shortest, longest, second shortest, second longest, ...
    order = [g for pair in zip(range(block), range(block - 1, -1, -1))
             for g in pair][:block]
    return [groups[g][(b + g) % n_blocks]
            for b in range(n_blocks) for g in order]


def folders(cell: dict, seed: int, device) -> list[dict]:
    """``cell["folders"]`` folders of ``cell["pages"]`` pages, each page
    with its budget."""
    rng = np.random.default_rng(int(seed))
    out = []
    for index in range(cell["folders"]):
        pages = synthetic_pages(cell["pages"], cell["height"], cell["width"],
                                cell["strokes"], int(seed) * 131 + index, device)
        out.append({"pages": pages,
                    "budgets": page_budgets(cell["pages"], cell["budget"], rng)})
    return out
