"""Synthetic page transcriptions for the agent cells.

A folder is ``cell["turns"]`` pages, the same for every seed: page
``i``'s length in characters (one token each under the byte tokenizer)
is the folder's page budget from ``traffic/pages.py:page_budgets`` (the
lognormal's quantiles, dealt in one order with ``block``), its words are
drawn from ``cell["words"]`` by a generator seeded by
``cell["pages_seed"]``. A round is the folder in an order drawn from
(``--seed``, round): each ``block`` of pages (one admission's worth) is
shuffled within itself, so a round's stretches keep their loads.

Why the seed draws the order and not the words: with words drawn per
seed, the answers' shapes moved the guided schedule by a third (863-1241
steps a round over six seeds, where two runs of one seed took the same
steps), so seeds changed how much work a round is.
"""

from __future__ import annotations

import numpy as np

from benchmark.traffic.pages import page_budgets


def transcription(words, n_chars: int, rng: np.random.Generator) -> str:
    """Words joined by spaces, a line break after every 12, cut to
    ``n_chars``."""
    picked = rng.choice(len(words), size=n_chars // 2 + 1)
    text = ""
    for count, index in enumerate(picked, 1):
        text += words[index] + ("\n" if count % 12 == 0 else " ")
        if len(text) >= n_chars:
            break
    return text[:n_chars]


def folder(cell: dict) -> list[str]:
    """The folder's pages, in their dealt order."""
    rng = np.random.default_rng(int(cell["pages_seed"]))
    return [transcription(cell["words"], n, rng)
            for n in page_budgets(cell["turns"], cell["length"], rng)]


def round_texts(cell: dict, seed: int, index: int) -> list[str]:
    """The transcriptions of round ``index``, in the round's order."""
    pages = folder(cell)
    block = cell["length"].get("block") or len(pages)
    rng = np.random.default_rng([int(seed), int(index)])
    order = [start + int(i) for start in range(0, len(pages), block)
             for i in rng.permutation(min(block, len(pages) - start))]
    return [pages[i] for i in order]
