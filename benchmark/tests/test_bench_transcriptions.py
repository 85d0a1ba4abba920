"""The agent cell's traffic from --seed: one folder of pages for every
seed, dealt in an order the seed and the round draw, each admission's
block of pages kept together."""

import json
from pathlib import Path

from benchmark.traffic import transcriptions
from benchmark.traffic.pages import lognormal_set

CELL = json.loads((Path(__file__).resolve().parents[1] / "workloads"
                   / "agents.critic48.json").read_text())


def test_every_seed_and_round_reads_the_same_folder_in_its_own_order():
    one = transcriptions.round_texts(CELL, 2**31 + 7, 0)
    assert one == transcriptions.round_texts(CELL, 2**31 + 7, 0)
    others = [transcriptions.round_texts(CELL, 2**31 + 8, 0),
              transcriptions.round_texts(CELL, 2**31 + 7, 1)]
    for other in others:
        assert sorted(other) == sorted(one) and other != one
    assert sorted(len(t) for t in one) == lognormal_set(48, 600, 0.55, 64,
                                                        2048)


def test_each_block_of_twelve_keeps_its_pages():
    pages = transcriptions.folder(CELL)
    shuffled = transcriptions.round_texts(CELL, 2**31 + 9, 3)
    for start in range(0, 48, 12):
        assert sorted(shuffled[start:start + 12]) == \
            sorted(pages[start:start + 12])
    words = set(CELL["words"])
    assert all(set(t.split()) - words <= {t.split()[-1]} for t in pages)
