"""Traffic made from --seed: the same seed gives the same inputs, another
seed other inputs in the same amounts."""

import numpy as np
import torch

from benchmark.traffic import pages

CELL = {"folders": 2, "pages": 3, "height": 224, "width": 224, "strokes": 6,
        "budget": {"median": 600, "sigma": 0.55, "min": 64, "max": 2048}}


def test_folders_are_deterministic_by_seed():
    a = pages.folders(CELL, 2**31 + 7, torch.device("cpu"))
    b = pages.folders(CELL, 2**31 + 7, torch.device("cpu"))
    c = pages.folders(CELL, 2**31 + 8, torch.device("cpu"))
    for fa, fb in zip(a, b):
        assert fa["budgets"] == fb["budgets"]
        assert all(np.array_equal(x, y) for x, y in zip(fa["pages"], fb["pages"]))
    assert not np.array_equal(a[0]["pages"][0], c[0]["pages"][0])
    assert a[0]["pages"][0].dtype == np.uint8
    assert a[0]["pages"][0].shape == (224, 224, 3)


def test_every_seed_gets_the_same_budgets_in_its_own_order():
    rng = np.random.default_rng
    one = pages.page_budgets(48, CELL["budget"], rng(1))
    two = pages.page_budgets(48, CELL["budget"], rng(2))
    assert sorted(one) == sorted(two) and one != two
    assert min(one) >= 64 and max(one) == 2048
    values = pages.lognormal_set(48, 600, 0.55, 64, 2048)
    assert values[23] < 600 < values[24]          # the median sits between


def test_blocks_deal_one_order_for_every_seed():
    budget = {**CELL["budget"], "block": 12}
    rng = np.random.default_rng
    one = pages.page_budgets(48, budget, rng(1))
    assert one == pages.page_budgets(48, budget, rng(2))
    values = pages.lognormal_set(48, 600, 0.55, 64, 2048)
    assert sorted(one) == values
    ranks = [values.index(v) // 4 for v in one]
    for b in range(4):      # every block: one budget of each rank group
        assert sorted(ranks[12 * b:12 * b + 12]) == list(range(12))
    loads = [sum(one[12 * b:12 * b + 12]) for b in range(4)]
    assert max(loads) < 1.1 * min(loads)
