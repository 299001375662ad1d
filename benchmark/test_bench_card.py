"""The flagship cell on the card, a one-second window: it builds, runs and
judges itself correct. Skips without a card."""

import pytest

from benchmark import harness


@pytest.mark.cuda
def test_flagship_cell_on_the_card(card):
    res = harness.run(harness.Cell("rtiow_final.render"), 2 ** 31 + 99, 1.0,
                      False, device=card)
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["metrics"]["render_mrays_per_s"]["value"] > 0
