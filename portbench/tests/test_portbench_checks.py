"""The checks that decide ``correct``, driven through a whole run on the CPU at a tiny size (the
look for a card skipped): each fault the cells can have, planted from outside the run
(``plant.py``), comes out not correct under the cells' own limits, where sound runs pass the
numbers the fault must fail, and the control (the reference in fp8 in the program's place) reads
apart from the program.  The tests marked ``card`` run the program, the control and a flipped tile
at the cells' own size on the card: the first correct, the others not."""

import pytest
import torch

from portbench import core
from portbench.plant import planted
from portbench.tests.tiny import tiny_cell

CPU = torch.device("cpu")
# seeds whose tiny sound runs the full-size limits hold (a tiny model is more sensitive to
# rounding than the published widths; the limits are set from full-size readings, PERF.md)
SOUND_SEED = {"dfc_serve_b128": 2, "transunet_serve_b128": 1, "dfc_train_b64": 1}
SERVING = ["dfc_serve_b128", "transunet_serve_b128"]
FAULTS = [("dfc_serve_b128", "altered_answer", "image_gap_over_bf16_max"),
          ("transunet_serve_b128", "altered_answer", "image_tail_max"),
          ("dfc_train_b64", "half_batch", "loss_gap"),
          ("dfc_train_b64", "unchanged", "change_gap_median")]
CARD_SEEDS = (2147483693, 3000000019, 4100000033)


def _run(name, seed, plant=None):
    with planted(plant):
        return core.run_cell(tiny_cell(name), seed, 0.3, False, CPU)


def _failed(result):
    return [n for n, c in result["checks"].items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("name,fault,number", FAULTS)
def test_fault_is_caught(name, fault, number):
    seed = SOUND_SEED[name]
    sound = _run(name, seed)
    assert number not in _failed(sound)
    faulty = _run(name, seed, fault)
    assert not faulty["correct"] and number in _failed(faulty)


@pytest.mark.parametrize("name", SERVING)
def test_sound_serving_run_is_correct(name):
    result = _run(name, SOUND_SEED[name])
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(tiny_cell(name).workload["limits"])


@pytest.mark.parametrize("name", sorted(SOUND_SEED))
def test_control_reads_apart_from_the_program(name):
    """The control in the program's place reads a compared number three times the program's or more
    on the same seed (whether it passes the limit, set at the cell's own size, is the card's test)."""
    seed = SOUND_SEED[name]
    sound, control = _run(name, seed)["checks"], _run(name, seed, "fp8")["checks"]
    assert any(control[n]["value"] >= 3 * sound[n]["value"] for n in sound), (sound, control)


def test_plants_are_undone():
    from dfc_sa_unet_torch.infer.predictor import Predictor
    from portbench.drivers import serve_closed

    before = Predictor.predict_probs, serve_closed._model
    for name in ("altered_answer", "fp8"):
        with planted(name):
            assert (Predictor.predict_probs, serve_closed._model) != before
        assert (Predictor.predict_probs, serve_closed._model) == before


@pytest.mark.card
@pytest.mark.parametrize("name", SERVING)
def test_checks_on_the_card(card, name):
    """At the cell's own size on three seeds: the program comes out correct, the control and a
    flipped tile in every answer not."""
    cell = core.Cell(name)
    for seed in CARD_SEEDS:
        result = core.run_cell(cell, seed, 2.0, False, card)
        assert result["correct"], result["checks"]
        for plant in ("fp8", "altered_answer"):
            with planted(plant):
                result = core.run_cell(cell, seed, 2.0, False, card)
            assert not result["correct"], (plant, result["checks"])
