"""The control: the cell's own run with the program's float32 path switched
on (the configuration's dtype) has to come out not correct; float64 correct.
On the card at a size a test run holds (``python -m benchmark.readings``
reads the full-size figures)."""

import pytest

from benchmark import run
from benchmark.tests.conftest import tiny_spec

CUTS = {"kitti1100.fullba": dict(num_states=300, num_points=5000),
        "phong200.multistage": dict(num_states=60, num_points=300),
        "kitti1100.window": dict(num_states=120, num_points=2500)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,correct", [("float64", True), ("float32", False)])
@pytest.mark.parametrize("cell", sorted(CUTS))
def test_control(card, search, cell, dtype, correct):
    config, mix = cell.split(".")
    spec, name = tiny_spec(search, config, mix, dtype=dtype, scene=CUTS[cell])
    result, compared = run.run_cell(spec, name, 5, 2.0, False, device=card)
    assert result["correct"] is correct, compared


def test_init_gap_control():
    """The program's VO start always runs in float64 (its RANSAC does, in
    either dtype), so ``init_gap``'s control is the reference's own initial
    guess in float32 in the program's place: it must fail the limit the
    float64 reference passes. On the CPU at a tiny size."""
    import numpy as np

    from benchmark import registry
    from benchmark.drivers import fullba

    config = registry.load_json("configs", "kitti1100")
    config["scene"].update(num_states=60, num_points=1500)
    mix = dict(registry.load_json("mixes", "fullba"), trials=1)
    limit = registry.load_json("limits", "kitti1100.fullba")["init_gap"]
    d = fullba.Driver(config, mix, 5, "cpu")
    trial = d.trials[0]
    observed = np.unique(d.ds.point_ids)
    assert fullba.init_gap(trial, d.reference_guess(trial, "cpu"), observed) <= limit
    assert fullba.init_gap(trial, d.reference_guess(trial, "cpu", np.float32), observed) > limit
