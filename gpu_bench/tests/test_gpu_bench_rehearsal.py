"""Each cell's run driven end to end on the CPU at a small size (the
program in float32), with the chip's look skipped: ``correct`` comes out
true, and false with each fault the cell can have planted underneath; the
control, the reference in float8, fails the cell's limits.  Nothing here is
a device metric, and nothing is written."""

import pytest
import torch

from gpu_bench import faults, manifest, run

TINY = {"spec_shape": [1, 16, 20], "test_episode_size": 2, "test_episode": 8,
        "max_segments_per_clip": 2, "precision": "fp32"}
SMALL = {
    "deepbdc-eval-b16": TINY,
    "protonet-eval-b16": {**TINY, "spec_shape": [1, 81, 90]},
    "deepbdc-episode": {**TINY, "test_episode_size": 1},
}
CPU = torch.device("cpu")


def cell_run(name, trace=False, seed=2 ** 31 + 3):
    run.prepare_environment()
    return run.run_cell(manifest.load_cell(name), seed, 0.5, trace, CPU, SMALL[name])


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_cell_runs_end_to_end_and_is_correct(name, trace):
    result = cell_run(name, trace)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "cpu" and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    cell = manifest.load_cell(name)
    expected = cell.per_layer if trace else cell.end_to_end
    assert set(result["metrics"]) <= {m["name"] for m in expected}
    if not trace:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}


CASES = [(name, fault) for name in sorted(SMALL)
         for fault in faults.FAULTS[manifest.driver(manifest.load_cell(name)).Session.KIND]]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_planted_fault_is_not_correct(name, fault):
    classifier = manifest.load_cell(name).config["config"]["classifier"]["name"]
    with faults.planted(fault, classifier):
        result = cell_run(name)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_fails_the_limits(name):
    """The control, the reference in float8 on the run's own inputs, held to
    the cell's limits through the run's own checks, while the program's run
    stays correct."""
    result = run.run_cell(manifest.load_cell(name), 2 ** 31 + 5, 0.5, False, CPU, SMALL[name],
                          control=True)
    assert result["correct"], result["checks"]
    assert result["control"]["checks"] and not result["control"]["correct"], result["control"]
    assert list(result)[-1] == "checks"
