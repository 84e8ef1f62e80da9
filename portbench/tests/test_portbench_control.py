"""On the card, at each cell's own size: the program's numbers fall within
the cell's limits and its control's do not (the plain reference one
precision below the configuration's, in the program's place; for the train
cell also half of each batch left out). ``portbench/readings.py`` reads the
same over many seeds."""
import pytest

from portbench import harness, readings

CONTROLS = {"enhance": ["fp8"], "train": ["bf16", "half_batch"]}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.benchmark()["workloads"]])
def test_control_fails_where_the_program_passes(card, cell):
    spec = harness.cell(cell)
    limits = spec["limits"]
    controls = CONTROLS[spec["driver"]]
    row = readings.readings(cell, [2 ** 31 + 101], controls, device=card)[0]
    for name, value in row["program"].items():
        if name in limits:
            assert value <= limits[name], (name, value)
    for c in controls:
        failed = [k for k, v in row[c].items() if k in limits and v > limits[k]]
        assert failed, (c, row[c])
