"""Shared fixtures of the benchmark's tests: a tiny copy of each cell's
configuration that runs on the CPU in seconds, and the card marker's skip."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

TINY_NET = dict(nf=16, ch_mult=[1, 1, 2])


def tiny(cell_name: str, precision: str = "float32"):
    """(config, cell) of ``cell_name`` cut to a CPU test's size: a narrow
    net, a short STFT, three sampler steps, small batches of short clips."""
    cell = copy.deepcopy(harness.cell(cell_name))
    config = copy.deepcopy(harness.config(cell["config"]))
    config["network"].update(TINY_NET)
    config["stft"].update(n_fft=62, hop_length=16, num_frames=64)
    config["sde_params"]["N"] = 3
    config["precision"] = {k: precision for k in config["precision"]}
    p = cell["params"]
    if cell["driver"] == "enhance":
        p.update(batch_size=4, trace_sweeps=1, check_rows=3, check_block=2)
        p["corpus"]["groups"] = [[4, 0.04, 0.06], [4, 0.07, 0.1]]
    else:
        config["training"]["batch_size"] = 4
        p.update(trace_steps=2, check_block=2, warm_steps=1, num_workers=2)
        p["corpus"]["groups"] = [[16, 0.08, 0.15]]
    return config, cell


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
