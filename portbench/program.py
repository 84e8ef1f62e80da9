"""The system under test: the port's ScoreModel of a configuration, with the
benchmark's weights in it. The only module here, with the traffic drivers
and :mod:`portbench.trace`, that imports ``sgmse_tpu_torch``."""
from __future__ import annotations

import torch

from . import weights
from .reference import nets

# The configuration's blocks whose keys the port's ScoreModel takes as they are.
BLOCKS = ("network", "stft", "sde_params", "training")


def score_model(config: dict, precision: str, device):
    """The port's ScoreModel of ``config`` computing in ``precision``
    (``bfloat16`` or ``float32``), on ``device``, in channels_last memory,
    with no weights yet."""
    from sgmse_tpu_torch.model import ScoreModel

    kwargs = {k: v for block in BLOCKS for k, v in config.get(block, {}).items()}
    kwargs.update(config.get("preconditioning", {}))
    kwargs["t_eps"] = config["t_eps"]
    kwargs["precision"] = precision
    model = ScoreModel(backbone=config["backbone"], sde=config["sde"], **kwargs)
    return model.to(device, memory_format=torch.channels_last)


def seeded_weights(config: dict, seed: int, device):
    """The benchmark's weights of ``config`` for ``seed`` (see :mod:`.weights`),
    keyed by the leaves of the plain reference, which are the port's."""
    with torch.device("meta"):
        shape_net = nets.build(config)
    return weights.make(shape_net, seed, device, **config.get("weights", {}))
