"""Inference-time dispatch on the backbone name. Counterpart of
``target_sr_and_pad`` in ``sgmse_tpu/utils/inference.py`` (a module that imports
jax, so the port keeps its own copy)."""
from __future__ import annotations

from typing import Tuple


def target_sr_and_pad(backbone: str) -> Tuple[int, str]:
    """(target sample rate, spectrogram pad mode) of a backbone: the 48 kHz
    model runs at 48 kHz with reflection padding, ``ncsnpp_v2`` at 16 kHz with
    reflection padding, everything else at 16 kHz with zero padding."""
    if backbone == "ncsnpp_48k":
        return 48000, "reflection"
    if backbone == "ncsnpp_v2":
        return 16000, "reflection"
    return 16000, "zero_pad"
