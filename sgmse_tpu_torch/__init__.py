"""sgmse_tpu_torch: the PyTorch/CUDA port of sgmse_tpu.

Score-based generative speech enhancement in the complex STFT domain, ported
slice by slice from the JAX package ``sgmse_tpu``, which stays the reference.
This slice covers the 16 kHz enhancement path: STFT prep, the
predictor-corrector sampler on the OUVE SDE, the NCSN++ score network with
hand-written Hopper kernels for upfirdn2d and GroupNorm+SiLU, and the iSTFT.

Imports torch, numpy and scipy only; never jax or sgmse_tpu.
"""
from . import dsp, sampling, sdes
from .dsp import SpecTransform
from .model import ScoreModel
from .models import BackboneRegistry
from .sampling import CorrectorRegistry, PredictorRegistry
from .sdes import SDERegistry

__all__ = [
    "SpecTransform", "ScoreModel", "SDERegistry", "BackboneRegistry",
    "PredictorRegistry", "CorrectorRegistry", "dsp", "sdes", "sampling",
]
