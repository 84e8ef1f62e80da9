"""sgmse_tpu_torch: the PyTorch/CUDA port of sgmse_tpu.

Score-based generative speech enhancement in the complex STFT domain, ported
slice by slice from the JAX package ``sgmse_tpu``, which stays the reference.
Ported so far: enhancement (``python -m sgmse_tpu_torch.enhance``) with the
16 kHz SGMSE+ model, the Schroedinger bridge and the 48 kHz model and every
sampler, single-GPU training (``python -m sgmse_tpu_torch.train``, the
Schroedinger-bridge recipe's PESQ loss and the native batch loader included)
and the reference's Lightning ``.ckpt`` in both directions
(``python -m sgmse_tpu_torch.convert``), and dynamic-batching serving on one
GPU (``python -m sgmse_tpu_torch.serve``); the NCSN++ score network runs on
hand-written Hopper kernels for upfirdn2d and GroupNorm+SiLU, forward and
backward.

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
