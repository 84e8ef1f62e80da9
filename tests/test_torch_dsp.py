"""The port's DSP (sgmse_tpu_torch.dsp) against the JAX package's (sgmse_tpu.dsp).

Inputs are numpy, seeded. Tolerance: 1e-5 relative to the reference's max
magnitude (float32 FFTs and overlap-add sums in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sgmse_tpu import dsp as jdsp
from sgmse_tpu_torch import dsp

RTOL = 1e-5


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= RTOL * scale, np.abs(got - ref).max() / scale


def _signal(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _spec(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("window", ["hann", "sqrthann"])
def test_window(window):
    np.testing.assert_array_equal(dsp.get_window(window, 510).numpy(),
                                  np.asarray(jdsp.get_window(window, 510)))


@pytest.mark.parametrize("n_fft,hop,shape", [(510, 128, (2, 8000)), (126, 32, (3, 1, 2016))])
def test_stft(n_fft, hop, shape):
    x = _signal(shape)
    w = dsp.get_window("hann", n_fft)
    got = dsp.stft(torch.from_numpy(x), n_fft, hop, w).numpy()
    ref = jdsp.stft(jnp.asarray(x), n_fft, hop, jnp.asarray(w.numpy()))
    assert got.dtype == np.complex64
    _close(got, ref)


@pytest.mark.parametrize("length", [None, 7000, 8000, 9000])
def test_istft(length):
    """Round trip through both; `length` beyond the reconstructable samples zero-pads.

    Past sample 8000 the squared-window envelope falls towards the 1e-11 floor
    and divides rounding noise up, so there the test checks only the zero tail.
    """
    x = _signal((2, 8000), seed=1)
    w = jdsp.get_window("hann", 510)
    spec = np.array(jdsp.stft(jnp.asarray(x), 510, 128, w))
    ref = np.asarray(jdsp.istft(jnp.asarray(spec), 510, 128, w, length=length))
    got = dsp.istft(torch.from_numpy(spec), 510, 128, torch.from_numpy(np.array(w)),
                    length=length).numpy()
    assert got.shape == ref.shape
    _close(got[..., :8000], ref[..., :8000])
    avail = 510 + 128 * (spec.shape[-1] - 1) - 255
    if length is not None and length > avail:
        assert not got[..., avail:].any() and not ref[..., avail:].any()


@pytest.mark.parametrize("transform", ["exponent", "log", "none"])
def test_spec_transforms(transform):
    z = _spec((2, 1, 16, 20), seed=2)
    z[0, 0, 0, :3] = 0  # zeros stay zeros
    fwd = dsp.spec_fwd(torch.from_numpy(z), transform).numpy()
    _close(fwd, jdsp.spec_fwd(jnp.asarray(z), transform))
    back = dsp.spec_back(torch.from_numpy(fwd), transform).numpy()
    _close(back, jdsp.spec_back(jnp.asarray(fwd), transform))


@pytest.mark.parametrize("mode", ["zero_pad", "reflection", "replication"])
def test_pad_spec(mode):
    z = _spec((2, 1, 8, 70), seed=3)
    got = dsp.pad_spec(torch.from_numpy(z), mode=mode).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdsp.pad_spec(jnp.asarray(z), mode=mode)))
    assert got.shape[-1] == 128


def test_spec_transform_round_trip():
    x = _signal((2, 2016), seed=4)
    port, ref = dsp.SpecTransform(n_fft=126, hop_length=32), jdsp.SpecTransform(
        n_fft=126, hop_length=32)
    spec = port.wav_to_spec(torch.from_numpy(x))
    _close(spec.numpy(), ref.wav_to_spec(jnp.asarray(x)))
    _close(port.spec_to_wav(spec, length=2016).numpy(),
           ref.spec_to_wav(jnp.asarray(spec.numpy()), length=2016))
    assert port.num_freqs == ref.num_freqs and port.config_dict() == ref.config_dict()


@pytest.mark.parametrize("frames", [2, 5, 20, 32, 33, 70])
def test_pad_spec_reflection_of_short_inputs(frames):
    """Reflection where the pad is as long as the spectrogram or longer
    (T <= 32 pads by >= T): numpy's reflect reflects again at each end."""
    z = _spec((1, 1, 4, frames), seed=5)
    got = dsp.pad_spec(torch.from_numpy(z), mode="reflection").numpy()
    np.testing.assert_array_equal(got, np.asarray(jdsp.pad_spec(jnp.asarray(z), mode="reflection")))
    assert got.shape[-1] == 64 * -(-frames // 64)


@pytest.mark.parametrize("n_fft,hop,length", [(62, 16, 700), (62, 16, 960), (1534, 384, 192000),
                                              (510, 128, 2015), (63, 16, 100)])
def test_frame_counts_match_the_transforms(n_fft, hop, length):
    """``SpecTransform.frames`` is the STFT's frame count and ``pad_length``
    is ``pad_spec``'s, for even and odd windows and any length."""
    spec = dsp.SpecTransform(n_fft=n_fft, hop_length=hop)
    frames = spec.stft(torch.zeros(1, length)).shape[-1]
    assert spec.frames(length) == frames
    padded = dsp.pad_spec(torch.zeros(1, 1, 2, frames), mode="reflection").shape[-1]
    assert dsp.pad_length(frames) == padded and padded % 64 == 0
