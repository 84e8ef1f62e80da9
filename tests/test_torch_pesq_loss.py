"""The port's differentiable PESQ loss (``sgmse_tpu_torch.utils.pesq_loss``)
against the JAX package's on the CPU: the loss and ``mos`` within 1e-5
relative (float32, the same operations in another framework), and the
gradient with respect to the degraded waveform against ``jax.grad`` within
1e-4 of max|g| (an FFT's adjoint and float32 sums in another order). At
B = 1-4, at 1 s and at the recipe's crop of 32,640 samples, for degraded
speech, identical inputs, silent degraded input and silence on both sides,
where the gradient must also be finite.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgmse_tpu.utils.pesq_loss import PesqLoss as JaxPesqLoss
from sgmse_tpu_torch.utils.pesq_loss import PesqLoss

VALUE_TOL, GRAD_TOL = 1e-5, 1e-4


def _speech(rng, batch, length):
    """A harmonic stack under a syllable-rate on/off envelope, one pitch per row."""
    t = np.arange(length) / 16000.0
    rows = []
    for _ in range(batch):
        f0 = rng.uniform(100.0, 250.0)
        env = (np.sin(2 * np.pi * rng.uniform(2.0, 5.0) * t) > 0).astype(np.float64)
        x = env * sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 6))
        rows.append(0.3 * x / np.abs(x).max())
    return np.stack(rows).astype(np.float32)


def _inputs(case, batch, length):
    rng = np.random.default_rng(batch * 7 + length % 97)
    ref = _speech(rng, batch, length)
    noise = rng.standard_normal((batch, length)).astype(np.float32)
    if case == "degraded":
        snr = np.linspace(30.0, 0.0, batch)[:, None]  # one SNR per row
        sigma = np.sqrt(np.mean(ref ** 2, -1, keepdims=True) / 10 ** (snr / 10))
        return ref, (ref + sigma * noise).astype(np.float32)
    if case == "identical":
        return ref, ref.copy()
    if case == "silent":
        return ref, np.zeros_like(ref)
    return np.zeros_like(ref), np.zeros_like(ref)  # both silent


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), (got, want)


@pytest.mark.parametrize("batch,length", [(1, 16000), (2, 32640), (3, 16000), (4, 32640)])
@pytest.mark.parametrize("case", ["degraded", "identical", "silent", "both_silent"])
def test_loss_mos_and_gradient_match_jax(case, batch, length):
    ref, deg = _inputs(case, batch, length)
    ours, theirs = PesqLoss(2.0), JaxPesqLoss(2.0)
    want = np.asarray(theirs(jnp.asarray(ref), jnp.asarray(deg)))
    want_mos = np.asarray(theirs.mos(jnp.asarray(ref), jnp.asarray(deg)))
    want_g = np.asarray(jax.grad(lambda d: jnp.sum(theirs(jnp.asarray(ref), d)))(
        jnp.asarray(deg)))

    deg_t = torch.from_numpy(deg).requires_grad_()
    loss = ours(torch.from_numpy(ref), deg_t)
    (g,) = torch.autograd.grad(loss.sum(), deg_t)
    assert loss.shape == (batch,) and loss.dtype == torch.float32
    _close(loss.detach().numpy(), want, VALUE_TOL)
    with torch.no_grad():
        _close(ours.mos(torch.from_numpy(ref), torch.from_numpy(deg)).numpy(), want_mos,
               VALUE_TOL)
    assert np.isfinite(g.numpy()).all()
    _close(g.numpy(), want_g, GRAD_TOL)
    if case == "degraded":
        assert np.abs(want_g).max() > 0 and np.all(np.diff(want) > 0)  # worse SNR, more loss


def test_one_utterance_is_squeezed_as_in_jax():
    ref, deg = _inputs("degraded", 2, 16000)
    ours, theirs = PesqLoss(1.0), JaxPesqLoss(1.0)
    got = ours(torch.from_numpy(ref[1]), torch.from_numpy(deg[1]))
    assert got.shape == () and ours.mos(torch.from_numpy(ref[1]), torch.from_numpy(deg[1])).shape == ()
    _close(got.numpy(), np.asarray(theirs(jnp.asarray(ref[1]), jnp.asarray(deg[1]))), VALUE_TOL)


def test_rejects_other_sample_rates():
    with pytest.raises(ValueError, match="16 kHz"):
        PesqLoss(1.0, sample_rate=48000)
