"""The port's training loss (ScoreModel.step_loss) and its gradient with
respect to every parameter, against jax.value_and_grad of the JAX package's
step_loss, for the three loss types.

Both sides start from one JAX initialisation (mapped through
``convert.params_from_jax``) and get the same spectrograms; the port is given
the diffusion times and the noise that the JAX step draws
(``kt, kz, kd = jax.random.split(key, 3)``, ``uniform(kt)``, ``crandn(kz)``).
The network is the small test config (nf 16, ch_mult 1,1,2, F = T = 64).
Gradients are compared leaf by leaf after mapping the JAX tree onto the port's
names; the Fourier projection's W gets no gradient on either side.
Tolerance: 1e-4 relative max-abs per leaf and on the loss (float32, two
frameworks, a backward pass through the whole network). The attention key
bias (``NIN_1.b``) has a gradient of exactly zero (a constant added to every
logit of a query leaves its softmax unchanged), so both sides give rounding
noise there: it is held below 1e-6 of the largest gradient instead.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgmse_tpu.model import ScoreModel as JaxScoreModel
from sgmse_tpu.sdes import crandn as jax_crandn
from sgmse_tpu_torch import convert
from sgmse_tpu_torch.model import ScoreModel

NET = dict(nf=16, ch_mult=(1, 1, 2), num_res_blocks=1, attn_resolutions=(16,), image_size=64,
           init_scale=1.0, n_fft=126, hop_length=32, num_frames=64)
CASES = {
    "score_matching": ("ncsnpp", "ouve", {}),
    "denoiser": ("ncsnpp_v2", "ouve", dict(loss_type="denoiser", loss_weighting="edm",
                                           c_in="edm", c_out="edm", c_skip="edm")),
    "data_prediction": ("ncsnpp_v2", "sbve", dict(loss_type="data_prediction")),
    # the Schroedinger-bridge recipe's loss: the PESQ term on the 2,016-sample crops
    "data_prediction_pesq": ("ncsnpp_v2", "sbve", dict(loss_type="data_prediction",
                                                       pesq_weight=5e-4)),
}
TOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """The small networks here run fastest, and share a loaded machine best, on
    one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves_close(got: dict, ref: dict):
    assert set(got) == set(ref), set(got) ^ set(ref)
    scale = max(np.abs(r).max() for r in ref.values())
    for name in ref:
        g, r = got[name], ref[name]
        assert g.shape == r.shape, name
        if name.endswith("NIN_1.b"):  # exactly zero: rounding noise on both sides
            assert max(np.abs(g).max(), np.abs(r).max()) <= 1e-6 * scale, name
            continue
        err = np.abs(g - r).max()
        assert err <= TOL * np.abs(r).max(), (name, err, np.abs(r).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_loss_and_gradients_match_jax(case):
    backbone, sde, extra = CASES[case]
    jmodel = JaxScoreModel(backbone, sde, **NET, **extra)
    x0 = np.zeros((1, 1, 64, 64), np.complex64)
    variables = jax.tree.map(np.asarray, jax.jit(jmodel.dnn.init)(
        jax.random.key(2), x0, x0, np.full((1,), 0.5, np.float32)))

    rng = np.random.default_rng(3)
    shape = (2, 1, 64, 64)
    x, y = ((0.3 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)))
            .astype(np.complex64) for _ in range(2))
    key = jax.random.key(5)
    kt, kz, _ = jax.random.split(key, 3)
    t = np.asarray(jax.random.uniform(kt, (2,), minval=jmodel.t_eps, maxval=jmodel.sde.T))
    z = np.asarray(jax_crandn(kz, shape))

    def loss_fn(params):
        return jmodel.step_loss({"params": params}, (jnp.asarray(x), jnp.asarray(y)), key,
                                train=True)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    ref = convert.state_dict_from_jax(jax.tree.map(np.asarray, ref_grads))
    w = [k for k in ref if k.endswith("fourier.W")]
    assert len(w) == 1 and not ref.pop(w[0]).abs().max()  # stop-gradient'd in JAX

    model = ScoreModel(backbone, sde, **NET, **extra)
    model.dnn.load_state_dict(convert.params_from_jax(variables["params"], backbone, **{
        k: v for k, v in NET.items() if k not in ("n_fft", "hop_length", "num_frames")}))
    model = model.to(memory_format=torch.channels_last).train()
    loss = model.step_loss(torch.from_numpy(x), torch.from_numpy(y), t=torch.tensor(t),
                           z=torch.tensor(z))
    params = {n: p for n, p in model.dnn.named_parameters() if p.requires_grad}
    grads = torch.autograd.grad(loss, list(params.values()))
    assert abs(loss.item() - float(ref_loss)) <= TOL * abs(float(ref_loss))
    _leaves_close({n: g.numpy() for n, g in zip(params, grads)},
                  {n: v.numpy() for n, v in ref.items()})


def test_pesq_loss_term_is_not_ported_yet():
    """The PESQ term is ported (the name predates it): with ``pesq_weight`` > 0
    the data-prediction loss is the loss without it plus ``pesq_weight`` times
    the mean PESQ loss of the estimate against the clean waveform; the weight
    stays in the config; a 48 kHz model with the term raises at construction,
    as in the JAX package."""
    rng = np.random.default_rng(4)
    x, y = (torch.from_numpy((0.3 * (rng.standard_normal((2, 1, 64, 64))
                                     + 1j * rng.standard_normal((2, 1, 64, 64))))
                             .astype(np.complex64)) for _ in range(2))
    t, z = torch.tensor([0.2, 0.7]), torch.from_numpy(
        (rng.standard_normal((2, 1, 64, 64)) + 1j * rng.standard_normal((2, 1, 64, 64)))
        .astype(np.complex64))
    losses = []
    for weight in (0.0, 5e-4):
        model = ScoreModel("ncsnpp_v2", "sbve", loss_type="data_prediction",
                           pesq_weight=weight, **NET)
        model.init_params(torch.Generator().manual_seed(0))
        losses.append(model.eval().step_loss(x, y, t=t, z=z))
    assert model.config_dict()["pesq_weight"] == 5e-4
    with torch.no_grad():
        mean, std = model.sde.marginal_prob(x, y, t)
        x_hat = model(mean + std[:, None, None, None] * z, y, t)
        n = model.spec.target_len
        term = model._pesq_loss(model.to_audio(x[:, 0], n), model.to_audio(x_hat[:, 0], n))
    assert term.shape == (2,) and float(term.min()) > 0
    torch.testing.assert_close(losses[1], losses[0] + 5e-4 * term.mean(), rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="16 kHz"):
        ScoreModel("ncsnpp_48k", "ouve", sr=48000, pesq_weight=5e-4, **NET)


def test_step_loss_draws_from_the_generator():
    """Without injected t and z, the draws come from the generator: one seed,
    one loss."""
    model = ScoreModel("ncsnpp", "ouve", **NET)
    model.init_params(torch.Generator().manual_seed(0))
    x = torch.full((2, 1, 64, 64), 0.1 + 0.2j, dtype=torch.complex64)
    losses = [model.step_loss(x, x, torch.Generator().manual_seed(s)).item() for s in (1, 1, 2)]
    assert losses[0] == losses[1] != losses[2]
