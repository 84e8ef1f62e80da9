"""Plain enhancement: the pipeline and the two samplers the cells run.

A frozen copy of the port's ``ScoreModel.enhance`` (``model.py``: max-abs
normalisation, STFT and compression, frame padding, the sampler, the inverse
transform, un-normalisation), its forward contracts (``ncsnpp``: score =
-dnn; ``ncsnpp_v2`` with ``data_prediction`` and the identity
preconditioning: the clean estimate = dnn) and of ``sampling.py``'s
``pc_sampler`` with the ``reverse_diffusion`` predictor and the ``ald``
corrector (one step) and ``sb_sampler``'s ``ode`` variant.

The PC noise is given, as the benchmark hands it to the program: ``noise``
(N + 1, B, 1, F, T), the prior draw then each predictor step's, and
``corrector_noise`` (N, 1, B, 1, F, T).

``fault`` plants one of two faults of the state's path, as controls of the
comparison: ``"state_swap"``, the network reading the state x_t with its
real and imaginary parts swapped; ``"step_off"``, every sampler step 10%
longer than its grid says (PC: the predictor's step; SB: each step's time
moved from T by 1.1 times its distance, at least ``eps``).
"""
from __future__ import annotations

import torch

from .dsp import Spec, pad_spec
from .sdes import OUVE, SBVE, bcast


def model_fn(config: dict, net):
    """The score (``ncsnpp``) or clean estimate (``ncsnpp_v2``) of the network."""
    if config["backbone"] == "ncsnpp":
        return lambda x, y, t: -net(x, y, t)
    pre = config.get("preconditioning", {})
    if any(pre.get(k, d) != d for k, d in (("c_in", "1"), ("c_out", "1"), ("c_skip", "0"),
                                          ("network_scaling", None))):
        raise NotImplementedError("the plain reference has the identity preconditioning only")
    return net


FAULTS = ("state_swap", "step_off")
STEP_OFF = 1.1


def pc_sampler(fn, sde: OUVE, y, eps, snr, noise, corrector_noise, step_scale=1.0):
    n = sde.N
    b = y.shape[0]
    ts = torch.linspace(sde.T, eps, n, dtype=torch.float32, device=y.device)
    steps = torch.cat([ts[:-1] - ts[1:], ts[-1:]]) * step_scale
    std_T = sde.std(torch.full((b,), sde.T, device=y.device))
    x = y + noise[0] * bcast(std_T)
    x_mean = x
    for i in range(n):
        t = ts[i].expand(b)
        # ald corrector: step = 2 (snr std(t))^2
        step = (snr * sde.std(t)) ** 2 * 2.0
        x = x + bcast(step) * fn(x, y, t) + corrector_noise[i][0] * bcast(torch.sqrt(step * 2.0))
        # reverse-diffusion predictor
        score = fn(x, y, t)
        drift, diffusion = sde.drift_diffusion(x, y, t)
        f, g = drift * steps[i], diffusion * torch.sqrt(steps[i])
        x_mean = x - (f - bcast(g ** 2) * score)
        x = x_mean + bcast(g) * noise[1 + i]
    return x_mean


def sb_ode_sampler(fn, sde: SBVE, y, eps=1e-4, step_scale=1.0):
    n, b = sde.N, y.shape[0]
    ts = torch.linspace(sde.T, eps, n + 1, dtype=torch.float32, device=y.device)
    if step_scale != 1.0:
        ts = torch.clamp(sde.T - step_scale * (sde.T - ts), min=eps)
    sigma_prev, _, sbar_prev, alpha_prev, _, _ = sde.sigmas_alphas(ts[0].expand(b))
    x = y
    for i in range(1, n + 1):
        t = ts[i].expand(b)
        sigma_t, sigma_T, sbar_t, alpha_t, alpha_T, _ = sde.sigmas_alphas(t)
        est = fn(x, y, t)
        w_prev = alpha_t * sigma_t * sbar_t / (alpha_prev * sigma_prev * sbar_prev + sde.eps)
        w_est = (alpha_t / (sigma_T ** 2 + sde.eps)
                 * (sbar_t ** 2 - sbar_prev * sigma_t * sbar_t / (sigma_prev + sde.eps)))
        w_prior = (alpha_t / (alpha_T * sigma_T ** 2 + sde.eps)
                   * (sigma_t ** 2 - sigma_prev * sigma_t * sbar_t / (sbar_prev + sde.eps)))
        x = bcast(w_prev) * x + bcast(w_est) * est + bcast(w_prior) * y
        alpha_prev, sigma_prev, sbar_prev = alpha_t, sigma_t, sbar_t
    return x


@torch.no_grad()
def enhance(config: dict, net, sde, y_wav: torch.Tensor, noise=None, corrector_noise=None,
            fault=None):
    """Enhanced waveforms (B, L) of the noisy rows ``y_wav`` (B, L), float32."""
    if fault not in (None,) + FAULTS:
        raise ValueError(f"fault {fault!r}: one of {FAULTS}")
    spec = Spec(**config["stft"])
    sampler = config["sampler"]
    fn = model_fn(config, net)
    if fault == "state_swap":
        clean = fn

        def fn(x, y, t):
            return clean(torch.complex(x.imag, x.real), y, t)
    step_scale = STEP_OFF if fault == "step_off" else 1.0
    length = y_wav.shape[-1]
    norm = y_wav.abs().amax(dim=-1, keepdim=True).clamp_min(1e-10)
    y = pad_spec(spec.wav_to_spec(y_wav / norm)[:, None], sampler["pad_mode"])
    if sampler["type"] == "pc":
        x = pc_sampler(fn, sde, y, config["t_eps"], sampler["snr"], noise, corrector_noise,
                       step_scale)
    elif sampler["type"] == "sb_ode":
        x = sb_ode_sampler(fn, sde, y, step_scale=step_scale)
    else:
        raise NotImplementedError(f"sampler {sampler['type']!r}")
    return spec.spec_to_wav(x[:, 0], length) * norm
