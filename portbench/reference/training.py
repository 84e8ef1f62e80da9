"""Plain training: the Schroedinger-bridge recipe's first train steps.

A frozen copy of the port's train step at commit d7fbb27 (``train.py``
``train_step``, ``apply_gradients``, ``ema_update``; ``model.py``
``step_loss`` and ``_loss`` with ``data_prediction``):

- the spectrograms of the waveform batch (STFT, compression);
- t ~ U(t_eps, 1) and the complex normal z drawn from the generator state the
  benchmark handed to the program's step, in the program's documented order
  (t, then z's real and imaginary parts), x_t = mean + std z (SBVE);
- the clean estimate net(x_t, y, t); the loss: the TF-domain MSE,
  ``l1_weight`` times the time-domain L1 through the iSTFT, ``pesq_weight``
  times the PESQ loss of the estimate against the clean crop;
- gradients by autograd, accumulated over blocks of rows (the loss is a mean
  over rows, so the block gradients, weighted by their rows, add up to the
  batch's), in float32 with TF32 off;
- Adam (lr, betas (0.9, 0.999), eps 1e-8, as ``torch.optim.Adam`` computes
  it) and the EMA with torch_ema's ramp min(decay, (1 + n) / (10 + n)), the
  decay in float32.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .nets import precision as net_precision
from .dsp import Spec
from .pesq_loss import PesqLoss
from .sdes import SBVE, bcast, crandn

BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


FAULTS = ("no_pesq", "answer_altered")


def block_loss(config: dict, net, spec: Spec, sde: SBVE, pesq: PesqLoss, x_wav, y_wav, t, z,
               batch: int, fault=None):
    """(loss, PESQ term): the sums over these rows of each row's loss and of
    its PESQ loss, over the whole batch's rows. ``fault``: ``"no_pesq"``
    leaves the PESQ term out of the loss, ``"answer_altered"`` returns the
    loss 1.5 times what it is."""
    tr = config["training"]
    x, y = spec.wav_to_spec(x_wav)[:, None], spec.wav_to_spec(y_wav)[:, None]
    mean, std = sde.mean_std(x, y, t)
    x_t = mean + bcast(std) * z
    out = net(x_t, y, t)
    f, frames = x.shape[2:]
    tf = 0.5 * torch.sum((torch.abs(out - x) ** 2 / (f * frames)).reshape(x.shape[0], -1), -1)
    length = spec.target_len
    x_hat_td = spec.spec_to_wav(out[:, 0], length)
    x_td = spec.spec_to_wav(x[:, 0], length)
    l1 = 0.5 * torch.sum((torch.abs(x_hat_td - x_td) / length).reshape(x.shape[0], -1), -1)
    pesq_row = pesq(x_td, x_hat_td)
    per_row = tf + tr["l1_weight"] * l1
    if fault != "no_pesq":
        per_row = per_row + tr["pesq_weight"] * pesq_row
    if fault == "answer_altered":
        per_row = 1.5 * per_row
    return per_row.sum() / batch, pesq_row.detach().sum() / batch


def draws(config: dict, gen_state: torch.Tensor, batch: int, shape, device):
    """(t, z) of one step from the generator state the step started with."""
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    t_eps = config["t_eps"]
    t = torch.rand((batch,), generator=gen, device=device) * (SBVE.T - t_eps) + t_eps
    return t, crandn(shape, gen)


def ema_decay(decay: float, n: int) -> float:
    n = np.float32(n)
    d = min(np.float32(decay), (np.float32(1.0) + n) / (np.float32(10.0) + n))
    return float(np.float32(1.0) - np.float32(d))


def train_steps(config: dict, net, steps: List[dict], block: int, device,
                precision: str = "f32", keep_rows: int = 0, fault=None) -> dict:
    """Follow the program's first steps: ``steps`` holds each step's waveform
    batch (``x``, ``y``: (B, L) float32 arrays) and generator state
    (``gen``). Returns each step's loss and mean PESQ loss (the term before
    its weight), each leaf's first-gradient norm, and each leaf's change
    after the steps (parameters and EMA) as norms. ``keep_rows`` > 0 plants a
    fault: only the first ``keep_rows`` rows of each batch count, the mean
    taken over them; ``fault`` plants one of :data:`FAULTS`."""
    if fault not in (None,) + FAULTS:
        raise ValueError(f"fault {fault!r}: one of {FAULTS}")
    tr = config["training"]
    spec = Spec(**config["stft"])
    sde = SBVE(**config["sde_params"])
    pesq = PesqLoss(1.0)
    params = {n: p for n, p in net.named_parameters() if p.requires_grad}
    start = {n: p.detach().clone() for n, p in net.named_parameters()}
    ema = {n: p.detach().clone() for n, p in net.named_parameters()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, pesq_terms, first_grad = [], [], None
    f = spec.n_fft // 2 + 1
    for k, step in enumerate(steps, start=1):
        b = step["x"].shape[0]
        t, z = draws(config, step["gen"], b, (b, 1, f, spec.num_frames), device)
        grads = {n: torch.zeros_like(p) for n, p in params.items()}
        loss, pesq_term, used = 0.0, 0.0, keep_rows or b
        with net_precision(net, precision):
            for i in range(0, used, block):
                rows = slice(i, min(i + block, used))
                xw = torch.as_tensor(step["x"][rows], device=device)
                yw = torch.as_tensor(step["y"][rows], device=device)
                part, part_pesq = block_loss(config, net, spec, sde, pesq, xw, yw, t[rows],
                                             z[rows], used, fault)
                gs = torch.autograd.grad(part, list(params.values()))
                for n, g in zip(params, gs):
                    grads[n] += g
                loss += float(part.detach())
                pesq_term += float(part_pesq)
        losses.append(loss)
        pesq_terms.append(pesq_term)
        if first_grad is None:
            first_grad = {n: float(g.norm()) for n, g in grads.items()}
        with torch.no_grad():
            b1, b2 = BETAS
            for n, p in params.items():
                m[n].mul_(b1).add_(grads[n], alpha=1 - b1)
                v[n].mul_(b2).addcmul_(grads[n], grads[n], value=1 - b2)
                denom = (v[n].sqrt() / np.sqrt(1 - b2 ** k)).add_(ADAM_EPS)
                p.addcdiv_(m[n], denom, value=-tr["lr"] / (1 - b1 ** k))
            w = ema_decay(tr["ema_decay"], k)
            for n, p in net.named_parameters():
                ema[n].sub_((ema[n] - p) * w)
    with torch.no_grad():
        change = {n: float((p - start[n]).norm()) for n, p in net.named_parameters()}
        ema_change = {n: float((ema[n] - start[n]).norm()) for n in ema}
    return dict(losses=losses, pesq_terms=pesq_terms, first_grad=first_grad, change=change,
                ema_change=ema_change)
