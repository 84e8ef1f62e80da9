"""Rank functions of the data-parallel CPU tests (``tests/test_torch_ddp.py``):
``run`` is the target of ``parallel.dist.spawn``; it joins a gloo group and
runs the named jobs of this module in order, one process start for them all,
returning their numpy results to the test. Torch only: the test holds them
against JAX and against one process."""
import numpy as np
import torch

from sgmse_tpu_torch import parallel, train
from sgmse_tpu_torch.model import ScoreModel


def _join(rank, world, init_method):
    torch.set_num_threads(1)
    parallel.init_process_group(init_method, world, rank, "cpu")


def run(rank, world, init_method, jobs):
    """Join the group, then ``[globals()[name](rank, world, *args) for name, args in jobs]``."""
    _join(rank, world, init_method)
    return [globals()[name](rank, world, *args) for name, args in jobs]


def _numpy(tree):
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def first_step(rank, world, model_kw, x_wav, y_wav, seed):
    """One train step on this rank's rows of the global waveform batch: the
    rank's loss and the gradients that the update applied, averaged over the
    ranks (dropout on, the draws from ``seed``)."""
    model = ScoreModel(**model_kw)
    state = train.create_train_state(model, torch.Generator().manual_seed(0))
    b = x_wav.shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    loss, grads = train.compute_gradients(model, state, x_wav[rows], y_wav[rows],
                                          torch.Generator().manual_seed(seed))
    train.apply_gradients(state, grads, model.ema_decay)  # averages ``grads`` in place
    return float(loss), _numpy(grads)


def accumulated_update(rank, world, model_kw, x_wavs, y_wavs, seed):
    """Two micro-steps of ``--accumulate_grad_batches 2``: the gradients of
    every reduction over the ranks (one, the running mean that the update
    applies), and the parameters after it."""
    model = ScoreModel(**model_kw)
    state = train.create_train_state(model, torch.Generator().manual_seed(0),
                                     accumulate_grad_batches=2)
    generator = torch.Generator().manual_seed(seed)
    reductions = []
    average_all_ = parallel.dist.average_all_

    def recorded(tensors):
        average_all_(tensors)
        reductions.append({n: t.detach().numpy().copy() for n, t in zip(state.acc_grads, tensors)})

    b = x_wavs[0].shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    parallel.dist.average_all_ = recorded
    try:
        for x, y in zip(x_wavs, y_wavs):
            _, grads = train.compute_gradients(model, state, x[rows], y[rows], generator)
            train.apply_gradients(state, grads, model.ema_decay)
    finally:
        parallel.dist.average_all_ = average_all_
    return reductions, _numpy(state.params)


def injected_step(rank, world, model_kw, state_dict, x, y, t, z):
    """One train-mode loss of this rank's rows of the global spectrogram batch
    with the given t and z: the rank's loss, the gradients averaged over the
    ranks as the trainer averages them, and the model state (BatchNorm
    statistics) after it."""
    model = ScoreModel(**model_kw)
    model.dnn.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    model.train()
    b = x.shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    loss = model.step_loss(*(torch.from_numpy(a[rows]) for a in (x, y)), None,
                           *(torch.from_numpy(a[rows]) for a in (t, z)))
    named = {n: p for n, p in model.dnn.named_parameters() if p.requires_grad}
    grads = list(torch.autograd.grad(loss, list(named.values())))
    parallel.dist.average_all_(grads)
    return (float(loss), _numpy(dict(zip(named, grads))),
            _numpy(dict(model.dnn.named_buffers())))
