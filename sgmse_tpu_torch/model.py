"""ScoreModel: owns backbone + SDE + DSP transform; the forward contracts, the
preconditioning, the training losses and the one-call ``enhance`` pipeline.
Counterpart of ``sgmse_tpu/model.py``.

Forward contracts, as in the JAX package:

- ``ncsnpp``, ``ncsnpp_48k`` and ``dcunet``: the legacy
  ``score = -dnn(x_t, y, t)``;
- ``ncsnpp_v2``: EDM-style preconditioning, ``c_in``/``c_out``/``c_skip`` and
  an optional ``network_scaling``. The output is a score for ``score_matching``
  and ``denoiser``, and the clean state for ``data_prediction`` (what the
  Schroedinger-bridge sampler calls).

Losses, as in the JAX package: ``score_matching`` (sigma^2 weighting),
``denoiser`` (weightings 1, sigma^2, edm; the edm weighting as intended, not
the reference's broadcast bug) and ``data_prediction`` (TF-MSE plus
``l1_weight`` times the time-domain L1 through the differentiable iSTFT, plus
``pesq_weight`` times the mean differentiable PESQ loss of the estimate
against the clean waveform, ``utils/pesq_loss.py``, 16 kHz only).

Unlike the JAX package, parameters live in the module (``self.dnn``), as
PyTorch has it; ``init_params(generator)`` draws them from an explicit
generator, and ``convert.params_from_jax`` loads the JAX package's. Dropout
is on in ``train()`` mode and off in ``eval()`` mode, where the JAX package
passes ``train=``; so is DCUNet's BatchNorm, which in ``train()`` mode
normalises with the batch's statistics and advances its running statistics
(buffers of ``self.dnn``, the JAX ``batch_stats``) once per forward, as the
JAX ``step_loss_with_updates`` does, and in ``eval()`` mode (validation,
sampling) uses them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import math
import threading
import time
import weakref
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from . import sampling
from .dsp import SpecTransform, pad_length, pad_spec
from .models import BackboneRegistry
from .parallel.rows import draw
from .sdes import SDERegistry, crandn
from .utils.pesq_loss import PesqLoss
from .utils.profiling import span

_SPEC_KEYS = ("n_fft", "hop_length", "window", "transform_type", "spec_factor",
              "spec_abs_exponent", "num_frames")
PORTED = {"backbone": ("ncsnpp", "ncsnpp_v2", "ncsnpp_48k", "dcunet"), "sde": ("ouve", "sbve")}
# What ``ScoreModel.enhance_long`` has handed to its sampler in this process:
# calls, chunks, input samples, and the samples the sampler enhanced (each
# chunk's padded frames times the STFT hop: the overlap, the last chunk's
# padding past the recording and the frame padding to a multiple of 64).
LONG_SERVED = {"calls": 0, "chunks": 0, "input_samples": 0, "enhanced_samples": 0}
_long_lock = threading.Lock()
# The ``enhance_long`` calls open on this thread (``depth``): under one, the
# network's evaluations on a CUDA device are replayed from CUDA graphs.
_LONG = threading.local()
# Each model's captured evaluations, by weights, stream, shapes and dtypes:
# (graph, its input buffers, its output buffer).
_GRAPHS: "weakref.WeakKeyDictionary[nn.Module, dict]" = weakref.WeakKeyDictionary()


@contextlib.contextmanager
def _in_long():
    """One ``enhance_long`` call open on this thread, for the duration."""
    _LONG.depth = getattr(_LONG, "depth", 0) + 1
    try:
        yield
    finally:
        _LONG.depth -= 1


def _bcast(c):
    return c[:, None, None, None]


def _holding(lock, fn):
    """``fn`` called with ``lock`` held."""
    def call(*args, **kwargs):
        with lock:
            return fn(*args, **kwargs)
    return call


def _accepted(cls) -> set:
    """The keyword arguments ``cls`` declares, its base classes' included."""
    if dataclasses.is_dataclass(cls):
        return {f.name for f in dataclasses.fields(cls)}
    names = set()
    for c in cls.__mro__[:cls.__mro__.index(nn.Module)]:
        init = vars(c).get("__init__")
        if init is not None:
            names |= {p.name for p in inspect.signature(init).parameters.values()
                      if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}
    return names - {"self"}


def _filter_kwargs(cls, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only the kwargs that `cls` declares (lists become tuples)."""
    names = _accepted(cls)
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in kwargs.items() if k in names}


class ScoreModel(nn.Module):
    """Score-based speech enhancement model.

    Construction mirrors the JAX ``ScoreModel``: backbone/sde names select
    registry classes, and the remaining kwargs are routed to whichever of the
    backbone, the SDE and the STFT transform declares them.
    """

    @staticmethod
    def add_argparse_args(parser):
        parser.add_argument("--lr", type=float, default=1e-4,
                            help="The learning rate (1e-4 by default)")
        parser.add_argument("--ema_decay", type=float, default=0.999,
                            help="The parameter EMA decay constant (0.999 by default)")
        parser.add_argument("--t_eps", type=float, default=0.03,
                            help="The minimum process time (0.03 by default)")
        parser.add_argument("--num_eval_files", type=int, default=20,
                            help="Number of files for speech enhancement performance "
                                 "evaluation during training.")
        parser.add_argument("--loss_type", type=str, default="score_matching",
                            help="The type of loss function to use.")
        parser.add_argument("--loss_weighting", type=str, default="sigma^2",
                            help="The weighting of the loss function.")
        parser.add_argument("--network_scaling", type=str, default=None,
                            help="The type of network output scaling to use.")
        parser.add_argument("--c_in", type=str, default="1", help="The input scaling for x.")
        parser.add_argument("--c_out", type=str, default="1", help="The output scaling.")
        parser.add_argument("--c_skip", type=str, default="0",
                            help="The skip connection scaling.")
        parser.add_argument("--sigma_data", type=float, default=0.1,
                            help="The data standard deviation.")
        parser.add_argument("--l1_weight", type=float, default=0.001,
                            help="The balance between the time-frequency and time-domain "
                                 "losses.")
        parser.add_argument("--pesq_weight", type=float, default=0.0,
                            help="The weight of the differentiable PESQ loss term of the "
                                 "data_prediction loss (16 kHz only; 5e-4 in the "
                                 "Schroedinger-bridge recipe, 0 turns it off).")
        parser.add_argument("--sr", type=int, default=16000,
                            help="The sample rate of the audio files.")
        return parser

    def __init__(self, backbone: str = "ncsnpp", sde: str = "ouve", lr: float = 1e-4,
                 ema_decay: float = 0.999, t_eps: float = 0.03, num_eval_files: int = 20,
                 loss_type: str = "score_matching", loss_weighting: str = "sigma^2",
                 network_scaling: Optional[str] = None, c_in: str = "1", c_out: str = "1",
                 c_skip: str = "0", sigma_data: float = 0.1, l1_weight: float = 0.001,
                 pesq_weight: float = 0.0, sr: int = 16000,
                 spec: Optional[SpecTransform] = None, **kwargs):
        super().__init__()
        if backbone not in PORTED["backbone"] or sde not in PORTED["sde"]:
            raise NotImplementedError(f"backbone {backbone!r} with sde {sde!r} is not "
                                      f"ported yet (ported: {PORTED})")
        self.lr, self.ema_decay, self.num_eval_files = lr, ema_decay, num_eval_files
        self.loss_weighting, self.l1_weight, self.pesq_weight = (loss_weighting, l1_weight,
                                                                 pesq_weight)
        self.backbone = backbone
        self.spec = spec if spec is not None else SpecTransform(
            **{k: v for k, v in kwargs.items() if k in _SPEC_KEYS})
        # Attention levels follow the STFT's frequency bins, as the JAX parameter
        # tree follows the input it is initialised with; image_size stays a config
        # value (JAX never reads it).
        dnn_cls = BackboneRegistry.get_by_name(backbone)
        self.dnn = dnn_cls(**_filter_kwargs(dnn_cls, kwargs),
                           freq_bins=self.spec.n_fft // 2 + 1)
        self.sde_name = sde
        sde_cls = SDERegistry.get_by_name(sde)
        self.sde = sde_cls(**_filter_kwargs(sde_cls, kwargs))
        self.t_eps = t_eps
        self.loss_type = loss_type
        self.network_scaling = network_scaling
        self.c_in_type, self.c_out_type, self.c_skip_type = c_in, c_out, c_skip
        self.sigma_data = sigma_data
        self.sr = sr
        # Built here, as in the JAX package, so that a rate it does not take
        # raises at construction.
        self._pesq_loss = PesqLoss(1.0, sample_rate=sr) if pesq_weight > 0.0 else None

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def init_params(self, generator: torch.Generator) -> None:
        """Draw every parameter from `generator` with the DDPM init rules."""
        for module in self.dnn.modules():
            if hasattr(module, "init_parameters"):
                module.init_parameters(generator)

    # --- preconditioning scalings: 1.0 and 0.0 stand for the identity and nothing ------
    def _c_in(self, t):
        if self.c_in_type == "1":
            return 1.0
        elif self.c_in_type == "edm":
            sigma = self.sde._std(t)
            return _bcast(1.0 / torch.sqrt(sigma**2 + self.sigma_data**2))
        raise ValueError(f"Invalid c_in type: {self.c_in_type}")

    def _c_out(self, t):
        if self.c_out_type == "1":
            return 1.0
        elif self.c_out_type == "sigma":
            return _bcast(self.sde._std(t))
        elif self.c_out_type == "1/sigma":
            return _bcast(1.0 / self.sde._std(t))
        elif self.c_out_type == "edm":
            sigma = self.sde._std(t)
            return _bcast(sigma * self.sigma_data / torch.sqrt(self.sigma_data**2 + sigma**2))
        raise ValueError(f"Invalid c_out type: {self.c_out_type}")

    def _c_skip(self, t):
        if self.c_skip_type == "0":
            return 0.0
        elif self.c_skip_type == "edm":
            sigma = self.sde._std(t)
            return _bcast(self.sigma_data**2 / (sigma**2 + self.sigma_data**2))
        raise ValueError(f"Invalid c_skip type: {self.c_skip_type}")

    # --- forward contracts ---------------------------------------------------------------
    def forward(self, x_t, y, t, generator: Optional[torch.Generator] = None):
        """The score (or, for ``ncsnpp_v2`` with ``data_prediction``, the clean
        state) at (x_t, y, t). ``generator`` draws dropout masks in ``train()``
        mode. One evaluation is one ``net`` span (``utils.profiling.span``)."""
        with span("net"):
            if self.backbone != "ncsnpp_v2":
                return -self.dnn(x_t, y, t, generator)
            c_in = self._c_in(t)
            if not isinstance(c_in, float):  # 1.0: the identity, skipped
                x_t_in, y_in = c_in * x_t, c_in * y
            else:
                x_t_in, y_in = x_t, y
            out = self.dnn(x_t_in, y_in, t, generator)
            if self.network_scaling == "1/sigma":
                out = out / _bcast(self.sde._std(t))
            elif self.network_scaling == "1/t":
                out = out / _bcast(t)
            if self.loss_type in ("score_matching", "data_prediction"):
                c_out, c_skip = self._c_out(t), self._c_skip(t)
                if not isinstance(c_out, float):
                    out = c_out * out
                return out if isinstance(c_skip, float) else c_skip * x_t + out
            elif self.loss_type == "denoiser":
                return (out - x_t) / _bcast(self.sde._std(t)) ** 2
            raise ValueError(f"Invalid loss type: {self.loss_type}")

    def score_fn(self):
        """score_fn(x, y, t) for the samplers: :meth:`forward`, or inside
        ``enhance_long``, in ``eval()`` mode on a CUDA device, its replay from a
        CUDA graph (:meth:`_graphed`)."""
        if getattr(_LONG, "depth", 0) and not self.training and self.device.type == "cuda":
            return self._graphed()
        return self.forward

    def _graphed(self):
        """:meth:`forward` replayed from a CUDA graph, captured at the first
        evaluation of each input shape on each stream (serving threads each
        have their own). A graph reads the parameters where they are stored:
        weights loaded in place are seen; parameters moved to new storage get
        new graphs, and the old ones are dropped. One replay, with the copies
        of its inputs and output, is one ``net`` span.

        A long recording's chunks all have one shape, and at one row an
        evaluation of the 48 kHz network (~1,040 launches) takes the host
        longer than the card's work: a replay is one launch, so the card sets
        the pace."""
        weights = tuple(p.data_ptr() for p in self.parameters())
        graphs = _GRAPHS.setdefault(self, {})

        def evaluate(x_t, y, t):
            args = (x_t, y, t)
            stream = torch.cuda.current_stream(x_t.device).cuda_stream
            key = (weights, stream, *((a.shape, a.dtype) for a in args))
            entry = graphs.get(key)
            if entry is None:
                for old in [k for k in graphs if k[0] != weights]:
                    del graphs[old]
                entry = graphs[key] = self._capture(args)
            graph, inputs, out = entry
            with span("net"):
                for buf, a in zip(inputs, args):
                    buf.copy_(a)
                graph.replay()
                return out.clone()

        return evaluate

    def _capture(self, args):
        """(graph, input buffers, output buffer) of one :meth:`forward` at
        ``args``' shapes. One evaluation runs first, outside the graph, so that
        kernel builds, cuDNN's plans and the allocator's growth stay out of
        it; the capture has a stream of its own and leaves other threads'
        launches alone."""
        inputs = [a.clone() for a in args]
        self.forward(*inputs)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(inputs[0].device),
                              capture_error_mode="thread_local"):
            out = self.forward(*inputs)
        return graph, inputs, out

    # --- losses ------------------------------------------------------------------------
    def _loss(self, forward_out, x_t, z, t, mean, x):
        sigma = _bcast(self.sde._std(t))

        def _sum_mean(losses):
            return torch.mean(0.5 * torch.sum(losses.reshape(losses.shape[0], -1), dim=-1))

        if self.loss_type == "score_matching":
            if self.loss_weighting != "sigma^2":
                raise ValueError("Invalid loss weighting for loss_type=score_matching: "
                                 f"{self.loss_weighting}")
            return _sum_mean(torch.abs(forward_out * sigma + z) ** 2)  # Eq. (7)
        elif self.loss_type == "denoiser":
            d = forward_out * sigma**2 + x_t  # Eq. (10)
            losses = torch.abs(d - mean) ** 2  # Eq. (8)
            if self.loss_weighting == "1":
                pass
            elif self.loss_weighting == "sigma^2":
                losses = losses * sigma**2
            elif self.loss_weighting == "edm":
                losses = (sigma**2 + self.sigma_data**2) / ((sigma * self.sigma_data) ** 2) * losses
            else:
                raise ValueError("Invalid loss weighting for loss_type=denoiser: "
                                 f"{self.loss_weighting}")
            return _sum_mean(losses)
        elif self.loss_type == "data_prediction":
            f, tt = x.shape[2:]
            loss_tf = _sum_mean((1.0 / (f * tt)) * torch.abs(forward_out - x) ** 2)
            target_len = self.spec.target_len
            x_hat_td = self.to_audio(forward_out[:, 0], target_len)
            x_td = self.to_audio(x[:, 0], target_len)
            loss_l1 = _sum_mean((1.0 / target_len) * torch.abs(x_hat_td - x_td))
            if self._pesq_loss is not None:  # the clean reference, the estimate degraded
                loss_pesq = torch.mean(self._pesq_loss(x_td, x_hat_td))
                return loss_tf + self.l1_weight * loss_l1 + self.pesq_weight * loss_pesq
            return loss_tf + self.l1_weight * loss_l1
        raise ValueError(f"Invalid loss type: {self.loss_type}")

    def draw_t(self, batch: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
        """The diffusion times t ~ U(t_eps, T) of a batch (under
        ``parallel.global_rows``, this process's rows of the global draw)."""
        return (draw(torch.rand, (batch,), generator=generator, device=device)
                * (self.sde.T - self.t_eps) + self.t_eps)

    def step_loss(self, x, y, generator: Optional[torch.Generator] = None,
                  t: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None):
        """One training or validation loss on the spectrogram batch (x, y),
        each complex (B, 1, F, T): t ~ U(t_eps, T) and z complex normal from
        ``generator`` (or the given ``t`` and ``z``), x_t = mean + std * z.
        Dropout follows the module's mode."""
        if t is None:
            t = self.draw_t(x.shape[0], generator, x.device)
        mean, std = self.sde.marginal_prob(x, y, t)
        if z is None:
            z = crandn(x.shape, generator, x.device)
        x_t = mean + _bcast(std) * z
        return self._loss(self(x_t, y, t, generator=generator), x_t, z, t, mean, x)

    def to_audio(self, spec, length: Optional[int] = None):
        return self.spec.spec_to_wav(spec, length=length)

    # --- one-call enhancement ----------------------------------------------------------
    @torch.inference_mode()
    def enhance(self, y_wav, generator: Optional[torch.Generator] = None,
                sampler_type: Optional[str] = None, predictor: str = "reverse_diffusion",
                corrector: str = "ald", N: int = 30, corrector_steps: int = 1,
                snr: float = 0.5, timeit: bool = False, pad_mode: str = "zero_pad",
                method: str = "rk45", max_steps: int = 1000, prior_noise=None,
                corrector_noise=None, intermediate: bool = False, sde=None,
                evaluation_lock=None):
        """Enhance noisy waveform(s) ``(L,)`` or ``(B, L)`` end to end.

        Max-abs normalize -> STFT + compression transform -> pad T to a
        multiple of 64 -> sampler -> inverse transform + iSTFT -> un-normalize.
        Returns a numpy waveform of the input's shape, or ``(x_hat, nfe, rtf)``
        with ``timeit``. With ``intermediate`` on the PC path it also returns
        the trajectory, the complex numpy ``(N, B, 1, F, T)`` state after each
        predictor step: ``(x_hat, trajectory)``, or ``(x_hat, trajectory, nfe,
        rtf)`` with ``timeit``; the other samplers ignore the flag, as in the
        JAX package.

        The sampler, as in the JAX package: ``sampler_type`` (default: the
        SDE's) ``pc`` (predictor, corrector, N, snr) or ``ode`` (``method``
        rk45 with ``max_steps``, or rk4 over N steps) on the OUVE SDE; on the
        SBVE SDE the Schroedinger-bridge sampler, ``ode`` (``pc`` maps to it)
        or ``sde``, which ignores ``N`` and always runs ``sde.N`` steps.

        ``generator`` draws the sampler noise (default: seed 0 on the model's
        device, so repeated calls agree). ``prior_noise`` and
        ``corrector_noise`` inject it instead (see :mod:`.sampling`).
        ``sde`` samples with another SDE than the model's (a warm-up passes a
        shortened copy, so that the model is never changed under a caller on
        another thread). ``evaluation_lock`` (a ``threading.Lock``, or any
        context manager) is entered for each network evaluation: threads
        that share the model then take turns at launching whole evaluations,
        instead of handing the GIL to each other between the ~1,200 launches
        of one (the serving path's executors do this).
        """
        device = self.device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        sde = self.sde if sde is None else sde
        stype = sampler_type if sampler_type is not None else sde.sampler_type
        start = time.time() if timeit else None

        def as_device(a):
            return None if a is None else torch.as_tensor(a, device=device)

        with span("enhance.prep"):
            y = torch.as_tensor(np.asarray(y_wav, dtype=np.float32), device=device)
            squeeze = y.ndim == 1
            if squeeze:
                y = y[None]
            t_orig = y.shape[-1]
            # Floor like the training normalization: silence must not divide by zero.
            norm = y.abs().amax(dim=-1, keepdim=True).clamp_min(1e-10)
            Y = pad_spec(self.spec.wav_to_spec(y / norm)[:, None], mode=pad_mode)
            noise, corrector_noise = as_device(prior_noise), as_device(corrector_noise)
        score_fn = self.score_fn()
        if evaluation_lock is not None:
            score_fn = _holding(evaluation_lock, score_fn)
        trajectory = None
        with span("sampler"):
            if self.sde_name == "ouve":
                sde = dataclasses.replace(sde, N=N)
                if stype == "pc":
                    sample, nfe = sampling.pc_sampler(
                        predictor, corrector, sde, score_fn, Y, generator=generator,
                        denoise=True, eps=self.t_eps, snr=snr, corrector_steps=corrector_steps,
                        noise=noise, corrector_noise=corrector_noise, intermediate=intermediate)
                    if intermediate:
                        sample, trajectory = sample
                        trajectory = trajectory.cpu().numpy()
                elif stype == "ode":
                    sample, nfe = sampling.ode_sampler(
                        sde, score_fn, Y, generator=generator, eps=self.t_eps, N=N,
                        method=method, max_steps=max_steps, noise=noise)
                else:
                    raise ValueError(f"Invalid sampler type for SGMSE sampling: {stype}")
            else:  # sbve: pc maps to ode, and N is not passed (the JAX enhance passes none)
                sample, nfe = sampling.sb_sampler(
                    sde, score_fn, Y, generator=generator,
                    sampler_type="ode" if stype == "pc" else stype, noise=noise)
        with span("enhance.post"):
            x_hat = (self.to_audio(sample[:, 0], t_orig) * norm).cpu().numpy()  # host fence
        if squeeze:
            x_hat = x_hat[0]
        out = (x_hat,) if trajectory is None else (x_hat, trajectory)
        if timeit:
            return (*out, nfe, (time.time() - start) / (x_hat.shape[-1] / self.sr))
        return out if trajectory is not None else x_hat

    def enhance_long(self, y_wav, chunk_seconds: float = 20.0, overlap: float = 0.1,
                     generator: Optional[torch.Generator] = None, timeit: bool = False,
                     enhance=None, **kwargs):
        """Enhance one long utterance ``(L,)`` in chunks of ``chunk_seconds``
        (at ``self.sr``) overlapping by ``overlap``, and overlap-add them with a
        linear crossfade (none at the start of the first chunk and at the end
        of the last). Every chunk has the same length, so one padded shape.
        The chunks draw their noise from ``generator`` in order. ``kwargs`` go
        to :meth:`enhance`, or to ``enhance`` where one is given (the
        data-parallel pool's, ``parallel.pool``). Returns the waveform, or
        ``(x_hat, nfe, rtf)`` with ``timeit``. The call is one ``enhance.long``
        span, each chunk's crossfade and overlap-add one ``enhance.long.merge``
        span, and its work is counted in ``LONG_SERVED``. On a CUDA device the
        chunks' network evaluations are replayed from CUDA graphs
        (:meth:`score_fn`)."""
        enhance = self.enhance if enhance is None else enhance
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        y_wav = np.asarray(y_wav, dtype=np.float32)
        if y_wav.ndim != 1:
            raise ValueError("enhance_long takes one utterance (L,)")
        start = time.time() if timeit else None
        with _in_long(), span("enhance.long"):
            chunk = int(chunk_seconds * self.sr)
            hop = int(chunk * (1.0 - overlap))
            length = y_wav.shape[-1]
            n_chunks = 1 if length <= chunk else 1 + math.ceil((length - chunk) / hop)
            self._count_long(length, min(length, chunk), n_chunks)
            if n_chunks == 1:
                out, nfe, _ = enhance(y_wav, generator=generator, timeit=True, **kwargs)
            else:
                total = (n_chunks - 1) * hop + chunk
                y_pad = np.pad(y_wav, (0, total - length))
                out = np.zeros(total, dtype=np.float32)
                weight = np.zeros(total, dtype=np.float32)
                ramp = chunk - hop  # crossfade length
                win = np.ones(chunk, dtype=np.float32)
                if ramp > 0:
                    win[:ramp] = np.linspace(0.0, 1.0, ramp, endpoint=False)
                    win[-ramp:] = np.linspace(1.0, 0.0, ramp, endpoint=False)
                nfe = 0
                for i in range(n_chunks):
                    seg = y_pad[i * hop: i * hop + chunk]
                    x_hat, n, _ = enhance(seg, generator=generator, timeit=True, **kwargs)
                    nfe += n
                    with span("enhance.long.merge"):
                        w = win.copy()
                        if i == 0 and ramp > 0:
                            w[:ramp] = 1.0  # no fade-in on the first chunk
                        if i == n_chunks - 1 and ramp > 0:
                            w[-ramp:] = 1.0  # no fade-out on the last chunk
                        out[i * hop: i * hop + chunk] += x_hat * w
                        weight[i * hop: i * hop + chunk] += w
                out = (out / np.maximum(weight, 1e-8))[:length]
        if timeit:
            return out, nfe, (time.time() - start) / (length / self.sr)
        return out

    def _count_long(self, length: int, chunk: int, n_chunks: int) -> None:
        """Add one ``enhance_long`` call of ``n_chunks`` chunks of ``chunk``
        samples over ``length`` input samples to ``LONG_SERVED``."""
        padded = pad_length(self.spec.frames(chunk))  # as enhance's prep pads them
        with _long_lock:
            LONG_SERVED["calls"] += 1
            LONG_SERVED["chunks"] += n_chunks
            LONG_SERVED["input_samples"] += length
            LONG_SERVED["enhanced_samples"] += n_chunks * padded * self.spec.hop_length

    # --- config round trip (the config.json of a JAX checkpoint) -------------------------
    def config_dict(self) -> dict:
        """The JAX ``ScoreModel.config_dict()`` of this model."""
        cfg = dict(backbone=self.backbone, sde=self.sde_name, lr=self.lr,
                   ema_decay=self.ema_decay, t_eps=self.t_eps,
                   num_eval_files=self.num_eval_files, loss_type=self.loss_type,
                   loss_weighting=self.loss_weighting, network_scaling=self.network_scaling,
                   c_in=self.c_in_type, c_out=self.c_out_type, c_skip=self.c_skip_type,
                   sigma_data=self.sigma_data, l1_weight=self.l1_weight,
                   pesq_weight=self.pesq_weight, sr=self.sr)
        cfg.update(self.spec.config_dict())
        cfg.update(self.sde.config_dict())
        cfg.update({k: list(v) if isinstance(v, tuple) else v
                    for k, v in self.dnn.config.items()})
        return cfg

    @classmethod
    def from_config(cls, cfg: dict) -> "ScoreModel":
        """Build from a :meth:`config_dict` (or a JAX checkpoint's config.json)."""
        cfg = dict(cfg)
        return cls(cfg.pop("backbone"), cfg.pop("sde"), **cfg)
