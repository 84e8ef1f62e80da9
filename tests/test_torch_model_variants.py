"""The port's ScoreModel for the Schroedinger-bridge (ncsnpp_v2 + SBVE) and
48 kHz (ncsnpp_48k) model families against the JAX package's: the
preconditioned forward, the enhance pipeline, chunked enhancement, the entry
point with ``--config`` and the config round trip.

The small networks (nf 16, ch_mult 1,1,2, one res-block, n_fft 126, hop 32)
get the port's seeded weights on both sides (``jax_tree_from_state_dict``).
Inputs are 1000-sample waveforms: 32 STFT frames, reflection-padded to 64,
so the pad is as long as the spectrogram. Tolerances, relative to max|ref|:
1e-4 for a forward (float32 convolutions in another order), 1e-3 for a
waveform (the forward, FFTs and N sampler steps in two frameworks).
"""
import json
import types

import numpy as np
import pytest
import torch

import jax

from sgmse_tpu.model import ScoreModel as JaxScoreModel
from sgmse_tpu_torch import convert, enhance
from sgmse_tpu_torch.data.wav import read_wav, write_wav
from sgmse_tpu_torch.model import ScoreModel
from sgmse_tpu_torch.utils.inference import target_sr_and_pad

NET = dict(nf=16, ch_mult=(1, 1, 2), num_res_blocks=1, image_size=64, init_scale=1.0)
STFT = dict(n_fft=126, hop_length=32)
SB = dict(NET, **STFT, attn_resolutions=(16,), loss_type="data_prediction", N=4)
K48 = dict(NET, **STFT, spec_factor=0.065, spec_abs_exponent=0.667, sigma_min=0.1,
           sigma_max=1.0, theta=2.0, sr=48000)
L = 1000


def _waves(b, seed, n=L):
    return (0.3 * np.random.default_rng(seed).standard_normal((b, n))).astype(np.float32)


def _pair(backbone, sde, config, seed=0):
    """(port model, JAX model, JAX variables) with the port's seeded weights."""
    port = ScoreModel(backbone, sde, **config)
    port.init_params(torch.Generator().manual_seed(seed))
    port = port.to(memory_format=torch.channels_last).eval()
    variables = {"params": convert.jax_tree_from_state_dict(port.dnn.state_dict())}
    return port, JaxScoreModel(backbone, sde, **config), variables


@pytest.fixture(scope="module")
def sb_pair():
    return _pair("ncsnpp_v2", "sbve", SB)


@pytest.fixture(scope="module")
def v2_apply():
    """The JAX ncsnpp_v2 network's apply, jitted once for every forward test."""
    net = JaxScoreModel("ncsnpp_v2", "ouve", **NET, attn_resolutions=(16,)).dnn
    return jax.jit(net.apply, static_argnames=("train", "mutable"))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("sde,precond", [
    ("ouve", dict(loss_type="score_matching", c_in="edm", c_out="edm", c_skip="edm")),
    ("ouve", dict(loss_type="denoiser")),
    ("sbve", dict(loss_type="data_prediction")),
])
@pytest.mark.parametrize("network_scaling", [None, "1/sigma"])
def test_v2_forward_matches_jax(v2_apply, sde, precond, network_scaling):
    config = dict(NET, **STFT, attn_resolutions=(16,), network_scaling=network_scaling,
                  **precond)
    port, jmodel, variables = _pair("ncsnpp_v2", sde, config, seed=1)
    jmodel.dnn = types.SimpleNamespace(apply=v2_apply)  # preconditioning as JAX has it
    rng = np.random.default_rng(2)
    x, y = ((rng.standard_normal((2, 1, 64, 64)) + 1j * rng.standard_normal((2, 1, 64, 64)))
            .astype(np.complex64) * 0.3 for _ in range(2))
    t = np.array([0.05, 0.8], np.float32)
    ref = jmodel.forward(variables, x, y, t)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t)).numpy()
    assert _rel(got, ref) <= 1e-4


def test_sb_ode_enhance_matches_jax(sb_pair):
    """The SB ode sampler is noise-free; N is ignored (sde.N = 4 steps run)."""
    port, jmodel, variables = sb_pair
    y = _waves(2, 3)
    _, pad = target_sr_and_pad("ncsnpp_v2")
    ref = np.asarray(jmodel.enhance(variables, y, N=30, pad_mode=pad))
    got, nfe, _ = port.enhance(y, N=30, pad_mode=pad, timeit=True)
    assert nfe == 4 and _rel(got, ref) <= 1e-3


def test_enhance_long_sb_ode_matches_jax(sb_pair):
    """Three 1000-sample chunks, crossfaded; noise-free, so exact across frameworks."""
    port, jmodel, variables = sb_pair
    y = _waves(1, 4, n=2500)[0]
    chunk_seconds = L / port.sr
    ref = np.asarray(jmodel.enhance_long(variables, y, chunk_seconds=chunk_seconds,
                                         pad_mode="reflection"))
    got, nfe, _ = port.enhance_long(y, chunk_seconds=chunk_seconds, pad_mode="reflection",
                                    timeit=True)
    assert got.shape == (2500,) and nfe == 3 * 4
    assert _rel(got, ref) <= 1e-3


def test_enhance_long_48k_pc_matches_jax():
    """PC at 48 kHz with corrector none over three chunks, crossfaded: the same
    (N+1, 1, 1, F, T) prior and step noise injected into every chunk on both
    sides (both packages pass it through to ``enhance``)."""
    port, jmodel, variables = _pair("ncsnpp_48k", "ouve", K48, seed=9)
    n, y = 3, _waves(1, 11, n=2500)[0]
    rng = np.random.default_rng(12)
    shape = (n + 1, 1, 1, 64, 64)
    z = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)
         ).astype(np.complex64)
    _, pad = target_sr_and_pad("ncsnpp_48k")
    kw = dict(chunk_seconds=L / port.sr, corrector="none", N=n, prior_noise=z, pad_mode=pad)
    ref = np.asarray(jmodel.enhance_long(variables, y, **kw))
    got, nfe, _ = port.enhance_long(y, timeit=True, **kw)
    assert got.shape == (2500,) and nfe == 3 * n
    assert _rel(got, ref) <= 1e-3


def test_48k_pc_enhance_matches_jax():
    """PC with corrector none and the (N+1, B, 1, F, T) prior and step noise
    injected on both sides."""
    port, jmodel, variables = _pair("ncsnpp_48k", "ouve", K48, seed=5)
    n, y = 3, _waves(2, 6)
    rng = np.random.default_rng(7)
    shape = (n + 1, 2, 1, 64, 64)
    z = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)
         ).astype(np.complex64)
    _, pad = target_sr_and_pad("ncsnpp_48k")
    ref = np.asarray(jmodel.enhance(variables, y, corrector="none", N=n, prior_noise=z,
                                    pad_mode=pad))
    got = port.enhance(y, corrector="none", N=n, prior_noise=z, pad_mode=pad)
    assert _rel(got, ref) <= 1e-3


@pytest.mark.parametrize("backbone,sde,config,argv,nfe,warmup_nfe", [
    # SB: pc maps to ode, N = 9 is ignored (sde.N = 4); both files pad to 64 frames: one batch.
    ("ncsnpp_v2", "sbve", SB, ["--sampler_type", "pc", "--N", "9", "--batch_size", "2"], 4, 1),
    # 48 kHz, PC + langevin, N = 2, in 480-sample chunks: 3 + 2 chunks of 4 NFE.
    ("ncsnpp_48k", "ouve", K48, ["--N", "2", "--corrector", "langevin",
                                 "--chunk_seconds", "0.01"], 5 * 4, 2),
])
def test_entry_point_with_config(tmp_path, backbone, sde, config, argv, nfe, warmup_nfe):
    """python -m sgmse_tpu_torch.enhance --config <a JAX config.json> on the CPU:
    finite wavs of the input length at the backbone's sample rate."""
    port, jmodel, _ = _pair(backbone, sde, config, seed=8)
    (tmp_path / "config.json").write_text(json.dumps(jmodel.config_dict()))
    convert.save_npz(tmp_path / "w.npz", convert.jax_tree_from_state_dict(port.dnn.state_dict()))
    sr, _ = target_sr_and_pad(backbone)
    lengths = {"a.wav": L, "b.wav": L - 100}
    (tmp_path / "noisy").mkdir()
    for i, (name, n) in enumerate(lengths.items()):
        write_wav(tmp_path / "noisy" / name, _waves(1, 10 + i, n)[0], sr)
    stats = enhance.main(["--test_dir", str(tmp_path / "noisy"),
                          "--enhanced_dir", str(tmp_path / "out"),
                          "--weights", str(tmp_path / "w.npz"),
                          "--config", str(tmp_path / "config.json"), "--timeit", *argv],
                         device="cpu")
    assert stats["all_finite"] and stats["sample_rate"] == sr and stats["backbone"] == backbone
    assert (stats["nfe"], stats["warmup_nfe"]) == (nfe, warmup_nfe)
    for name, n in lengths.items():
        out, out_sr = read_wav(tmp_path / "out" / name)
        assert out_sr == sr and out.shape == (1, n) and np.isfinite(out).all()


@pytest.mark.parametrize("backbone,sde,config", [("ncsnpp_v2", "sbve", SB),
                                                 ("ncsnpp_48k", "ouve", K48),
                                                 ("ncsnpp", "ouve", dict(NET, lr=3e-4))])
def test_config_dict_round_trip_and_matches_jax(backbone, sde, config):
    port = ScoreModel(backbone, sde, **config)
    cfg = port.config_dict()
    assert cfg == JaxScoreModel(backbone, sde, **config).config_dict()
    again = ScoreModel.from_config(json.loads(json.dumps(cfg)))
    assert again.config_dict() == cfg
    assert set(again.dnn.state_dict()) == set(port.dnn.state_dict())


def test_unported_models_raise():
    """What is still unported raises: DCUNet's mask bounding (unported in the
    JAX package too) and a backbone no package has."""
    with pytest.raises(NotImplementedError):
        ScoreModel("dcunet", "ouve", dcunet_mask_bound="tanh")
    with pytest.raises(NotImplementedError):
        ScoreModel("unet", "sbve")
