"""The port's ScoreModel (sgmse_tpu_torch.model) and enhancement entry point
against the JAX package's, waveform to waveform.

The small test network (nf 16, ch_mult 1,1,2, one res-block, attention at 16,
F = 64 from n_fft 126) gets the JAX model's own weights through
``convert.params_from_jax``; both sides get the same numpy waveform and the
same (N+1, B, 1, F, T) prior and predictor noise through ``prior_noise``, with
corrector 'none' (JAX cannot inject corrector noise).
Tolerance: 1e-3 relative max-abs on the output waveform (float32 network and
FFTs in two frameworks, through N sampler steps).
"""
import numpy as np
import pytest
import torch

import jax

from sgmse_tpu.model import ScoreModel as JaxScoreModel
from sgmse_tpu_torch import convert, enhance
from sgmse_tpu_torch.data.wav import read_wav, write_wav
from sgmse_tpu_torch.model import ScoreModel

NET = dict(nf=16, ch_mult=(1, 1, 2), num_res_blocks=1, attn_resolutions=(16,), image_size=64,
           init_scale=1.0)
STFT = dict(n_fft=126, hop_length=32)
N, B, L = 4, 2, 2016  # 2016 samples -> 64 frames at hop 32


@pytest.fixture(scope="module")
def jax_model_and_params():
    model = JaxScoreModel("ncsnpp", "ouve", **NET, **STFT)
    x = np.zeros((1, 1, 64, 64), np.complex64)
    variables = jax.jit(model.dnn.init)(jax.random.key(4), x, x, np.full((1,), 0.5, np.float32))
    return model, jax.tree.map(np.asarray, variables)


def test_enhance_matches_jax_with_injected_noise(jax_model_and_params):
    jmodel, variables = jax_model_and_params
    rng = np.random.default_rng(0)
    y = (0.3 * rng.standard_normal((B, L))).astype(np.float32)
    shape = (N + 1, B, 1, 64, 64)
    z = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)
         ).astype(np.complex64)
    ref = np.asarray(jmodel.enhance(variables, y, corrector="none", N=N, prior_noise=z))

    model = ScoreModel("ncsnpp", "ouve", **NET, **STFT)
    model.dnn.load_state_dict(convert.params_from_jax(variables["params"], **NET))
    model = model.to(memory_format=torch.channels_last).eval()
    got, nfe, rtf = model.enhance(y, corrector="none", N=N, prior_noise=z, timeit=True)
    assert got.shape == ref.shape == (B, L) and nfe == N and rtf > 0
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= 1e-3, err


def test_constructor_routes_kwargs():
    model = ScoreModel("ncsnpp", "ouve", theta=2.0, nf=16, ch_mult=[1, 2], n_fft=126,
                       lr=1e-3, t_eps=0.05)
    assert model.sde.theta == 2.0 and model.dnn.nf == 16 and model.dnn.ch_mult == (1, 2)
    assert model.spec.n_fft == 126 and model.t_eps == 0.05
    with pytest.raises(NotImplementedError):  # mask bounding: unported, as in JAX
        ScoreModel("dcunet", "ouve", dcunet_mask_bound="tanh")


def test_enhance_entry_point_end_to_end(tmp_path):
    """python -m sgmse_tpu_torch.enhance on the CPU: weights from an .npz, two
    length buckets, batch 2, PC with the ald corrector."""
    config = dict(nf=16, ch_mult=(1, 1, 2), num_res_blocks=1, attn_resolutions=(16,))
    model = ScoreModel("ncsnpp", "ouve", **config)
    model.init_params(torch.Generator().manual_seed(0))
    convert.save_npz(tmp_path / "w.npz", convert.jax_tree_from_state_dict(model.dnn.state_dict()))
    rng = np.random.default_rng(1)
    lengths = {"a.wav": 8000, "b.wav": 8000, "sub/c.wav": 12000}
    for name, n in lengths.items():
        (tmp_path / "noisy" / name).parent.mkdir(parents=True, exist_ok=True)
        write_wav(tmp_path / "noisy" / name, 0.2 * rng.standard_normal(n), 16000)
    stats = enhance.main([
        "--test_dir", str(tmp_path / "noisy"), "--enhanced_dir", str(tmp_path / "out"),
        "--weights", str(tmp_path / "w.npz"), "--nf", "16", "--ch_mult", "1", "1", "2",
        "--num_res_blocks", "1", "--attn_resolutions", "16", "--N", "2", "--batch_size", "2",
        "--timeit"], device="cpu")
    assert stats["files"] == 3 and stats["all_finite"] and stats["rtf"] > 0
    assert stats["nfe"] == 2 * 4 and stats["warmup_nfe"] == 2 * 2  # two buckets, N=2, ald
    for name, n in lengths.items():
        out, sr = read_wav(tmp_path / "out" / name)
        assert sr == 16000 and out.shape == (1, n) and np.isfinite(out).all()


def test_enhance_entry_point_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    """Without ``device`` the entry point runs on the card; with none present it
    raises instead of enhancing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        enhance.main(["--test_dir", str(tmp_path), "--enhanced_dir", str(tmp_path / "out"),
                      "--weights", str(tmp_path / "w.npz")])
    assert not (tmp_path / "out").exists()
