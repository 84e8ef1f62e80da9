"""The port's training path on the CPU at a small size: optimizer and EMA,
data loading, checkpoints and their policies, the Trainer, the entry points
and the evaluation metrics, each against the JAX package where it has a
counterpart.

Tolerances: Adam + EMA given the same numpy gradients 1e-6 of max|param| per
leaf, plus 1e-5 of the largest total update (lr x steps): optax takes Adam's
bias corrections 1 - beta^t in float32 (1 - 0.999 is 1.3e-5 off), torch in
float64, which moves an update by up to ~6.5e-6 of itself; data batches and
metrics bit for bit (the same numpy code and seeds); a checkpoint's exported
weights through the JAX network 1e-4 relative to max|out|.
"""
import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from sgmse_tpu.data.dataset import Specs as JaxSpecs, WavLoader as JaxWavLoader
from sgmse_tpu.model import ScoreModel as JaxScoreModel
from sgmse_tpu.train import ema_update as jax_ema_update
from sgmse_tpu.utils import metrics as jmetrics
from sgmse_tpu_torch import checkpoint, convert, enhance, train
from sgmse_tpu_torch.data.dataset import Specs, SpecsDataModule, WavLoader
from sgmse_tpu_torch.data.wav import write_wav
from sgmse_tpu_torch.model import ScoreModel
from sgmse_tpu_torch.models import blocks
from sgmse_tpu_torch.utils import metrics
from sgmse_tpu_torch.utils.loggers import CSVLogger

NET = dict(nf=16, ch_mult=(1, 1, 2), num_res_blocks=1, attn_resolutions=(16,), image_size=64)
STFT = dict(n_fft=126, hop_length=32, num_frames=64)
CLI = ["--nf", "16", "--ch_mult", "1", "1", "2", "--num_res_blocks", "1", "--attn_resolutions",
       "16", "--n_fft", "126", "--hop_length", "32", "--num_frames", "64", "--batch_size", "2",
       "--num_workers", "1", "--N", "2", "--nolog"]
SR = 16000


@pytest.fixture(autouse=True)
def one_thread():
    """The small networks here run fastest, and share a loaded machine best, on
    one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def wav_dataset(tmp_path_factory):
    """8 train and 2 valid clean/noisy pairs of 0.25 s in the reference layout."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for subset, n in (("train", 8), ("valid", 2)):
        for kind in ("clean", "noisy"):
            (root / subset / kind).mkdir(parents=True)
        for i in range(n):
            t = np.arange(4000) / SR
            clean = 0.5 * np.sin(2 * np.pi * (200 + 50 * i) * t).astype(np.float32)
            noisy = clean + 0.1 * rng.standard_normal(4000).astype(np.float32)
            write_wav(root / subset / "clean" / f"utt{i}.wav", clean, SR)
            write_wav(root / subset / "noisy" / f"utt{i}.wav", noisy, SR)
    return root


def _small_model(**kw):
    return ScoreModel("ncsnpp", "ouve", **NET, **STFT, **kw)


@pytest.mark.parametrize("k", [1, 2])
def test_adam_and_ema_match_optax(k):
    """The same numpy gradients for 3 steps into the port's Adam + EMA and into
    optax.adam (under optax.MultiSteps for k > 1) + the JAX ema_update."""
    model = ScoreModel("ncsnpp", "ouve", nf=8, ch_mult=(1, 2), num_res_blocks=1,
                       attn_resolutions=(), lr=1e-3, ema_decay=0.9)
    state = train.create_train_state(model, torch.Generator().manual_seed(0), k)
    init = {n: p.detach().numpy().copy() for n, p in state.params.items()}
    trainable = [n for n, p in state.params.items() if p.requires_grad]
    assert [n for n in init if n not in trainable] == ["fourier.W"]
    tx = optax.adam(1e-3)
    if k > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=k)
    jparams = {n: jnp.asarray(v) for n, v in init.items()}
    jema = dict(jparams)
    opt_state = tx.init(jparams)

    @jax.jit
    def jax_step(grads, opt_state, params, ema, n):
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, jax_ema_update(ema, params, 0.9, n)

    rng = np.random.default_rng(k)
    for step in range(1, 4):
        grads = {n: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(-4, 1)).astype(np.float32)
                 for n, v in init.items()}
        grads["fourier.W"][:] = 0.0  # stop-gradient'd in JAX, frozen in the port
        train.apply_gradients(state, {n: torch.from_numpy(grads[n]) for n in trainable}, 0.9)
        jparams, opt_state, jema = jax_step({n: jnp.asarray(g) for n, g in grads.items()},
                                            opt_state, jparams, jema,
                                            jnp.asarray(step, jnp.int32))
        assert state.step == state.num_updates == step
        for name in init:
            for got, ref in ((state.params[name].detach(), jparams[name]),
                             (state.ema_params[name], jema[name])):
                ref = np.asarray(ref)
                tol = 1e-6 * np.abs(ref).max() + 1e-5 * 1e-3 * step
                assert np.abs(got.numpy() - ref).max() <= tol, name
        moved = any(not np.array_equal(state.params[n].detach().numpy(), init[n])
                    for n in trainable)
        assert moved == (step >= k)  # MultiSteps: parameters move on the k-th step only
    np.testing.assert_array_equal(state.params["fourier.W"].detach().numpy(), init["fourier.W"])


@pytest.mark.parametrize("shuffle", [True, False])
def test_wav_loader_batches_equal_jax(wav_dataset, shuffle):
    """Each of the two paths against the JAX package's same path: the Python
    path (``use_native=False``) and the native loader (the default of both)."""
    subset = "train" if shuffle else "valid"
    kw = dict(dummy=False, shuffle_spec=shuffle, num_frames=64, hop_length=32)
    for use_native in (False, True):
        ours = WavLoader(Specs(str(wav_dataset), subset, **kw), batch_size=3, shuffle=shuffle,
                         seed=4, num_workers=2, use_native=use_native)
        ref = JaxWavLoader(JaxSpecs(str(wav_dataset), subset, **kw), batch_size=3,
                           shuffle=shuffle, seed=4, num_workers=2, use_native=use_native)
        for _ in range(2):  # two epochs: the seed moves with the epoch
            got, want = list(ours), list(ref)
            assert len(got) == len(want) == len(ours) > 0
            for (gx, gy), (wx, wy) in zip(got, want):
                assert gx.shape == (3, 63 * 32)
                np.testing.assert_array_equal(gx, wx)
                np.testing.assert_array_equal(gy, wy)


def test_checkpoint_policies_cross_intervals_with_jumps(tmp_path):
    pol = checkpoint.CheckpointPolicies(tmp_path, save_ckpt_interval=5)
    tree = {"step": 0, "params": {"w": torch.ones(2)}, "ema_params": {"w": torch.ones(2)},
            "num_updates": 0}
    pol.start_from(3)
    for step in (4, 7, 9, 13, 14, 21):  # crosses 5, 10 (inside a jump), 15 and 20 (one jump)
        pol.on_train_step(step, dict(tree, step=step), {"a": 1})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_10", "step_20", "step_5"]
    state, cfg = checkpoint.load_checkpoint(tmp_path / "step_20")
    assert state["step"] == 21 and cfg == {"a": 1}
    pol.on_validation(21, tree, {}, {"pesq": 1.5, "si_sdr": float("nan")})
    pol.on_validation(22, tree, {}, {"pesq": 1.2, "si_sdr": 3.0})
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["best_pesq", "best_si_sdr", "last", "step_10", "step_20", "step_5"]
    assert pol.best == {"pesq": 1.5, "si_sdr": 3.0}


def _fit(wav_dataset, log_dir, max_steps, seed=0, ckpt=None, num_eval_files=0, **kw):
    model = _small_model(num_eval_files=num_eval_files, N=2)
    dm = SpecsDataModule(base_dir=str(wav_dataset), batch_size=2, num_workers=1, seed=seed,
                         **STFT)
    logger = CSVLogger(log_dir)
    trainer = train.Trainer(model, dm, logger, log_dir=str(log_dir), max_steps=max_steps,
                            log_every_n_steps=1, seed=seed, device="cpu", **kw)
    return trainer, trainer.fit(ckpt_path=ckpt), logger


def test_trainer_fits_validates_checkpoints_and_resumes(wav_dataset, tmp_path):
    trainer, state, logger = _fit(wav_dataset, tmp_path / "logs", 2, num_eval_files=1)
    assert state.step == state.num_updates == 2 and len(trainer.history) == 2
    run_dir = tmp_path / "logs" / logger.version
    assert sorted(p.name for p in run_dir.iterdir()) == ["best_pesq", "best_si_sdr", "last"]
    assert set(trainer.metrics) == {"valid_loss", "pesq", "si_sdr", "estoi"}
    rows = [json.loads(line) for line in (logger.log_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "train_loss" in r] == [1, 2]
    assert any("valid_loss" in r and np.isfinite(r["valid_loss"]) for r in rows)

    trainer2, state2, _ = _fit(wav_dataset, tmp_path / "logs", 3, ckpt=str(run_dir / "last"))
    assert state2.step == state2.num_updates == 3 and [s for s, _ in trainer2.history] == [3]
    saved, _ = checkpoint.load_checkpoint(run_dir / "last")
    for name, p in state2.params.items():  # resumed from the saved weights, then one step
        assert p.shape == saved["params"][name].shape

    model = checkpoint.load_score_model(run_dir / "last")
    assert model.config_dict() == trainer.model.config_dict()
    for name, value in model.dnn.state_dict().items():
        torch.testing.assert_close(value, saved["ema_params"][name], rtol=0, atol=0)


def test_two_runs_with_one_seed_train_alike(wav_dataset, tmp_path):
    """With gradient accumulation over 2 steps, so that the second run also
    repeats the accumulated mean and the EMA between optimizer steps."""
    runs = [_fit(wav_dataset, tmp_path / f"run{i}", 3, seed=7, accumulate_grad_batches=2)
            for i in range(2)]
    (ta, a, _), (tb, b, _) = runs
    for name in a.params:
        torch.testing.assert_close(a.params[name], b.params[name], rtol=0, atol=0)
        torch.testing.assert_close(a.ema_params[name], b.ema_params[name], rtol=0, atol=0)
    assert ta.history == tb.history and len(ta.history) == 3


def test_checkpoint_exports_to_the_jax_network(wav_dataset, tmp_path):
    """A port checkpoint's EMA weights through ``convert.save_npz`` load into the
    JAX network, which then computes what the port computes."""
    _, state, logger = _fit(wav_dataset, tmp_path / "logs", 1)
    saved, config = checkpoint.load_checkpoint(tmp_path / "logs" / logger.version / "last")
    convert.save_npz(tmp_path / "ema.npz", convert.jax_tree_from_state_dict(saved["ema_params"]))
    tree = convert.load_npz(tmp_path / "ema.npz")
    back = convert.state_dict_from_jax(tree)
    for name, value in saved["ema_params"].items():
        torch.testing.assert_close(back[name], value, rtol=0, atol=0)
    jmodel = JaxScoreModel.from_config(config)
    rng = np.random.default_rng(1)
    x, y = ((rng.standard_normal((1, 1, 64, 64)) + 1j * rng.standard_normal((1, 1, 64, 64)))
            .astype(np.complex64) for _ in range(2))
    t = np.array([0.4], np.float32)
    want = np.asarray(jmodel.forward({"params": tree}, x, y, t))
    model = checkpoint.load_score_model(tmp_path / "logs" / logger.version / "last").eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_entry_points_train_then_enhance_from_the_checkpoint(wav_dataset, tmp_path):
    """``--steps_per_execution`` is accepted and every step is an ordinary one:
    the run stops at ``--max_steps`` 1 inside a block of 2."""
    stats = train.main(["--base_dir", str(wav_dataset), "--log_dir", str(tmp_path / "logs"),
                        "--max_steps", "1", "--num_eval_files", "0", "--steps_per_execution",
                        "2", *CLI], device="cpu")
    assert stats["step"] == 1 and stats["device"] == "cpu" and "valid_loss" in stats["metrics"]
    ckpt = f"{stats['ckpt_dir']}/last"
    out = enhance.main(["--test_dir", str(wav_dataset / "valid" / "noisy"), "--enhanced_dir",
                        str(tmp_path / "out"), "--ckpt", ckpt, "--N", "2"], device="cpu")
    assert out["files"] == 2 and out["all_finite"] and out["nfe"] == 2 * 4


def test_bridge_recipe_trains_through_the_entry_point(wav_dataset, tmp_path):
    """The Schroedinger-bridge recipe's flags (data prediction with the PESQ
    term) at the small width: two steps, every batch from the native loader,
    finite losses, and a checkpoint whose config keeps the PESQ weight."""
    from sgmse_tpu_torch.data import native

    served = dict(native.SERVED)
    stats = train.main(["--base_dir", str(wav_dataset), "--log_dir", str(tmp_path / "logs"),
                        "--backbone", "ncsnpp_v2", "--sde", "sbve", "--loss_type",
                        "data_prediction", "--pesq_weight", "5e-4", "--max_steps", "2",
                        "--num_eval_files", "0", *CLI], device="cpu")
    losses = [v for _, v in stats["history"]]
    assert stats["step"] == 2 and len(losses) == 2 and np.isfinite(losses).all()
    assert native.SERVED["native"] - served["native"] == 2 + 1  # two steps, one validation
    assert native.SERVED["python"] == served["python"]
    _, config = checkpoint.load_checkpoint(f"{stats['ckpt_dir']}/last")
    assert (config["backbone"], config["sde"], config["pesq_weight"]) == ("ncsnpp_v2", "sbve",
                                                                          5e-4)


def test_train_entry_point_needs_a_card_and_one_device(wav_dataset, tmp_path, monkeypatch):
    """Without a card the entry point raises before it writes anything; with
    ``device="cpu"`` ``--devices 2`` trains two gloo ranks (``--devices`` was
    one device only before data parallelism; ``tests/test_torch_ddp.py``
    holds the ranks to one process)."""
    argv = ["--base_dir", str(wav_dataset), "--log_dir", str(tmp_path / "logs"), *CLI]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        train.main(argv + ["--devices", "2"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        train.main(argv)
    assert not (tmp_path / "logs").exists()
    stats = train.main(argv + ["--devices", "2", "--max_steps", "1", "--num_eval_files", "0"],
                       device="cpu", timeout=180)
    assert [(r["rank"], r["world"], r["step"]) for r in stats["ranks"]] == [(0, 2, 1), (1, 2, 1)]
    assert stats["ranks"][0]["state_sha256"] == stats["ranks"][1]["state_sha256"]


def test_enhance_eval_on_sbve_ignores_n():
    """The in-training evaluation (JAX ``enhance_eval``) enhances through
    ``ScoreModel.enhance``, which on SBVE runs the SDE's own ``sde.N`` steps
    whatever ``N`` it is given, and on OUVE follows ``N``."""
    model = ScoreModel("ncsnpp_v2", "sbve", loss_type="data_prediction", N=3, **NET, **STFT)
    model.init_params(torch.Generator().manual_seed(0))
    model.eval()
    y = (0.1 * np.random.default_rng(0).standard_normal((1, 2016))).astype(np.float32)
    runs = [model.enhance(y, generator=torch.Generator().manual_seed(1), N=n)
            for n in (5, 9)]
    np.testing.assert_array_equal(runs[0], runs[1])
    ouve = _small_model()
    ouve.init_params(torch.Generator().manual_seed(0))
    ouve.eval()
    a, b = (ouve.enhance(y, generator=torch.Generator().manual_seed(1), N=n) for n in (2, 3))
    assert not np.array_equal(a, b)


def test_dropout_applies_in_train_mode_and_remat_replays_it():
    """Dropout draws from the generator in train() mode only; under remat the
    res-blocks are recomputed in the backward with the same masks, so the loss
    and every gradient equal those without remat, and the generator ends where
    it would have."""
    x = torch.full((2, 1, 64, 64), 0.1 + 0.2j, dtype=torch.complex64)
    t, z = torch.tensor([0.3, 0.6]), torch.full((2, 1, 64, 64), 0.5 - 0.1j)
    results = []
    for remat in (False, True):
        model = _small_model(dropout=0.5, remat=remat, init_scale=1.0)
        model.init_params(torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(3)
        loss = model.train().step_loss(x, x, gen, t=t, z=z)
        grads = torch.autograd.grad(loss, [p for p in model.parameters() if p.requires_grad])
        results.append((loss, grads, torch.rand(1, generator=gen)))
        with torch.no_grad():
            model.eval()
            assert torch.equal(model.step_loss(x, x, t=t, z=z), model.step_loss(x, x, t=t, z=z))
    (l0, g0, r0), (l1, g1, r1) = results
    assert torch.equal(l0, l1) and torch.equal(r0, r1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    block = _small_model(dropout=0.5).dnn.down_0_block0
    h = torch.ones(2, 16, 8, 8)
    kept = blocks._dropout(h, block.dropout, block.training, torch.Generator().manual_seed(0))
    assert set(kept.unique().tolist()) == {0.0, 2.0}
    assert 0.3 < (kept == 0).float().mean() < 0.7
    assert torch.equal(blocks._dropout(h, block.dropout, block.eval().training, None), h)


def test_metrics_equal_the_jax_package():
    rng = np.random.default_rng(2)
    t = np.arange(16000) / SR
    x = (0.5 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 3 * t))).astype(np.float32)
    y = (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)
    assert metrics.si_sdr(x, y) == jmetrics.si_sdr(x, y)
    for ext in (False, True):
        assert metrics.stoi(x, y, SR, extended=ext) == jmetrics.stoi(x, y, SR, extended=ext)
    ours = metrics.pesq_wb(SR, x, y)  # the built-in P.862: no pesq package here
    assert ours == jmetrics.pesq_wb(SR, x, y) and 1.0 < ours < 4.7
    assert metrics.pesq_impl() == jmetrics.pesq_impl()
