"""Data-parallel training in the port (``sgmse_tpu_torch.parallel`` and the
trainer's gradient all-reduce), on the CPU with gloo ranks in processes of
their own, held to the JAX package and to one process:

- the loader's process shards equal JAX's bit for bit (2 and 3 processes, an
  odd file count, both loader paths), and ``shard_eval_files`` equals JAX's;
- ``train.main --devices 2`` trains two ranks, each on half of every batch
  of ``--batch_size``: identical final parameters, EMA and state on both;
  only rank 0 writes logs; its first logged loss is a one-process step's on
  the global batch within 1e-6 relative; its validation loss is a
  one-process validation's within 1e-6 relative; it trains as
  ``--devices 1`` with the same ``--batch_size`` does; a resume from its
  checkpoint runs;
- one data-parallel step with dropout: the global loss within 1e-6 relative
  and each leaf's gradient within 1e-5 of its max|g| of one process on the
  global batch (the draws are the global batch's, each rank keeping its
  rows); with ``--accumulate_grad_batches 2``, one reduction per update, of
  the running mean, likewise;
- DCUNet bN over two ranks against JAX's step on a 2-device mesh (injected t
  and z): the statistics are the global batch's (1e-5 of their scale), the
  loss and gradients at ``tests/test_torch_dcunet_train.py``'s 1e-4;
- every backbone gives every trainable parameter a gradient (the trainer's
  ``torch.autograd.grad`` raises otherwise).

Every multi-process case has its own time limit (``RANK_TIMEOUT_S``).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgmse_tpu.data.dataset import Specs as JaxSpecs, WavLoader as JaxWavLoader
from sgmse_tpu.model import ScoreModel as JaxScoreModel
from sgmse_tpu.parallel.mesh import data_sharding, make_data_mesh, replicated
from sgmse_tpu.sdes import crandn as jax_crandn
from sgmse_tpu.utils.inference import shard_eval_files as jax_shard_eval_files
from sgmse_tpu_torch import checkpoint, convert, train
from sgmse_tpu_torch.data.dataset import Specs, WavLoader
from sgmse_tpu_torch.data.wav import write_wav
from sgmse_tpu_torch.model import ScoreModel
from sgmse_tpu_torch.parallel import dist as pdist
from sgmse_tpu_torch.sdes import crandn
from sgmse_tpu_torch.utils.inference import shard_eval_files

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_ddp_ranks as ranks  # noqa: E402

RANK_TIMEOUT_S = 180
NET = dict(nf=16, ch_mult=(1, 1, 2), num_res_blocks=1, attn_resolutions=(16,), image_size=64)
STFT = dict(n_fft=126, hop_length=32, num_frames=64)
CLI = ["--nf", "16", "--ch_mult", "1", "1", "2", "--num_res_blocks", "1", "--attn_resolutions",
       "16", "--n_fft", "126", "--hop_length", "32", "--num_frames", "64", "--batch_size", "4",
       "--num_workers", "1", "--N", "2", "--nolog"]
LOSS_RTOL, GRAD_TOL, PARAM_TOL = 1e-6, 1e-5, 1e-6
SR = 16000


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def wav_dataset(tmp_path_factory):
    """7 train (an odd count) and 3 valid clean/noisy pairs of 0.25 s."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for subset, n in (("train", 7), ("valid", 3)):
        for kind in ("clean", "noisy"):
            (root / subset / kind).mkdir(parents=True)
        for i in range(n):
            t = np.arange(4000) / SR
            clean = 0.5 * np.sin(2 * np.pi * (200 + 50 * i) * t).astype(np.float32)
            noisy = clean + 0.1 * rng.standard_normal(4000).astype(np.float32)
            write_wav(root / subset / "clean" / f"utt{i}.wav", clean, SR)
            write_wav(root / subset / "noisy" / f"utt{i}.wav", noisy, SR)
    return root


@pytest.mark.parametrize("count", [2, 3])
@pytest.mark.parametrize("use_native", [True, False])
def test_wav_loader_process_shards_match_jax(wav_dataset, count, use_native):
    common = dict(dummy=False, shuffle_spec=True, num_frames=64, hop_length=32)
    port_set = Specs(str(wav_dataset), "train", **common)
    jax_set = JaxSpecs(str(wav_dataset), "train", **common)
    lengths = set()
    for index in range(count):
        kw = dict(batch_size=2, shuffle=True, seed=5, num_workers=1, use_native=use_native,
                  process_index=index, process_count=count)
        port, ref = WavLoader(port_set, **kw), JaxWavLoader(jax_set, **kw)
        assert len(port) == len(ref)
        for _ in range(2):  # two epochs
            got, want = list(port), list(ref)
            assert len(got) == len(want) == len(port)
            for (x, y), (rx, ry) in zip(got, want):
                np.testing.assert_array_equal(x, rx)
                np.testing.assert_array_equal(y, ry)
        lengths.add(len(port))
    assert len(lengths) == 1  # equal shards: no rank waits for another at an epoch's end


@pytest.mark.parametrize("n_files", [5, 8])
@pytest.mark.parametrize("count", [1, 2, 3])
def test_shard_eval_files_matches_jax(n_files, count):
    files = [f"f{i}.wav" for i in range(n_files)]
    for index in range(count):
        assert shard_eval_files(files, index, count) == jax_shard_eval_files(files, index, count)
    assert shard_eval_files(files) == files  # no group: one process takes them all


@pytest.fixture(scope="module")
def two_rank_run(wav_dataset, tmp_path_factory):
    """``train.main --devices 2`` on the CPU: two gloo ranks, each on 2 rows
    of every batch of 4, 2 steps (an epoch of the 7 files is one batch), two
    validations."""
    logs = tmp_path_factory.mktemp("logs")
    argv = ["--base_dir", str(wav_dataset), "--log_dir", str(logs), "--max_steps", "2",
            "--num_eval_files", "2", "--devices", "2", *CLI]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # each rank takes a share of this process's threads
    try:
        return train.main(argv, device="cpu", timeout=RANK_TIMEOUT_S), argv, logs
    finally:
        torch.set_num_threads(threads)


def test_two_ranks_train_alike_and_rank_0_writes(two_rank_run):
    stats, _, logs = two_rank_run
    assert [r["rank"] for r in stats["ranks"]] == [0, 1]
    assert all(r["world"] == 2 and r["step"] == 2 for r in stats["ranks"])
    assert stats["ranks"][0]["state_sha256"] == stats["ranks"][1]["state_sha256"]
    np.testing.assert_equal(stats["ranks"][0]["metrics"], stats["ranks"][1]["metrics"])
    assert stats["ranks"][0]["history"] == stats["ranks"][1]["history"]
    # rank 0 alone made a logger (another would have made version_1) and checkpoints
    assert sorted(p.name for p in (logs / "sgmse").iterdir()) == ["version_0"]
    assert sorted(p.name for p in Path(stats["ckpt_dir"]).iterdir()) == [
        "best_pesq", "best_si_sdr", "last"]
    logged = (logs / "sgmse" / "version_0" / "metrics.jsonl").read_text().splitlines()
    assert any("valid_loss" in row for row in logged)


def _global_first_batch(wav_dataset, native=True):
    """One process's first training batch of 4: the global batch of step 1,
    whose rows the two ranks split."""
    data = Specs(str(wav_dataset), "train", dummy=False, shuffle_spec=True, num_frames=64,
                 hop_length=32)
    return next(iter(WavLoader(data, 4, shuffle=True, seed=0, num_workers=1,
                               use_native=native)))


def test_first_logged_loss_is_the_global_batch_step(two_rank_run, wav_dataset):
    stats, _, _ = two_rank_run
    x, y = _global_first_batch(wav_dataset)
    model = ScoreModel("ncsnpp", "ouve", **NET, **STFT)
    state = train.create_train_state(model, torch.Generator().manual_seed(0))
    loss, _ = train.compute_gradients(model, state, x, y, torch.Generator().manual_seed(0))
    step, logged = stats["history"][0]
    assert step == 1
    assert abs(logged - loss.item()) <= LOSS_RTOL * abs(loss.item())


def test_validation_loss_is_one_process_validation(two_rank_run, wav_dataset):
    """The EMA weights of the 2-rank run validated by one process, whose
    generator made the draws of two global-batch steps (4 rows each), as the
    ranks' generators did: the same loss within 1e-6 relative."""
    stats, argv, _ = two_rank_run
    restored, _ = checkpoint.load_checkpoint(f"{stats['ckpt_dir']}/last")
    model = ScoreModel("ncsnpp", "ouve", **NET, **STFT)
    state = train.create_train_state(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for n, e in state.ema_params.items():
            e.copy_(restored["ema_params"][n])
    generator = torch.Generator().manual_seed(0)
    for _ in range(2):
        model.draw_t(4, generator, "cpu")
        crandn((4, 1, 64, 64), generator, "cpu")
    parser, args = train.build_parser(argv)
    from sgmse_tpu_torch.data.dataset import SpecsDataModule
    data = SpecsDataModule(**train._argument_groups(parser, args)["DataModule"])
    data.setup("fit")
    model.num_eval_files = 0
    trainer = train.Trainer(model, data, train.make_logger(True, "unused", is_main=False),
                            device="cpu")
    valid = trainer.validate(state, data.val_dataloader(), generator)["valid_loss"]
    got = stats["metrics"]["valid_loss"]
    assert abs(got - valid) <= LOSS_RTOL * abs(valid)


def test_two_ranks_train_as_one_device_with_the_same_batch_size(two_rank_run, tmp_path):
    """``--devices 2 --batch_size 4`` is ``--devices 1 --batch_size 4`` (as in
    the JAX trainer, which splits the batch over its devices): the same
    losses and validation loss within 1e-6 relative, the same final
    parameters and EMA within 1e-6. The bound is absolute: Adam's update
    lr * m / sqrt(v) moves a weight by about lr wherever its gradient is
    small, whatever the gradient's rounding, and the zero-initialised layers
    (init_scale 0) hold nothing else after two steps."""
    stats, argv, _ = two_rank_run
    i = argv.index("--devices")
    one = train.main(argv[:i] + ["--devices", "1"] + argv[i + 2:] + ["--log_dir",
                                                                     str(tmp_path / "logs")],
                     device="cpu")
    assert [s for s, _ in one["history"]] == [s for s, _ in stats["history"]] == [1, 2]
    for (_, got), (_, want) in zip(stats["history"], one["history"]):
        assert abs(got - want) <= LOSS_RTOL * abs(want)
    want = one["metrics"]["valid_loss"]
    assert abs(stats["metrics"]["valid_loss"] - want) <= LOSS_RTOL * abs(want)
    trees = [checkpoint.load_checkpoint(f"{r['ckpt_dir']}/last")[0] for r in (stats, one)]
    for part in ("params", "ema_params"):
        for name, ref in trees[1][part].items():
            err = (trees[0][part][name] - ref).abs().max().item()
            assert err <= PARAM_TOL, (part, name, err)


def test_devices_must_divide_the_batch(wav_dataset, tmp_path):
    argv = ["--base_dir", str(wav_dataset), "--log_dir", str(tmp_path), "--devices", "3", *CLI]
    with pytest.raises(ValueError, match="does not split over --devices 3"):
        train.main(argv, device="cpu")


def test_resume_from_the_two_rank_checkpoint(two_rank_run, wav_dataset, tmp_path):
    stats, _, _ = two_rank_run
    argv = ["--base_dir", str(wav_dataset), "--log_dir", str(tmp_path / "logs"), "--max_steps",
            "3", "--num_eval_files", "0", "--devices", "2", "--ckpt",
            f"{stats['ckpt_dir']}/last", *CLI]
    resumed = train.main(argv, device="cpu", timeout=RANK_TIMEOUT_S)
    assert all(r["step"] == r["num_updates"] == 3 for r in resumed["ranks"])
    assert resumed["ranks"][0]["state_sha256"] == resumed["ranks"][1]["state_sha256"]
    assert np.isfinite(resumed["metrics"]["valid_loss"])


def _hold_gradients(got, want):
    """Each leaf within GRAD_TOL of its max|g|; the attention key biases, whose
    gradient is exactly zero (softmax invariance), at rounding level against
    the network's largest gradient."""
    largest = max(np.abs(g).max() for g in want.values())
    for name, ref in want.items():
        err = np.abs(got[name] - ref).max()
        scale = largest if name.endswith("NIN_1.b") else np.abs(ref).max()
        assert err <= GRAD_TOL * scale, (name, err)


def _waveforms(batch, seed):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((batch, 63 * 32))).astype(np.float32)
    return x, (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)


DROPOUT_NET = dict(backbone="ncsnpp", sde="ouve", dropout=0.1, **NET, **STFT)
DCUNET = dict(backbone="dcunet", sde="ouve", dcunet_architecture="DCUNet-10", n_fft=64,
              hop_length=16, num_frames=16)
DCUNET_CBN = dict(DCUNET, dcunet_norm_type="CbN")


def _dcunet_inputs(config, rng):
    """A seeded DCUNet's state_dict and a global batch of 4 spectrograms (x, y)."""
    port = ScoreModel(**config)
    port.init_params(torch.Generator().manual_seed(3))
    shape = (4, 1, 33, 16)
    x, y = ((0.3 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)))
            .astype(np.complex64) for _ in range(2))
    return {k: v.numpy().copy() for k, v in port.dnn.state_dict().items()}, x, y


@pytest.fixture(scope="module")
def rank_jobs():
    """The rank side of the four tests below, in one start of two gloo ranks
    (``ranks.run``): a data-parallel step with dropout, two accumulation micro-steps,
    DCUNet bN's and CbN's train-mode steps with injected t and z. Returns
    each job's inputs and its two ranks' results."""
    x, y = _waveforms(4, 1)
    batches = [_waveforms(4, s) for s in (2, 3)]
    bn_sd, bn_x, bn_y = _dcunet_inputs(DCUNET, np.random.default_rng(4))
    kt, kz, _ = jax.random.split(jax.random.key(6), 3)
    jmodel = JaxScoreModel("dcunet", "ouve", **{k: v for k, v in DCUNET.items()
                                                if k not in ("backbone", "sde")})
    bn_t = np.asarray(jax.random.uniform(kt, (4,), minval=jmodel.t_eps, maxval=jmodel.sde.T))
    bn_z = np.asarray(jax_crandn(kz, bn_x.shape))
    rng = np.random.default_rng(5)
    cbn_sd, cbn_x, cbn_y = _dcunet_inputs(DCUNET_CBN, rng)
    cbn_t = rng.uniform(0.03, 1.0, 4).astype(np.float32)
    cbn_z = ((rng.standard_normal(cbn_x.shape) + 1j * rng.standard_normal(cbn_x.shape))
             / np.sqrt(2)).astype(np.complex64)
    jobs = {"step": ("first_step", (DROPOUT_NET, x, y, 11)),
            "accumulation": ("accumulated_update", (DROPOUT_NET, [b[0] for b in batches],
                                                    [b[1] for b in batches], 12)),
            "bn": ("injected_step", (DCUNET, bn_sd, bn_x, bn_y, bn_t, bn_z)),
            "cbn": ("injected_step", (DCUNET_CBN, cbn_sd, cbn_x, cbn_y, cbn_t, cbn_z))}
    out = pdist.spawn(ranks.run, 2, (list(jobs.values()),), timeout=RANK_TIMEOUT_S)
    return {name: (args, [out[0][i], out[1][i]]) for i, (name, (_, args)) in
            enumerate(jobs.items())}


def test_ddp_step_equals_one_process_on_the_global_batch(rank_jobs):
    (_, x, y, seed), out = rank_jobs["step"]
    model = ScoreModel(**DROPOUT_NET)
    state = train.create_train_state(model, torch.Generator().manual_seed(0))
    loss, grads = train.compute_gradients(model, state, x, y, torch.Generator().manual_seed(seed))
    global_loss = np.mean([o[0] for o in out])
    assert abs(global_loss - loss.item()) <= LOSS_RTOL * abs(loss.item())
    for _, rank_grads in out:
        _hold_gradients(rank_grads, {n: g.numpy() for n, g in grads.items()})


def test_ddp_accumulation_reduces_the_running_mean_once(rank_jobs):
    (_, xs, ys, seed), out = rank_jobs["accumulation"]
    model = ScoreModel(**DROPOUT_NET)
    state = train.create_train_state(model, torch.Generator().manual_seed(0),
                                     accumulate_grad_batches=2)
    generator = torch.Generator().manual_seed(seed)
    means = {}
    for x, y in zip(xs, ys):
        _, grads = train.compute_gradients(model, state, x, y, generator)
        for n, g in grads.items():  # optax.MultiSteps' running mean, as apply_gradients keeps it
            means[n] = g.clone() if n not in means else means[n] + (g - means[n]) / 2
    (reduced0, params0), (reduced1, params1) = out
    for reduced in (reduced0, reduced1):
        assert len(reduced) == 1  # one reduction for the update of two micro-steps
        _hold_gradients(reduced[0], {n: m.numpy() for n, m in means.items()})
    for name in params0:
        np.testing.assert_array_equal(params0[name], params1[name])


def test_dcunet_batch_norm_over_two_ranks_matches_a_two_device_mesh(rank_jobs):
    """Trap: per-rank statistics would differ from the global batch's; this
    holds the ranks to JAX's step with its batch sharded over 2 devices."""
    (_, state_dict, x, y, _, _), out = rank_jobs["bn"]
    kw = {k: v for k, v in DCUNET.items() if k not in ("backbone", "sde")}
    jmodel = JaxScoreModel("dcunet", "ouve", **kw)
    variables = convert.jax_variables_from_state_dict(
        {k: torch.from_numpy(v) for k, v in state_dict.items()})
    key = jax.random.key(6)  # the fixture's t and z are this key's draws
    mesh = make_data_mesh(2)

    def loss_fn(params, xx, yy):
        return jmodel.step_loss_with_updates({**variables, "params": params}, (xx, yy), key,
                                             train=True)

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                   in_shardings=(replicated(mesh), data_sharding(mesh), data_sharding(mesh)))
    (ref_loss, updates), ref_grads = step(variables["params"], jnp.asarray(x), jnp.asarray(y))
    ref = convert.state_dict_from_jax(jax.tree.map(np.asarray, ref_grads))
    ref.pop("embed_gfp.W")
    want = convert.flatten_tree(jax.tree.map(np.asarray, updates["batch_stats"]))
    loss = np.mean([o[0] for o in out])
    assert abs(loss - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))
    for _, grads, buffers in out:
        for name, g in grads.items():
            err = np.abs(g - ref[name].numpy()).max()
            assert err <= 1e-4 * np.abs(ref[name].numpy()).max(), (name, err)
        got = convert.flatten_tree(convert.jax_tree_from_state_dict(
            {k: torch.from_numpy(v) for k, v in buffers.items()}, "batch_stats"))
        assert set(got) == set(want)
        for key_ in want:
            norm = key_.rsplit("/", 1)[0]
            scale = max(np.abs(want[f"{norm}/{s}"]).max() for s in ("mean", "var"))
            assert np.abs(got[key_] - want[key_]).max() <= 1e-5 * scale, key_


def test_dcunet_complex_batch_norm_over_two_ranks_matches_one_process(rank_jobs):
    """CbN's train-mode whitening over two ranks takes the global batch's
    statistics: the ranks' step equals one process's on the whole batch."""
    (_, state_dict, x, y, t, z), out = rank_jobs["cbn"]
    port = ScoreModel(**DCUNET_CBN)
    port.dnn.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    port.train()
    loss = port.step_loss(torch.from_numpy(x), torch.from_numpy(y), t=torch.from_numpy(t),
                          z=torch.from_numpy(z))
    named = {n: p for n, p in port.dnn.named_parameters() if p.requires_grad}
    ref = dict(zip(named, (g.numpy() for g in torch.autograd.grad(loss, list(named.values())))))
    assert abs(np.mean([o[0] for o in out]) - loss.item()) <= 1e-4 * abs(loss.item())
    for _, grads, _ in out:
        for name, g in grads.items():
            assert np.abs(g - ref[name]).max() <= 1e-4 * np.abs(ref[name]).max(), name


@pytest.mark.parametrize("config", [
    dict(backbone="ncsnpp", sde="ouve", **NET, **STFT),
    dict(backbone="ncsnpp_v2", sde="sbve", loss_type="data_prediction", **NET, **STFT),
    dict(backbone="ncsnpp_48k", sde="ouve", nf=16, ch_mult=(1, 1, 2), num_res_blocks=1,
         attn_resolutions=(16,), n_fft=126, hop_length=32, num_frames=64),
    dict(backbone="dcunet", sde="ouve", dcunet_architecture="DCUNet-10", n_fft=64,
         hop_length=16, num_frames=16),
], ids=["ncsnpp", "ncsnpp_v2", "ncsnpp_48k", "dcunet"])
def test_every_trainable_parameter_gets_a_gradient(config):
    """The trainer takes the gradient of every trainable parameter with
    ``torch.autograd.grad``, which raises for one that the loss does not
    reach, and reduces them all over the ranks."""
    model = ScoreModel(**config)
    model.init_params(torch.Generator().manual_seed(0))
    model.train()
    shape = (2, 1, model.spec.n_fft // 2 + 1, config["num_frames"])
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy((0.3 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)))
                             .astype(np.complex64)) for _ in range(2))
    model.step_loss(x, y, torch.Generator().manual_seed(1)).backward()
    missing = [n for n, p in model.dnn.named_parameters() if p.requires_grad and p.grad is None]
    assert not missing
