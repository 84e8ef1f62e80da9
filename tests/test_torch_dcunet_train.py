"""Training DCUNet in the port: its BatchNorm running statistics are the JAX
package's ``model_state``.

- a train step's loss, gradients and statistics against
  ``step_loss_with_updates`` (DCUNet-10 at n_fft 64, F = 33, and
  DilDCUNet-v2 at n_fft 512, F = 257; T = 16, B = 2, the noise and times the
  JAX step draws injected; the port's seeded weights carried to JAX);
  tolerances: the loss 1e-4, the statistics 1e-5 of each norm's statistics
  scale, each leaf's gradient 1e-4 of its max|ref| for DCUNet-10 and 1e-2
  for DilDCUNet-v2, whose train-mode gradient (batch statistics over B = 2,
  through dilated layers) is ill-conditioned in float32 in either framework:
  the same weights and inputs in eval mode (running statistics) give
  gradients that agree within 1e-4, which the test also holds;
- ``state.pt`` carries the statistics, and a resume starts from them, bit for
  bit;
- validation runs the EMA parameters with the live statistics, in eval mode,
  which leaves them as they are;
- with gradient accumulation the statistics advance on every micro-step.
The entry-point runs use DCUNet-10 at n_fft 64 (F = 33) on 0.25-s wavs.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgmse_tpu.model import ScoreModel as JaxScoreModel
from sgmse_tpu.sdes import crandn as jax_crandn
from sgmse_tpu_torch import checkpoint, convert, train
from sgmse_tpu_torch.data.wav import write_wav
from sgmse_tpu_torch.model import ScoreModel

SMALL = dict(dcunet_architecture="DCUNet-10", n_fft=64, hop_length=16, num_frames=32)
CLI = ["--backbone", "dcunet", "--dcunet-architecture", "DCUNet-10", "--n_fft", "64",
       "--hop_length", "16", "--num_frames", "32", "--batch_size", "2", "--num_workers", "1",
       "--N", "2", "--nolog", "--num_eval_files", "0"]
TOL, STATS_TOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def wav_dataset(tmp_path_factory):
    """6 train and 2 valid clean/noisy pairs of 0.25 s in the reference layout."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for subset, n in (("train", 6), ("valid", 2)):
        for kind in ("clean", "noisy"):
            (root / subset / kind).mkdir(parents=True)
        for i in range(n):
            clean = 0.5 * np.sin(2 * np.pi * (200 + 50 * i) * np.arange(4000) / 16000)
            noisy = clean + 0.1 * rng.standard_normal(4000)
            write_wav(root / subset / "clean" / f"utt{i}.wav", clean.astype(np.float32), 16000)
            write_wav(root / subset / "noisy" / f"utt{i}.wav", noisy.astype(np.float32), 16000)
    return root


def _buffers(model):
    return {k: b.detach().clone() for k, b in model.dnn.named_buffers()}


@pytest.mark.parametrize("arch,n_fft,hop,grad_tol,norms", [("DCUNet-10", 64, 16, 1e-4, 5 + 4),
                                                           ("DilDCUNet-v2", 512, 128, 1e-2, 6 + 5)])
def test_train_step_matches_step_loss_with_updates(arch, n_fft, hop, grad_tol, norms):
    kw = dict(n_fft=n_fft, hop_length=hop, num_frames=16, dcunet_architecture=arch)
    port = ScoreModel("dcunet", "ouve", **kw)
    port.init_params(torch.Generator().manual_seed(3))
    jmodel = JaxScoreModel("dcunet", "ouve", **kw)
    variables = convert.jax_variables_from_state_dict(port.dnn.state_dict())
    rng = np.random.default_rng(4)
    shape = (2, 1, n_fft // 2 + 1, 16)
    x, y = ((0.3 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)))
            .astype(np.complex64) for _ in range(2))
    key = jax.random.key(6)
    kt, kz, _ = jax.random.split(key, 3)
    t = np.asarray(jax.random.uniform(kt, (2,), minval=jmodel.t_eps, maxval=jmodel.sde.T))
    z = np.asarray(jax_crandn(kz, shape))

    def loss_fn(params):
        return jmodel.step_loss_with_updates({**variables, "params": params},
                                             (jnp.asarray(x), jnp.asarray(y)), key, train=True)

    (ref_loss, updates), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    ref = convert.state_dict_from_jax(jax.tree.map(np.asarray, ref_grads))
    assert not ref.pop("embed_gfp.W").abs().max()  # stop-gradient'd in JAX

    port.train()
    loss = port.step_loss(torch.from_numpy(x), torch.from_numpy(y), t=torch.tensor(t),
                          z=torch.tensor(z))
    named = {n: p for n, p in port.dnn.named_parameters() if p.requires_grad}
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    assert abs(loss.item() - float(ref_loss)) <= TOL * abs(float(ref_loss))
    assert set(grads) == set(ref)
    for name, g in grads.items():
        err = (g - ref[name]).abs().max().item()
        assert err <= grad_tol * ref[name].abs().max().item(), (name, err)

    got = convert.flatten_tree(convert.jax_tree_from_state_dict(port.dnn.state_dict(),
                                                                "batch_stats"))
    want = convert.flatten_tree(jax.tree.map(np.asarray, updates["batch_stats"]))
    assert set(got) == set(want) and len(want) == 4 * norms  # re/im mean/var per norm
    for key_ in want:
        norm = key_.rsplit("/", 1)[0]
        scale = max(np.abs(want[f"{norm}/{s}"]).max() for s in ("mean", "var"))
        assert np.abs(got[key_] - want[key_]).max() <= STATS_TOL * scale, key_
    if grad_tol == TOL:
        return
    # eval mode, from the same weights and statistics: the network agrees at 1e-4
    ref_grads = jax.jit(jax.grad(lambda p: jmodel.step_loss(
        {**variables, "params": p}, (jnp.asarray(x), jnp.asarray(y)), key, train=False)))(
        variables["params"])
    ref = convert.state_dict_from_jax(jax.tree.map(np.asarray, ref_grads))
    port.dnn.load_state_dict(convert.state_dict_from_variables(variables))
    port.eval()
    loss = port.step_loss(torch.from_numpy(x), torch.from_numpy(y), t=torch.tensor(t),
                          z=torch.tensor(z))
    for name, g in zip(named, torch.autograd.grad(loss, list(named.values()))):
        err = (g - ref[name]).abs().max().item()
        assert err <= TOL * ref[name].abs().max().item(), (name, err)


def test_state_pt_carries_the_statistics_and_a_resume_starts_from_them(wav_dataset, tmp_path,
                                                                        monkeypatch):
    argv = ["--base_dir", str(wav_dataset), "--log_dir", str(tmp_path / "logs"), *CLI]
    stats = train.main(argv + ["--max_steps", "2"], device="cpu")
    last = f"{stats['ckpt_dir']}/last"
    saved, _ = checkpoint.load_checkpoint(last)
    assert set(saved["model_state"]) == {
        k for k in ScoreModel("dcunet", "ouve", **SMALL).dnn.state_dict()
        if k.endswith((".mean", ".var"))}
    assert any(not torch.equal(v, torch.zeros_like(v)) for k, v in saved["model_state"].items()
               if k.endswith(".mean"))
    model = checkpoint.load_score_model(last)
    for name, value in saved["model_state"].items():
        assert torch.equal(model.dnn.state_dict()[name], value), name
    for name, value in saved["ema_params"].items():
        assert torch.equal(model.dnn.state_dict()[name], value), name

    seen = []
    step = train.train_step

    def first_step(model, state, *args, **kwargs):
        if not seen:
            seen.append(_buffers(model))
        return step(model, state, *args, **kwargs)

    monkeypatch.setattr(train, "train_step", first_step)
    resumed = train.main(argv + ["--max_steps", "3", "--ckpt", last], device="cpu")
    assert resumed["step"] == 3 and len(seen) == 1
    assert set(seen[0]) == set(saved["model_state"])
    for name, value in saved["model_state"].items():
        assert torch.equal(seen[0][name], value), name


def test_validation_runs_the_ema_with_the_live_statistics(wav_dataset, tmp_path):
    model = ScoreModel("dcunet", "ouve", **SMALL, ema_decay=0.5, num_eval_files=0)
    data = train.SpecsDataModule(base_dir=str(wav_dataset), batch_size=2, num_frames=32,
                                 n_fft=64, hop_length=16, num_workers=1)
    trainer = train.Trainer(model, data, train.make_logger(True, str(tmp_path), None),
                            log_dir=str(tmp_path), max_steps=2, device="cpu")
    state = trainer.fit()
    live = _buffers(model)
    assert any(not torch.equal(v, torch.zeros_like(v)) for k, v in live.items()
               if k.endswith(".mean"))
    assert any(not torch.equal(state.params[n], state.ema_params[n]) for n in state.params)
    with train.ema_weights(state):
        for n, p in model.dnn.named_parameters():
            assert torch.equal(p, state.ema_params[n])
        for n, b in model.dnn.named_buffers():
            assert b is state.model_state[n] and torch.equal(b, live[n])

    data.setup("fit")
    seen = []
    norm = model.dnn.encoder0.norm
    hook = norm.register_forward_hook(lambda m, args, out: seen.append(
        (m.training, m.re.weight.detach().clone(), m.re.mean.clone(), m.re.var.clone())))
    metrics = trainer.validate(state, data.val_dataloader(), torch.Generator().manual_seed(5))
    hook.remove()
    assert seen and all(not training for training, *_ in seen)
    for _, weight, mean, var in seen:
        assert torch.equal(weight, state.ema_params["encoder0.norm.re.weight"])
        assert torch.equal(mean, live["encoder0.norm.re.mean"])
        assert torch.equal(var, live["encoder0.norm.re.var"])
    for n, b in model.dnn.named_buffers():  # eval mode: validation leaves them alone
        assert torch.equal(b, live[n])
    for n, p in model.dnn.named_parameters():  # the trained weights are back
        assert torch.equal(p, state.params[n])
    copy = ScoreModel("dcunet", "ouve", **SMALL)
    copy.dnn.load_state_dict({**state.ema_params, **live})
    gen, total, n = torch.Generator().manual_seed(5), 0.0, 0
    for x_wav, y_wav in data.val_dataloader():
        total += float(train.valid_step(copy, x_wav, y_wav, gen)) * x_wav.shape[0]
        n += x_wav.shape[0]
    assert metrics["valid_loss"] == pytest.approx(total / n, rel=1e-6)


def test_accumulation_advances_the_statistics_on_every_micro_step():
    model = ScoreModel("dcunet", "ouve", **SMALL)
    state = train.create_train_state(model, torch.Generator().manual_seed(0), 2)
    rng = np.random.default_rng(7)
    batches = [(0.3 * rng.standard_normal((2, 496)).astype(np.float32),
                0.3 * rng.standard_normal((2, 496)).astype(np.float32)) for _ in range(2)]
    gen = torch.Generator().manual_seed(1)
    params0 = {n: p.detach().clone() for n, p in state.params.items()}
    before = _buffers(model)
    for i, (x_wav, y_wav) in enumerate(batches):
        replica = ScoreModel("dcunet", "ouve", **SMALL)
        replica.dnn.load_state_dict(model.dnn.state_dict())
        replica_gen = torch.Generator().manual_seed(0)
        replica_gen.set_state(gen.get_state())
        x, y = train._specs(replica, x_wav, y_wav)
        replica.train().step_loss(x, y, replica_gen)
        train.train_step(model, state, x_wav, y_wav, gen)
        after = _buffers(model)
        for n in after:
            assert torch.equal(after[n], _buffers(replica)[n]), (i, n)
            if n.endswith(".mean"):
                assert not torch.equal(after[n], before[n]), (i, n)
        same = all(torch.equal(state.params[n], params0[n]) for n in params0)
        assert same == (i == 0)  # the optimizer steps on the second micro-step only
        before = after
    assert state.step == state.num_updates == 2
