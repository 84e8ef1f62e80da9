"""``--data_parallel`` inference in the port (``sgmse_tpu_torch.parallel.pool``)
on the CPU, through two worker processes on ``["cpu", "cpu"]`` (the pool's
test hook), and the pieces under it:

- a rank's draws are its rows of the global batch's, and its generator ends
  where the global draw leaves it (``parallel.rows``);
- ``enhance`` through two workers equals the one-device call on the batch
  zero-padded to a multiple of the worker count, at B=4 and B=3 (as
  ``tests/test_enhance_mesh.py:35-61`` holds JAX's mesh), with injected noise
  and the trajectory too; the caller's generator ends where the one-device
  call leaves it;
- ``python -m sgmse_tpu_torch.enhance --data_parallel`` writes the wavs the
  one-device entry point writes;
- a batch served through ``serve.build_enhancer(--data_parallel)`` equals the
  direct call on the same padded batch and generator;
- what couples a batch's rows (DCUNet's CbN, the langevin corrector, the
  rk45 ODE solver) reduces over the workers' group: two workers equal one
  device on the zero-padded batch, with the same NFE;
- processes build the kernels one at a time (``kernels.build``'s file lock).

Tolerance: 1e-5 of max|out| (one device and two workers run the same float32
network on the same rows; only the batch a convolution sees differs).
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from sgmse_tpu_torch import enhance, serve
from sgmse_tpu_torch.data.wav import read_wav, write_wav
from sgmse_tpu_torch.model import ScoreModel
from sgmse_tpu_torch.parallel import global_rows
from sgmse_tpu_torch.parallel.pool import DataParallelModel
from sgmse_tpu_torch.sdes import crandn

ROOT = Path(__file__).resolve().parent.parent
NET = dict(nf=16, ch_mult=(1, 1, 2), num_res_blocks=1, attn_resolutions=(16,), image_size=64)
STFT = dict(n_fft=126, hop_length=32, num_frames=64)
TOL = 1e-5
WORKERS = ["cpu", "cpu"]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    m = ScoreModel("ncsnpp", "ouve", **NET, **STFT)
    m.init_params(torch.Generator().manual_seed(0))
    return m.eval()


@pytest.fixture(scope="module")
def pool(model):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # each worker takes a share of this process's threads
    try:
        dp = DataParallelModel(model, WORKERS)
    finally:
        torch.set_num_threads(threads)
    with dp:
        yield dp


def _noisy(batch, n=2048, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal((batch, n))).astype(np.float32)


def _padded(y, count=2):
    return np.concatenate([y, np.zeros(((-len(y)) % count, y.shape[1]), np.float32)])


def _close(got, ref):
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def test_a_rank_draws_its_rows_of_the_global_batch():
    full_gen, gen = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    full = crandn((6, 1, 4, 5), full_gen)
    with global_rows(1, 3):
        rows = crandn((2, 1, 4, 5), gen)
        with global_rows(0, 1):  # a world of one inside: the plain draw
            assert crandn((1, 2), torch.Generator().manual_seed(0)).shape == (1, 2)
    torch.testing.assert_close(rows, full[2:4], rtol=0, atol=0)
    assert torch.equal(gen.get_state(), full_gen.get_state())
    with pytest.raises(ValueError):
        with global_rows(2, 2):
            pass


@pytest.mark.parametrize("batch", [4, 3])
def test_enhance_through_two_workers_equals_one_device(model, pool, batch):
    y = _noisy(batch, seed=batch)
    gen, ref_gen = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    out = pool.enhance(y, generator=gen, N=3)
    ref = model.enhance(_padded(y), generator=ref_gen, N=3)[:batch]
    _close(out, ref)
    assert torch.equal(gen.get_state(), ref_gen.get_state())
    assert set(pool.launch_counts().values()) == {0}  # the CPU runs the plain versions


def test_two_workers_split_injected_noise_and_the_trajectory(model, pool):
    y = _noisy(3, seed=5)
    shape = (1, 64, 128)  # 65 frames, padded to a multiple of 64
    prior = crandn((3, *shape), torch.Generator().manual_seed(9)).numpy()
    kw = dict(N=2, corrector="none", intermediate=True, timeit=True)
    out, traj, nfe, _ = pool.enhance(y, prior_noise=prior, **kw)
    ref, ref_traj, ref_nfe, _ = model.enhance(_padded(y), prior_noise=_padded(
        prior.reshape(3, -1)).reshape(4, *shape), **kw)
    assert nfe == ref_nfe == 2 and traj.shape == (2, 3, *shape)
    _close(out, ref[:3])
    _close(traj, ref_traj[:, :3])


def _weight_flags(model, tmp_path):
    """--weights and --config of the test model."""
    from sgmse_tpu_torch import convert

    convert.save_npz(tmp_path / "w.npz", convert.jax_tree_from_state_dict(model.dnn.state_dict()))
    (tmp_path / "config.json").write_text(json.dumps(model.config_dict()))
    return ["--weights", str(tmp_path / "w.npz"), "--config", str(tmp_path / "config.json")]


def test_enhance_entry_point_data_parallel(model, tmp_path, capsys):
    noisy = tmp_path / "noisy"
    noisy.mkdir()
    for i, y in enumerate(_noisy(4, n=4000, seed=2)):
        write_wav(noisy / f"u{i}.wav", y, 16000)
    flags = ["--test_dir", str(noisy), *_weight_flags(model, tmp_path), "--N", "2",
             "--batch_size", "2"]
    one = enhance.main(flags + ["--enhanced_dir", str(tmp_path / "one")], device="cpu")
    two = enhance.main(flags + ["--enhanced_dir", str(tmp_path / "two"), "--data_parallel"],
                       device=WORKERS)
    assert two["devices"] == WORKERS and two["files"] == one["files"] == 4
    assert two["nfe"] == one["nfe"] and two["all_finite"]
    for i in range(4):
        _close(read_wav(tmp_path / "two" / f"u{i}.wav")[0],
               read_wav(tmp_path / "one" / f"u{i}.wav")[0])
    enhance.main(flags[:-2] + ["--batch_size", "1", "--enhanced_dir", str(tmp_path / "three"),
                               "--data_parallel"], device=WORKERS)
    assert "batch_size 1 < 2 devices" in capsys.readouterr().err
    with pytest.raises(ValueError, match="data_parallel"):
        enhance.main(flags + ["--enhanced_dir", str(tmp_path / "four")], device=WORKERS)


def test_served_batch_through_two_workers_equals_a_direct_one(model, tmp_path):
    flags = [*_weight_flags(model, tmp_path), "--batch_size", "4",
             "--max_delay_ms", "500", "--N", "2", "--corrector", "none", "--data_parallel"]
    args = serve.build_parser().parse_args(flags)
    built, enh, _ = serve.build_enhancer(args, device=WORKERS)
    with enh:
        assert isinstance(built, DataParallelModel) and built.devices == [torch.device("cpu")] * 2
        wavs = list(_noisy(3, n=enh.samples_for_bucket(64), seed=4))
        futures = [enh.submit(w) for w in wavs]
        got = [f.result(timeout=120) for f in futures]
        assert enh.stats()["batches"] == 1
        ref = model.enhance(np.stack(wavs + [np.zeros_like(wavs[0])]),
                            generator=enh.generator(0), sde=built.sde, pad_mode=enh.pad_mode,
                            **enh.sampler_kwargs)
    for g, r in zip(got, ref):
        _close(g, r)
    assert not any(p.is_alive() for p in built._procs)  # closing the enhancer closed the pool


@pytest.fixture(scope="module")
def cbn_model():
    m = ScoreModel("dcunet", "ouve", dcunet_architecture="DCUNet-10", dcunet_norm_type="CbN",
                   n_fft=64, hop_length=16, num_frames=16)
    m.init_params(torch.Generator().manual_seed(1))
    return m.eval()


COUPLED = {  # what couples a batch's rows: sampler arguments, and whether DCUNet-CbN runs them
    "langevin": (dict(N=2, corrector="langevin"), False),
    "rk45": (dict(sampler_type="ode", method="rk45", max_steps=2), False),
    "cbn": (dict(N=2), True),
}


@pytest.mark.filterwarnings("ignore:ODE sampler hit max_steps")
@pytest.mark.parametrize("batch", [4, 3])
@pytest.mark.parametrize("path", sorted(COUPLED))
def test_data_parallel_refuses_what_couples_rows(model, pool, cbn_model, path, batch):
    """What couples a batch's rows is no longer refused: the langevin
    corrector's batch means, rk45's norms (bounded ``max_steps``, as on a
    random net it is stiff) and DCUNet's CbN statistics reduce over the
    workers' group, so two workers equal one device on the zero-padded batch
    (at B = 3 the padding row enters the statistics), with the same NFE."""
    kw, cbn = COUPLED[path]
    net = cbn_model if cbn else model
    y = _noisy(batch, n=1000 if cbn else 2048, seed=10 + batch)
    gen, ref_gen = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    ref, ref_nfe, _ = net.enhance(_padded(y), generator=ref_gen, timeit=True, **kw)
    if cbn:
        with DataParallelModel(net, WORKERS) as dp:
            out, nfe, _ = dp.enhance(y, generator=gen, timeit=True, **kw)
            calls = dp.collective_counts()
    else:
        pool.collective_counts(reset=True)
        out, nfe, _ = pool.enhance(y, generator=gen, timeit=True, **kw)
        calls = pool.collective_counts()
    _close(out, ref[:batch])
    assert nfe == ref_nfe and torch.equal(gen.get_state(), ref_gen.get_state())
    assert calls[0]["calls"] == calls[1]["calls"] > 0


def test_processes_build_the_kernels_one_at_a_time(tmp_path):
    """Two processes that find no library at once: one builds it, the other
    waits for the file lock and loads that build."""
    script = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {str(ROOT)!r})
        from pathlib import Path
        from sgmse_tpu_torch import kernels
        kernels.BUILD_DIR = Path({str(tmp_path)!r})
        so = kernels.BUILD_DIR / "lib.so"
        kernels.library_path = lambda: so
        def slow_build(path):
            with open(kernels.BUILD_DIR / "log", "a") as f:
                f.write("start\\n")
            time.sleep(1.0)
            path.write_text("built")
            with open(kernels.BUILD_DIR / "log", "a") as f:
                f.write("end\\n")
            return path
        kernels._build = slow_build
        assert kernels.build() == so
    """)
    procs = [subprocess.Popen([sys.executable, "-c", script]) for _ in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    assert (tmp_path / "log").read_text().split() == ["start", "end"]


def test_a_rank_that_dies_at_start_up_is_reported(tmp_path):
    """A rank whose target cannot be imported dies while it reads its start-up
    data; with large arguments its parent must still see it die and raise
    (the arguments go through a queue, not through the start)."""
    (tmp_path / "gone_rank.py").write_text("def target(rank, world, init, *args):\n    return 0\n")
    script = textwrap.dedent(f"""
        import os, sys, time
        import numpy as np
        sys.path.insert(0, {str(ROOT)!r})
        sys.path.insert(0, {str(tmp_path)!r})
        import gone_rank
        from sgmse_tpu_torch.parallel import dist
        os.remove({str(tmp_path / "gone_rank.py")!r})  # the ranks cannot import it
        t0 = time.time()
        try:
            dist.spawn(gone_rank.target, 2, (np.zeros(4_000_000, np.float32),), timeout=60)
        except RuntimeError as e:
            print("raised", "exited without a result" in str(e), round(time.time() - t0))
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120)
    assert res.stdout.split()[:2] == ["raised", "True"], (res.stdout, res.stderr[-2000:])
