"""The port's native C++ batch loader (``sgmse_tpu_torch.data.native``) and
``WavLoader``'s default path, against the JAX package's native loader, on the
CPU: batches bit for bit (the same C++ source, built with the same flags),
for a random and a center crop and each normalize mode, on pairs that are
long, short, of about the target length and of unequal lengths (a crop spans
the shorter file of the pair); one decode against the port's Python reader;
the default ``WavLoader``'s batches over two epochs against the JAX default
``WavLoader``'s; the Python path where the library is unavailable.
"""
import numpy as np
import pytest

from sgmse_tpu.data import native as jax_native
from sgmse_tpu.data.dataset import Specs as JaxSpecs, WavLoader as JaxWavLoader
from sgmse_tpu_torch.data import native
from sgmse_tpu_torch.data.dataset import Specs, WavLoader
from sgmse_tpu_torch.data.wav import read_wav, write_wav

# (clean, noisy) lengths: long, about the target (945), short, unequal
LENGTHS = [(4000, 4000), (2000, 2000), (900, 900), (3000, 2800), (5000, 5000)]
SPECS = dict(dummy=False, num_frames=16, hop_length=63)


@pytest.fixture(scope="module")
def libs():
    if jax_native.get_lib() is None or native.get_lib() is None:
        pytest.skip("no C++ toolchain to build the native loaders")


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    base = tmp_path_factory.mktemp("ds")
    rng = np.random.default_rng(0)
    for split in ("train", "valid"):
        (base / split / "clean").mkdir(parents=True)
        (base / split / "noisy").mkdir(parents=True)
        for i, (n_clean, n_noisy) in enumerate(LENGTHS):
            x = (0.5 * np.sin(2 * np.pi * (180 + 40 * i) * np.arange(n_clean) / 16000)
                 ).astype(np.float32)
            y = np.resize(x, n_noisy) + 0.1 * rng.standard_normal(n_noisy).astype(np.float32)
            write_wav(base / split / "clean" / f"u{i}.wav", x, 16000)
            write_wav(base / split / "noisy" / f"u{i}.wav", y, 16000)
    return base


@pytest.mark.parametrize("random_crop", [True, False])
@pytest.mark.parametrize("normalize", ["noisy", "clean", "not"])
def test_native_batches_equal_jax_native_batches(libs, dataset_dir, random_crop, normalize):
    ds = Specs(str(dataset_dir), "train", shuffle_spec=random_crop, normalize=normalize,
               **SPECS)
    for seed in (0, 7, 2**31 - 1):
        got = native.load_pair_batch(ds.clean_files, ds.noisy_files, ds.target_len,
                                     random_crop=random_crop, seed=seed, normalize=normalize)
        want = jax_native.load_pair_batch(ds.clean_files, ds.noisy_files, ds.target_len,
                                          random_crop=random_crop, seed=seed,
                                          normalize=normalize)
        for g, w in zip(got, want):
            assert g.shape == (len(LENGTHS), ds.target_len) and g.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    if not random_crop:  # the center crop is the Python path's crop
        for i in range(len(LENGTHS) - 2):  # the pairs of equal lengths
            for g, w in zip((got[0][i], got[1][i]), ds.load_pair(i)):
                np.testing.assert_allclose(g, w, atol=1e-6)


def test_read_wav_native_matches_read_wav(libs, dataset_dir):
    for i in range(len(LENGTHS)):
        path = dataset_dir / "train" / "noisy" / f"u{i}.wav"
        got, sr = native.read_wav_native(path)
        want, want_sr = read_wav(path)
        assert sr == want_sr == 16000 and got.shape == want[0].shape
        np.testing.assert_array_equal(got, want[0])


def test_bad_file_raises(libs, tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav at all")
    with pytest.raises(RuntimeError, match="native wav"):
        native.load_pair_batch([str(bad)], [str(bad)], 100, random_crop=False, seed=0,
                               normalize="noisy")
    with pytest.raises(RuntimeError, match="native wav read failed"):
        native.read_wav_native(bad)


@pytest.mark.parametrize("shuffle", [True, False])
def test_default_wav_loader_equals_jax_default(libs, dataset_dir, shuffle):
    """Both defaults are the native path; shuffled, the last partial batch is
    dropped; in order, it is padded by repetition."""
    subset = "train" if shuffle else "valid"
    kw = dict(shuffle_spec=shuffle, **SPECS)
    ours = WavLoader(Specs(str(dataset_dir), subset, **kw), batch_size=2, shuffle=shuffle,
                     seed=3, num_workers=2)
    ref = JaxWavLoader(JaxSpecs(str(dataset_dir), subset, **kw), batch_size=2,
                       shuffle=shuffle, seed=3, num_workers=2)
    assert ours.use_native and ref.use_native
    before = dict(native.SERVED)
    for _ in range(2):  # two epochs: the seed moves with the epoch
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours) == (2 if shuffle else 3)
        for (gx, gy), (wx, wy) in zip(got, want):
            assert gx.shape == (2, ours.dataset.target_len)
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    assert native.SERVED["native"] - before["native"] == 2 * len(ours)
    assert native.SERVED["python"] == before["python"]


def test_unavailable_library_keeps_the_python_path(dataset_dir, monkeypatch):
    kw = dict(shuffle_spec=True, **SPECS)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    before = dict(native.SERVED)
    got = list(WavLoader(Specs(str(dataset_dir), "train", **kw), 2, shuffle=True, seed=1))
    want = list(JaxWavLoader(JaxSpecs(str(dataset_dir), "train", **kw), 2, shuffle=True,
                             seed=1, use_native=False))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert native.SERVED["python"] - before["python"] == len(got) == 2
    assert native.SERVED["native"] == before["native"]


def test_library_is_built_into_the_build_directory(libs):
    so = native.library_path()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert so.name.startswith("libwavload_") and so.suffix == ".so"
    assert native.SRC.read_bytes() == (jax_native._SRC).read_bytes()
