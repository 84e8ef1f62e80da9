"""Dataset and data module: paired clean/noisy wavs as fixed-length batches.

The port's copy of ``sgmse_tpu/data/dataset.py`` (that module cannot be
imported without JAX, because importing ``sgmse_tpu`` imports it), with its
numpy seeding unchanged. ``WavLoader`` loads each batch through the native
C++ loader by default (``data/native.py``, ``use_native=True``, as in the
JAX package), so that a seed gives the batches of the JAX training CLI bit
for bit; where g++ is unavailable it warns and keeps the Python path, whose
crops differ. ``use_native=False`` takes the Python path, which gives the
JAX package's ``use_native=False`` batches bit for bit. The host loads,
crops, pads and normalizes waveforms; the STFT and the compression
transform run batched on the device inside the train step.

Directory layout as the reference's: ``{base_dir}/{train,valid,test}/
{clean,noisy}/*.wav`` for format 'default', ``{anechoic,reverb}`` for
'reverb'; one level of nesting is globbed too.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from glob import glob
from os.path import join
from typing import Iterator, Optional, Tuple

import numpy as np

from .. import parallel
from ..utils.profiling import span
from . import native
from .wav import read_wav


class Specs:
    """Paired clean/noisy dataset yielding fixed-length waveform crops.

    Mirrors the reference Specs dataset semantics (data_module.py:22-100):
    random (train) or center (eval) crop to ``(num_frames-1)*hop_length``
    samples, zero-pad if short, max-abs normalization by noisy/clean/none.
    """

    def __init__(self, data_dir: str, subset: str, dummy: bool, shuffle_spec: bool,
                 num_frames: int, hop_length: int, format: str = "default",
                 normalize: str = "noisy", **ignored_kwargs):
        if format == "default":
            clean_dirs, noisy_dirs = "clean", "noisy"
        elif format == "reverb":
            clean_dirs, noisy_dirs = "anechoic", "reverb"
        else:
            raise NotImplementedError(f"Directory format {format} unknown!")

        def _glob(sub):
            files = sorted(glob(join(data_dir, subset, sub, "*.wav")))
            files += sorted(glob(join(data_dir, subset, sub, "**", "*.wav")))
            return files

        self.clean_files = _glob(clean_dirs)
        self.noisy_files = _glob(noisy_dirs)
        self.dummy = dummy
        self.num_frames = num_frames
        self.hop_length = hop_length
        self.shuffle_spec = shuffle_spec
        self.normalize = normalize
        self.target_len = (num_frames - 1) * hop_length

    def __len__(self) -> int:
        if self.dummy:
            # debugging: shrink the dataset 200x (reference data_module.py:96-100)
            return int(len(self.clean_files) / 200)
        return len(self.clean_files)

    def load_pair(self, i: int, rng: Optional[np.random.Generator] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
        x, _ = read_wav(self.clean_files[i])
        y, _ = read_wav(self.noisy_files[i])
        x, y = x[0], y[0]  # first channel

        target_len = self.target_len
        current_len = x.shape[-1]
        pad = max(target_len - current_len, 0)
        if pad == 0:
            if self.shuffle_spec and rng is not None:
                start = int(rng.uniform(0, current_len - target_len))
            else:
                start = int((current_len - target_len) / 2)
            x = x[start:start + target_len]
            y = y[start:start + target_len]
        else:
            x = np.pad(x, (pad // 2, pad // 2 + pad % 2))
            y = np.pad(y, (pad // 2, pad // 2 + pad % 2))

        if self.normalize == "noisy":
            normfac = np.max(np.abs(y))
        elif self.normalize == "clean":
            normfac = np.max(np.abs(x))
        else:
            normfac = 1.0
        normfac = max(normfac, 1e-10)
        return (x / normfac).astype(np.float32), (y / normfac).astype(np.float32)


class WavLoader:
    """Shuffling, prefetching batch iterator over a Specs dataset.

    Yields (x_wav, y_wav) numpy batches of shape (batch_size, target_len).
    Drops the last partial batch in shuffled (training) mode and pads the last
    batch by repetition otherwise, as the JAX package does. Epoch e shuffles
    with ``default_rng(seed + e)`` and draws one crop seed per batch from it,
    in the main thread, so batches do not depend on thread scheduling. Each
    batch yielded adds one to ``native.SERVED`` under the path that loaded it.

    With ``process_count`` > 1 (data-parallel training, one process per rank)
    process ``process_index`` loads every ``process_count``-th index of the
    epoch's permutation, which every process draws alike from the same seed;
    the permutation is first padded by wrap-around to a multiple of the
    process count, so every shard has the same length, as in the JAX package
    (a rank with one batch more than its peers would wait for them forever in
    the gradient all-reduce).

    With ``rows=(index, count)`` (``--devices N``) every batch is loaded whole
    and only its ``index``-th block of ``batch_size / count`` rows is yielded:
    the rank's part of a batch that one process would load, as the JAX trainer
    splits one process's batch over its devices.
    """

    def __init__(self, dataset: Specs, batch_size: int, shuffle: bool,
                 seed: int = 0, num_workers: int = 4, drop_last: Optional[bool] = None,
                 use_native: bool = True, process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 rows: Optional[Tuple[int, int]] = None):
        if rows is not None and batch_size % rows[1]:
            raise ValueError(f"a batch of {batch_size} does not split into {rows[1]} equal "
                             "blocks of rows")
        self.dataset = dataset
        self.use_native = use_native
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = shuffle if drop_last is None else drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.rows = rows
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.process_count is not None and self.process_count > 1:
            n = -(-n // self.process_count)  # per-process shard size (padded)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        # The prologue (permutation, crop seeds, the pool's first loads) is one
        # ``data.epoch`` span, each wait for a loaded batch a ``data.wait`` span.
        epoch = span("data.epoch")
        epoch.__enter__()
        n = len(self.dataset)
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        if self.process_count is not None and self.process_count > 1:
            world = self.process_count
            per = -(-len(order) // world)
            padded = np.concatenate([order, order[: per * world - len(order)]])
            order = padded[self.process_index::world]
        if self.drop_last:
            order = order[: (len(order) // self.batch_size) * self.batch_size]
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        batch_seeds = [int(s) for s in rng.integers(0, 2**31, size=len(batches))]

        def load_batch(idxs, batch_seed):
            if self.use_native:
                # One native call decodes, crops and normalizes the whole batch.
                res = native.load_pair_batch(
                    [self.dataset.clean_files[int(i)] for i in idxs],
                    [self.dataset.noisy_files[int(i)] for i in idxs],
                    self.dataset.target_len, random_crop=self.dataset.shuffle_spec,
                    seed=batch_seed, normalize=self.dataset.normalize)
                if res is not None:
                    x, y = res
                    if x.shape[0] < self.batch_size:  # pad last partial batch
                        reps = self.batch_size - x.shape[0]
                        x = np.concatenate([x, np.repeat(x[-1:], reps, 0)])
                        y = np.concatenate([y, np.repeat(y[-1:], reps, 0)])
                    return x, y, "native"
            item_rng = np.random.default_rng(batch_seed)
            xs, ys = [], []
            for i in idxs:
                x, y = self.dataset.load_pair(int(i), item_rng)
                xs.append(x)
                ys.append(y)
            while len(xs) < self.batch_size:  # pad last partial batch
                xs.append(xs[-1])
                ys.append(ys[-1])
            return np.stack(xs), np.stack(ys), "python"

        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            # Keep a window of in-flight batch futures (prefetch depth = workers).
            futures = []
            it = iter(zip(batches, batch_seeds))
            for _ in range(self.num_workers):
                try:
                    futures.append(ex.submit(load_batch, *next(it)))
                except StopIteration:
                    break
            epoch.__exit__(None, None, None)
            while futures:
                fut = futures.pop(0)
                try:
                    futures.append(ex.submit(load_batch, *next(it)))
                except StopIteration:
                    pass
                with span("data.wait"):
                    x, y, path = fut.result()
                native.SERVED[path] += 1
                if self.rows is not None:
                    b = self.batch_size // self.rows[1]
                    x, y = (a[self.rows[0] * b:(self.rows[0] + 1) * b] for a in (x, y))
                yield x, y


class SpecsDataModule:
    """Data module bundling dataset config + loaders (reference data_module.py:103-236).

    Owns the DSP constants; the spectrogram computation happens on the device
    (see the module docstring).
    """

    @staticmethod
    def add_argparse_args(parser):
        parser.add_argument("--base_dir", type=str, required=True,
                            help="The base directory of the dataset. Should contain `train`, `valid` and `test` subdirectories, each of which contain `clean` and `noisy` subdirectories.")
        parser.add_argument("--format", type=str, choices=("default", "reverb"), default="default",
                            help="Read file paths according to file naming format.")
        parser.add_argument("--batch_size", type=int, default=8,
                            help="The batch size. 8 by default.")
        parser.add_argument("--n_fft", type=int, default=510,
                            help="Number of FFT bins. 510 by default.")
        parser.add_argument("--hop_length", type=int, default=128,
                            help="Window hop length. 128 by default.")
        parser.add_argument("--num_frames", type=int, default=256,
                            help="Number of frames for the dataset. 256 by default.")
        parser.add_argument("--window", type=str, choices=("sqrthann", "hann"), default="hann",
                            help="The window function to use for the STFT. 'hann' by default.")
        parser.add_argument("--num_workers", type=int, default=4,
                            help="Number of workers to use for DataLoaders. 4 by default.")
        parser.add_argument("--dummy", action="store_true",
                            help="Use reduced dummy dataset for prototyping.")
        parser.add_argument("--spec_factor", type=float, default=0.15,
                            help="Factor to multiply complex STFT coefficients by. 0.15 by default.")
        parser.add_argument("--spec_abs_exponent", type=float, default=0.5,
                            help="Exponent e for the transformation abs(z)**e * exp(1j*angle(z)). 0.5 by default.")
        parser.add_argument("--normalize", type=str, choices=("clean", "noisy", "not"), default="noisy",
                            help="Normalize the input waveforms by the clean signal, the noisy signal, or not at all.")
        parser.add_argument("--transform_type", type=str, choices=("exponent", "log", "none"),
                            default="exponent",
                            help="Spectrogram transformation for input representation.")
        return parser

    def __init__(self, base_dir: str, format: str = "default", batch_size: int = 8,
                 n_fft: int = 510, hop_length: int = 128, num_frames: int = 256,
                 window: str = "hann", num_workers: int = 4, dummy: bool = False,
                 spec_factor: float = 0.15, spec_abs_exponent: float = 0.5,
                 normalize: str = "noisy", transform_type: str = "exponent",
                 seed: int = 0, split_batch: bool = False, **ignored_kwargs):
        self.base_dir = base_dir
        self.format = format
        self.batch_size = batch_size
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.num_frames = num_frames
        self.window = window
        self.num_workers = num_workers
        self.dummy = dummy
        self.spec_factor = spec_factor
        self.spec_abs_exponent = spec_abs_exponent
        self.normalize = normalize
        self.transform_type = transform_type
        self.seed = seed
        self.split_batch = split_batch
        self.train_set = self.valid_set = self.test_set = None

    def setup(self, stage: Optional[str] = None):
        common = dict(num_frames=self.num_frames, hop_length=self.hop_length,
                      format=self.format, normalize=self.normalize, dummy=self.dummy)
        if stage in ("fit", None):
            self.train_set = Specs(self.base_dir, "train", shuffle_spec=True, **common)
            self.valid_set = Specs(self.base_dir, "valid", shuffle_spec=False, **common)
        if stage in ("test", None):
            self.test_set = Specs(self.base_dir, "test", shuffle_spec=False, **common)

    def train_dataloader(self) -> WavLoader:
        """The training loader of this rank of the process group
        (``parallel``). With ``split_batch`` (``--devices N``) ``batch_size``
        is the global batch, of which each rank keeps its block of rows, as
        the JAX trainer splits one process's batch over its devices; otherwise
        each rank (a process of a multi-host job) loads its shard of the epoch
        and ``batch_size`` is its batch, as each JAX process loads its own."""
        common = dict(shuffle=True, seed=self.seed, num_workers=self.num_workers)
        if self.split_batch:
            return WavLoader(self.train_set, self.batch_size,
                             rows=(parallel.rank(), parallel.world()), **common)
        return WavLoader(self.train_set, self.batch_size, process_index=parallel.rank(),
                         process_count=parallel.world(), **common)

    def val_dataloader(self) -> WavLoader:
        return WavLoader(self.valid_set, self.batch_size, shuffle=False,
                         num_workers=self.num_workers)

    def test_dataloader(self) -> WavLoader:
        return WavLoader(self.test_set, self.batch_size, shuffle=False,
                         num_workers=self.num_workers)

    def spec_config(self) -> dict:
        return dict(n_fft=self.n_fft, hop_length=self.hop_length, window=self.window,
                    transform_type=self.transform_type, spec_factor=self.spec_factor,
                    spec_abs_exponent=self.spec_abs_exponent, num_frames=self.num_frames)
