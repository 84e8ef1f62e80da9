"""Synthesize the WSJ0+QUT corpus: WSJ0 speech mixed with four QUT-NOISE
environments (cafe, car, home, street) at SNR ~ U[0, 15] dB. The port's copy
of ``preprocessing/create_wsj0_qut.py``:

    python -m sgmse_tpu_torch.preprocessing.create_wsj0_qut <wsj0> <qut> <target>

The same noise file selection, 16 kHz resampling, the car-noise sweep removal (first and
last 2 minutes), seed 0 and identical draw order, same output layout.
"""
import os
from argparse import ArgumentParser
from glob import glob
from typing import List, Optional

import numpy as np

from ..data.wav import resample
from .mixing import load_mono, make_split_dirs, mix_at_random_snr, write_pair

min_snr = 0
max_snr = 15
sr = 16000


def main(argv: Optional[List[str]] = None):
    parser = ArgumentParser()
    parser.add_argument("wsj0", type=str, help="path to WSJ0 directory")
    parser.add_argument("qut", type=str, help="path to QUT-NOISE directory")
    parser.add_argument("target", type=str, help="target path for training files")
    args = parser.parse_args(argv)

    split_files = {
        "train": sorted(glob(args.wsj0 + "**/si_tr_s/**/*.wav", recursive=True)),
        "valid": sorted(glob(args.wsj0 + "**/si_dt_05/**/*.wav", recursive=True)),
        "test": sorted(glob(args.wsj0 + "**/si_et_05/**/*.wav", recursive=True)),
    }

    print("Loading QUT noise files")

    def load_qut(pattern):
        f = glob(args.qut + pattern, recursive=True)[0]
        x, file_sr = load_mono(f)
        if file_sr != sr:
            x = resample(x, file_sr, sr).astype(np.float64)
        return x

    cafe = load_qut("**/CAFE-CAFE-1.wav")
    car = load_qut("**/CAR-WINDOWNB-1.wav")
    home = load_qut("**/HOME-KITCHEN-1.wav")
    street = load_qut("**/STREET-CITY-1.wav")

    # Remove sweeps in the first and last 2 min of the car noise file
    car = car[120 * sr:-120 * sr]

    noises = [cafe, car, home, street]
    paths = make_split_dirs(args.target)
    np.random.seed(0)

    for split in ("train", "valid", "test"):
        print(f"Create {split} files")
        for speech_file in split_files[split]:
            s, _ = load_mono(speech_file, sr=sr)
            x = mix_at_random_snr(s, noises, min_snr, max_snr)
            file_name = os.path.basename(speech_file)
            write_pair(paths, split, file_name, s, x, sr)


if __name__ == "__main__":
    main()
