"""Synthesize the WSJ0+CHiME3 training corpus: WSJ0 speech mixed with CHiME3
background noise at SNR ~ U[0, 20] dB. The port's copy of
``preprocessing/create_wsj0_chime3.py``:

    python -m sgmse_tpu_torch.preprocessing.create_wsj0_chime3 <wsj0> <chime3> <target>

The same split globs (si_tr_s / si_dt_05 / si_et_05), same CH1 background noise
selection, same seed (np.random.seed(0)) and draw order, same power-matched
scaling and output layout {target}/{split}/{clean,noisy}/{name}.wav.
"""
import os
from argparse import ArgumentParser
from glob import glob
from typing import List, Optional

import numpy as np

from .mixing import load_mono, make_split_dirs, mix_at_random_snr, write_pair

min_snr = 0
max_snr = 20
sr = 16000


def main(argv: Optional[List[str]] = None):
    parser = ArgumentParser()
    parser.add_argument("wsj0", type=str, help="path to WSJ0 directory")
    parser.add_argument("chime3", type=str, help="path to CHiME3 directory")
    parser.add_argument("target", type=str, help="target path for training files")
    args = parser.parse_args(argv)

    split_files = {
        "train": sorted(glob(args.wsj0 + "**/si_tr_s/**/*.wav", recursive=True)),
        "valid": sorted(glob(args.wsj0 + "**/si_dt_05/**/*.wav", recursive=True)),
        "test": sorted(glob(args.wsj0 + "**/si_et_05/**/*.wav", recursive=True)),
    }

    noise_files = glob(args.chime3 + "**/backgrounds/*.wav", recursive=True)
    noise_files = [f for f in noise_files if f[-7:-4] == "CH1"]

    print("Loading CHiME3 noise files")
    noises = [load_mono(f)[0] for f in noise_files]

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
