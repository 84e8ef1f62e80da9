"""Synthesize the WSJ0-REVERB dereverberation corpus: shoebox-room simulation
with T60 ~ U[0.4, 1.0] s, paired reverb/anechoic signals, t60 & DRR embedded in
the filenames. The port's copy of ``preprocessing/create_wsj0_reverb.py``:

    python -m sgmse_tpu_torch.preprocessing.create_wsj0_reverb --wsj0_dir W --target_dir T

The same seed (100), same T60/dimension ranges, same room-per-sample policy, the
same dry-room trick (absorption 0.99, +0.5 s silence pad), same filename format
`{name}_{room}_{t60:.2f}_{drr:.1f}.wav`, and `unauralized` copies for the test
split. Uses pyroomacoustics when installed; otherwise
falls back to the built-in image-source simulator
(``sgmse_tpu_torch/data/room.py``) with the same sampling distributions.
"""
import os
import shutil
from argparse import ArgumentParser
from glob import glob
from typing import List, Optional

import numpy as np

from ..data.wav import read_wav, write_wav

SEED = 100
T60_RANGE = [0.4, 1.0]
DIM_RANGE = [5, 15, 5, 15, 2, 6]
MIN_DISTANCE_TO_WALL = 1
NB_SAMPLES_PER_ROOM = 1
SAMPLE_RATE = 16000

try:
    import pyroomacoustics as pra
    HAVE_PRA = True
except ImportError:
    from ..data import room as _room
    HAVE_PRA = False


def simulate_pair(room_dim, t60, source_position, mic_position, speech):
    """Return (reverberant, dry, t60_real) single-channel signals."""
    if HAVE_PRA:
        e_absorption, max_order = pra.inverse_sabine(t60, room_dim)
        mic_array = np.asarray(mic_position)[:, None]
        rev_room = pra.ShoeBox(room_dim, fs=SAMPLE_RATE,
                               materials=pra.Material(e_absorption),
                               max_order=min(3, max_order))
        rev_room.set_ray_tracing()
        rev_room.add_microphone_array(mic_array)
        rev_room.add_source(source_position, signal=speech)
        rev_room.compute_rir()
        rev_room.simulate()
        t60_real = float(np.mean(rev_room.measure_rt60()))
        reverberant = np.stack(rev_room.mic_array.signals).swapaxes(0, 1)[:, 0]

        dry_room = pra.ShoeBox(room_dim, fs=SAMPLE_RATE,
                               materials=pra.Material(0.99), max_order=0)
        dry_room.add_microphone_array(mic_array)
        dry_room.add_source(source_position, signal=speech)
        dry_room.compute_rir()
        dry_room.simulate()
        dry = np.stack(dry_room.mic_array.signals).swapaxes(0, 1)[:, 0]
    else:
        e_absorption, max_order = _room.inverse_sabine(t60, room_dim)
        reverberant = _room.simulate(room_dim, e_absorption, source_position,
                                     mic_position, speech, fs=SAMPLE_RATE,
                                     max_order=min(3, max_order))
        rir = _room.shoebox_rir(room_dim, e_absorption, source_position,
                                mic_position, fs=SAMPLE_RATE,
                                max_order=min(3, max_order))
        t60_real = _room.measure_rt60(rir, fs=SAMPLE_RATE)
        dry = _room.simulate(room_dim, 0.99, source_position, mic_position,
                             speech, fs=SAMPLE_RATE, max_order=0)
    return reverberant, dry, t60_real


def main(argv: Optional[List[str]] = None):
    parser = ArgumentParser()
    parser.add_argument("--wsj0_dir", type=str, required=True,
                        help='Path to the WSJ0 directory which should contain subdirectories "si_dt_05", "si_tr_s" and "si_et_05".')
    parser.add_argument("--target_dir", type=str, required=True,
                        help="Path to the target directory for saving WSJ0-REVERB.")
    args = parser.parse_args(argv)

    np.random.seed(SEED)
    splits = ["valid", "train", "test"]
    dic_split = {"valid": "si_dt_05", "train": "si_tr_s", "test": "si_et_05"}
    speech_lists = {
        split: sorted(glob(os.path.join(args.wsj0_dir, dic_split[split]) + "/**/*.wav"))
        for split in splits}

    if os.path.exists(args.target_dir):
        shutil.rmtree(args.target_dir)

    for i_split, split in enumerate(splits):
        print(f"Processing split n° {i_split + 1}: {split}...")
        reverb_dir = os.path.join(args.target_dir, "audio", split, "reverb")
        dry_dir = os.path.join(args.target_dir, "audio", split, "anechoic")
        os.makedirs(reverb_dir, exist_ok=True)
        os.makedirs(dry_dir, exist_ok=True)
        if split == "test":
            unauralized_dir = os.path.join(args.target_dir, "audio", split, "unauralized")
            os.makedirs(unauralized_dir, exist_ok=True)

        speech_list = speech_lists[split]
        for i_sample in range(len(speech_list)):
            if not i_sample % NB_SAMPLES_PER_ROOM:  # generate a new room
                t60 = np.random.uniform(*T60_RANGE)
                room_dim = np.array([np.random.uniform(DIM_RANGE[2 * n], DIM_RANGE[2 * n + 1])
                                     for n in range(3)])
                mic_position = np.array([np.random.uniform(MIN_DISTANCE_TO_WALL,
                                                           room_dim[n] - MIN_DISTANCE_TO_WALL)
                                         for n in range(3)])
                source_position = np.array([np.random.uniform(MIN_DISTANCE_TO_WALL,
                                                              room_dim[n] - MIN_DISTANCE_TO_WALL)
                                            for n in range(3)])

            speech, speech_sr = read_wav(speech_list[i_sample])
            speech = speech[0].astype(np.float64)
            assert speech_sr == SAMPLE_RATE, \
                f"wrong speech sampling rate: expected {SAMPLE_RATE} got {speech_sr}"
            basename = os.path.basename(speech_list[i_sample])[:-4]

            reverberant, dry, t60_real = simulate_pair(
                room_dim, t60, source_position, mic_position, speech)
            # +0.5 s silence after the (very) dry signal so the reverb tail is
            # not cut and both signals share a length.
            dry = np.pad(dry, (0, int(0.5 * SAMPLE_RATE)))

            min_len = min(len(reverberant), len(dry))
            dry = dry[:min_len]
            reverberant = reverberant[:min_len]
            output_scaling = np.max(reverberant) / 0.9

            drr = 10 * np.log10(np.mean(dry**2) / (np.mean(reverberant**2) + 1e-8) + 1e-8)
            out_name = f"{basename}_{i_sample // NB_SAMPLES_PER_ROOM}_{t60_real:.2f}_{drr:.1f}.wav"

            write_wav(os.path.join(dry_dir, out_name),
                      (dry / output_scaling).astype(np.float32), SAMPLE_RATE)
            write_wav(os.path.join(reverb_dir, out_name),
                      (reverberant / output_scaling).astype(np.float32), SAMPLE_RATE)
            if split == "test":
                write_wav(os.path.join(unauralized_dir, out_name),
                          speech.astype(np.float32), SAMPLE_RATE)


if __name__ == "__main__":
    main()
