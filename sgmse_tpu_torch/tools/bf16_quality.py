"""bfloat16 against float32 end-to-end quality on a trained checkpoint, through
the port's entry point. Counterpart of ``tools/bf16_quality.py``.

    python -m sgmse_tpu_torch.tools.bf16_quality --ckpt DIR --test_dir NOISY \\
        --clean_dir CLEAN [--N 30 --snr 0.5 --batch_size 8 --workdir W]

Enhances the same held-out files with the same checkpoint and the same
sampling seed through ``enhance.main`` twice, with ``--precision float32``
and ``--precision bfloat16``, scores both against clean (PESQ, SI-SDR,
ESTOI) and prints per-file and mean deltas (bf16 - f32). The default workdir
is ``build/bf16_quality`` in the checkout.
"""
from __future__ import annotations

import sys
from argparse import ArgumentParser
from glob import glob
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .. import enhance
from ..data.wav import read_wav
from ..utils.metrics import pesq_wb, si_sdr, stoi

ROOT = Path(__file__).resolve().parents[2]


def run_enhance(ckpt, test_dir, out_dir, args, precision: str, device=None) -> dict:
    argv = ["--test_dir", str(test_dir), "--enhanced_dir", str(out_dir), "--ckpt", str(ckpt),
            "--batch_size", str(args.batch_size), "--N", str(args.N), "--snr", str(args.snr),
            "--seed", "0", "--timeit", "--precision", precision]
    print("+ enhance", " ".join(argv), flush=True)
    return enhance.main(argv, device=device)


def score_files(clean_dir, enhanced_dir) -> Dict[str, tuple]:
    """{file: (PESQ, SI-SDR, ESTOI)} of each enhanced file against its clean one."""
    rows = {}
    for f in sorted(glob(str(Path(clean_dir) / "*.wav"))):
        name = Path(f).name
        x, sr = read_wav(f)
        xh, _ = read_wav(str(Path(enhanced_dir) / name))
        x, xh = x[0], xh[0]
        n = min(len(x), len(xh))
        x, xh = x[:n], xh[:n]
        rows[name] = (pesq_wb(sr, x, xh), si_sdr(x, xh), stoi(x, xh, sr, extended=True))
    return rows


def build_parser() -> ArgumentParser:
    ap = ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--test_dir", required=True)
    ap.add_argument("--clean_dir", required=True)
    ap.add_argument("--N", type=int, default=30)
    ap.add_argument("--snr", type=float, default=0.5)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--workdir", default=str(ROOT / "build" / "bf16_quality"))
    return ap


def main(argv: Optional[List[str]] = None, device=None) -> dict:
    """Run both precisions; returns the per-file scores, the mean scores and
    the mean and largest deltas, with each run's audio-s/wall-s."""
    args = build_parser().parse_args(argv)
    work = Path(args.workdir)
    outs, speed = {}, {}
    for precision in ("float32", "bfloat16"):
        out = work / precision
        stats = run_enhance(args.ckpt, args.test_dir, out, args, precision, device)
        speed[precision] = stats.get("audio_s_per_wall_s")
        outs[precision] = score_files(args.clean_dir, out)

    names = sorted(outs["float32"])
    print("\n| file | PESQ f32 | PESQ bf16 | dPESQ | SI-SDR f32 | SI-SDR bf16 "
          "| dSI-SDR | ESTOI f32 | ESTOI bf16 | dESTOI |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    deltas = []
    for name in names:
        p32, s32, e32 = outs["float32"][name]
        p16, s16, e16 = outs["bfloat16"][name]
        deltas.append((p16 - p32, s16 - s32, e16 - e32))
        print(f"| {name} | {p32:.3f} | {p16:.3f} | {p16-p32:+.3f} "
              f"| {s32:.2f} | {s16:.2f} | {s16-s32:+.2f} "
              f"| {e32:.3f} | {e16:.3f} | {e16-e32:+.3f} |")
    d = np.array(deltas)
    mean = {p: [float(np.mean([outs[p][n][i] for n in names])) for i in range(3)]
            for p in outs}
    print(f"\nmean f32:  PESQ {mean['float32'][0]:.3f}  SI-SDR {mean['float32'][1]:.2f}  "
          f"ESTOI {mean['float32'][2]:.3f}")
    print(f"mean bf16: PESQ {mean['bfloat16'][0]:.3f}  SI-SDR {mean['bfloat16'][1]:.2f}  "
          f"ESTOI {mean['bfloat16'][2]:.3f}")
    print(f"mean delta (bf16 - f32): dPESQ {d[:,0].mean():+.4f} "
          f"(|max| {np.abs(d[:,0]).max():.4f})  dSI-SDR {d[:,1].mean():+.3f} dB "
          f"(|max| {np.abs(d[:,1]).max():.3f})  dESTOI {d[:,2].mean():+.4f} "
          f"(|max| {np.abs(d[:,2]).max():.4f})")
    print(f"n={len(names)} files; audio-s/wall-s f32 {speed['float32']}, bf16 "
          f"{speed['bfloat16']}; verdict bar: |mean dPESQ| << 0.05")
    return dict(files=outs, mean=mean, mean_delta=d.mean(0).tolist(),
                max_abs_delta=np.abs(d).max(0).tolist(), audio_s_per_wall_s=speed)


if __name__ == "__main__":
    main(sys.argv[1:])
