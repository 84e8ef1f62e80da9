"""Enhancement quality against the number of network evaluations (NFE) on a
trained checkpoint, through the port's entry point. Counterpart of
``tools/quality_vs_nfe.py``.

    python -m sgmse_tpu_torch.tools.quality_vs_nfe --ckpt DIR --test_dir NOISY \\
        --clean_dir CLEAN [--snr 0.33 --batch_size 4 --workdir W]

Each configuration runs ``enhance.main`` with ``--timeit``: the PC sampler at
N = 30, 20, 10 and 5 (+ ald, ``--snr``), and the adaptive rk45
probability-flow ODE (NFE set by its step control; the corrector does not
apply). Each is scored against the clean files (PESQ, SI-SDR, ESTOI, mean ±
std), and one markdown table gives NFE per batch, audio-s/wall-s and the
scores. The default workdir is ``build/quality_vs_nfe`` in the checkout.
"""
from __future__ import annotations

import re
import sys
from argparse import ArgumentParser
from glob import glob
from pathlib import Path
from typing import List, Optional

import numpy as np

from .. import enhance
from ..data.wav import read_wav
from ..utils.metrics import mean_std, pesq_wb, si_sdr, stoi

ROOT = Path(__file__).resolve().parents[2]


def run_enhance(ckpt, test_dir, out_dir, batch_size, extra, device=None) -> dict:
    argv = ["--test_dir", str(test_dir), "--enhanced_dir", str(out_dir), "--ckpt", str(ckpt),
            "--batch_size", str(batch_size), "--timeit", *map(str, extra)]
    print("+ enhance", " ".join(argv), flush=True)
    return enhance.main(argv, device=device)


def score(clean_dir, enhanced_dir):
    """(mean, std) of PESQ, SI-SDR and ESTOI over the files of ``clean_dir``."""
    p, s, e = [], [], []
    for f in sorted(glob(str(Path(clean_dir) / "*.wav"))):
        x, sr = read_wav(f)
        xh, _ = read_wav(str(Path(enhanced_dir) / Path(f).name))
        x, xh = x[0], xh[0]
        n = min(len(x), len(xh))
        x, xh = x[:n], xh[:n]
        p.append(pesq_wb(sr, x, xh))
        s.append(si_sdr(x, xh))
        e.append(stoi(x, xh, sr, extended=True))
    return tuple(tuple(float(v) for v in mean_std(np.array(m))) for m in (p, s, e))


def build_parser() -> ArgumentParser:
    ap = ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--test_dir", required=True)
    ap.add_argument("--clean_dir", required=True)
    ap.add_argument("--snr", type=float, default=0.33,
                    help="PC corrector SNR (0.33: the dereverberation recipe's)")
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--workdir", default=str(ROOT / "build" / "quality_vs_nfe"))
    return ap


def configs(snr: float, pc_n=(30, 20, 10, 5), ode: bool = True):
    """(name, enhance flags) of each configuration of the sweep."""
    return ([(f"pc N={n}", ["--N", n, "--snr", snr]) for n in pc_n]
            + ([("ode rk45", ["--sampler_type", "ode"])] if ode else []))


def main(argv: Optional[List[str]] = None, device=None, pc_n=(30, 20, 10, 5),
         ode: bool = True) -> list:
    """Run the sweep; returns its rows. ``pc_n`` (the PC sampler's N) and
    ``ode`` are Python-API hooks of the tests: rk45 on an untrained net is
    stiff and takes thousands of evaluations."""
    args = build_parser().parse_args(argv)
    work = Path(args.workdir)
    rows = []
    for name, extra in configs(args.snr, pc_n, ode):
        out = work / re.sub(r"\W+", "_", name)
        stats = run_enhance(args.ckpt, args.test_dir, out, args.batch_size, extra, device)
        (pm, ps), (sm, ss), (em, es) = score(args.clean_dir, out)
        row = dict(name=name, nfe=stats["nfe"] / stats["batches"],
                   audio_s_per_wall_s=stats.get("audio_s_per_wall_s"), pesq=(pm, ps),
                   si_sdr=(sm, ss), estoi=(em, es))
        rows.append(row)
        print(f"{name}: NFE {row['nfe']:.1f}, {row['audio_s_per_wall_s']:.3f} audio-s/wall-s, "
              f"pesq {pm:.3f}±{ps:.3f}  si_sdr {sm:.2f}±{ss:.2f}  estoi {em:.3f}±{es:.3f}",
              flush=True)

    noisy = score(args.clean_dir, args.test_dir)
    (pm, ps), (sm, ss), (em, es) = noisy
    print(f"\nnoisy input: pesq {pm:.3f}±{ps:.3f}  si_sdr {sm:.2f}±{ss:.2f}  "
          f"estoi {em:.3f}±{es:.3f}\n")
    print("| sampler | NFE per batch | audio-s/wall-s | PESQ | SI-SDR dB | ESTOI |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        (pm, ps), (sm, ss), (em, es) = r["pesq"], r["si_sdr"], r["estoi"]
        print(f"| {r['name']} | {r['nfe']:.1f} | {r['audio_s_per_wall_s']:.3f} "
              f"| {pm:.2f}±{ps:.2f} | {sm:.1f}±{ss:.1f} | {em:.2f}±{es:.2f} |")
    rows.append(dict(name="noisy input", pesq=noisy[0], si_sdr=noisy[1], estoi=noisy[2]))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
