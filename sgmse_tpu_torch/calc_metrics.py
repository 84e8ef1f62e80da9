"""Metrics entry point: PESQ / ESTOI / SI-SDR(-SIR/-SAR) of enhanced files
against their clean references. Counterpart of ``cli/calc_metrics.py``.

    python -m sgmse_tpu_torch.calc_metrics --clean_dir C --noisy_dir N --enhanced_dir E

The same flags, the same rule for a noisy file named with an SNR
(``u440c020_5dB.wav``: the clean file is the name up to its first underscore,
``u440c020.wav``), the same columns, and the same two files in ``--enhanced_dir``:
``_results.csv`` (one row per file, written with the ``csv`` module in
``DataFrame.to_csv``'s column order and float format: the shortest repr,
NaN as an empty field) and ``_avg_results.txt`` (mean ± std lines). Where
the built-in P.862 scored PESQ, a ``pesq_impl`` column and a footnote say
so. Host-only numpy; no device, and no pandas.
"""
from __future__ import annotations

import argparse
import csv
import math
from glob import glob
from os.path import join
from typing import Dict, List, Optional

import numpy as np

from .data.wav import read_wav, resample
from .utils.metrics import energy_ratios, mean_std, pesq_impl, pesq_wb, stoi

COLUMNS = ("filename", "pesq", "estoi", "si_sdr", "si_sir", "si_sar")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--clean_dir", type=str, required=True,
                        help="Directory containing the clean data")
    parser.add_argument("--noisy_dir", type=str, required=True,
                        help="Directory containing the noisy data")
    parser.add_argument("--enhanced_dir", type=str, required=True,
                        help="Directory containing the enhanced data")
    return parser


def clean_name(filename: str) -> str:
    """The clean file of a noisy one: a name with ``dB`` in it keeps what comes
    before its first underscore (``u440c020_5dB.wav`` -> ``u440c020.wav``)."""
    return filename.split("_")[0] + ".wav" if "dB" in filename else filename


def _csv_field(value) -> str:
    if isinstance(value, str):
        return value
    value = float(value)
    return "" if math.isnan(value) else repr(value)


def summary_lines(data: Dict[str, list], avg_file: bool) -> List[str]:
    """The mean ± std lines: as printed, or (``avg_file``) as written to
    ``_avg_results.txt``, whose SI-SDR std has two decimals."""
    stat = {k: mean_std(np.asarray(data[k], dtype=np.float64)) for k in COLUMNS[1:]}
    return ["PESQ: {:.2f} ± {:.2f}".format(*stat["pesq"]),
            "ESTOI: {:.2f} ± {:.2f}".format(*stat["estoi"]),
            ("SI-SDR: {:.1f} ± {:.2f}" if avg_file else "SI-SDR: {:.1f} ± {:.1f}").format(
                *stat["si_sdr"]),
            "SI-SIR: {:.1f} ± {:.1f}".format(*stat["si_sir"]),
            "SI-SAR: {:.1f} ± {:.1f}".format(*stat["si_sar"])]


def main(argv: Optional[List[str]] = None) -> Dict[str, list]:
    """Score every wav of ``--noisy_dir`` (and its subdirectories), write the
    two result files and return the per-file columns."""
    args = build_parser().parse_args(argv)
    data: Dict[str, list] = {k: [] for k in COLUMNS}
    noisy_files = sorted(glob(join(args.noisy_dir, "*.wav")))
    noisy_files += sorted(glob(join(args.noisy_dir, "**", "*.wav")))
    for noisy_file in noisy_files:
        filename = noisy_file.replace(args.noisy_dir, "")[1:]
        x, sr_x = read_wav(join(args.clean_dir, clean_name(filename)))
        y, sr_y = read_wav(join(args.noisy_dir, filename))
        x_hat, sr_x_hat = read_wav(join(args.enhanced_dir, filename))
        assert sr_x == sr_y == sr_x_hat
        x, y, x_hat = x[0].astype(np.float64), y[0].astype(np.float64), x_hat[0].astype(np.float64)
        n = y - x
        x_hat_16k = resample(x_hat, sr_x_hat, 16000) if sr_x_hat != 16000 else x_hat
        x_16k = resample(x, sr_x, 16000) if sr_x != 16000 else x
        si_sdr_, si_sir, si_sar = energy_ratios(x_hat, x, n)
        for key, value in zip(COLUMNS, (filename, pesq_wb(16000, x_16k, x_hat_16k, "wb"),
                                        stoi(x, x_hat, sr_x, extended=True), si_sdr_, si_sir,
                                        si_sar)):
            data[key].append(value)

    # Provenance: where the built-in (non-conformance) scorer produced the pesq
    # column, the artifacts say so.
    impl = pesq_impl()
    if impl != "pesq-conformance":
        data["pesq_impl"] = [impl] * len(data["filename"])

    for line in summary_lines(data, avg_file=False):
        print(line)
    with open(join(args.enhanced_dir, "_avg_results.txt"), "w") as log:
        for line in summary_lines(data, avg_file=True):
            log.write(line + "\n")
        if impl != "pesq-conformance":
            log.write(f"# pesq scored by {impl} (rank-faithful, NOT "
                      "ITU-conformance-certified; install `pesq` for certified numbers)\n")
    with open(join(args.enhanced_dir, "_results.csv"), "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(list(data))
        for row in zip(*data.values()):
            writer.writerow([_csv_field(v) for v in row])
    return data


if __name__ == "__main__":
    main()
