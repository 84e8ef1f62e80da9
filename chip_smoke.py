#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``sgmse_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero, and only a run that
passes them all prints the final ``{"ok": true, ...}`` line:

1. card identity (``nvidia-smi`` name and power limit); no CUDA -> fail;
2. build the hand-written kernels from ``sgmse_tpu_torch/csrc``;
3. hold each kernel against its plain PyTorch version at every shape the
   full-width NCSN++ gives it (B=4, F=T=256), in float32 and bfloat16, and
   time both with CUDA events (median of 25 launches);
4. full-width forward (65.59M params, seeded weights) through the kernels and
   through the plain versions: relative error, and the launch counts per
   forward (36 upfirdn2d, 109 group_norm_act);
5. the main path through the entry point ``sgmse_tpu_torch.enhance.main`` on
   four 2.04 s wavs (PC N=30, ald corrector, bf16), with the launch counts of
   that run; then the same path on a short input through the kernels and
   through the plain versions, which must agree.

Details go to ``chiprun_out/chip_smoke.json``.
"""
import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
B, F_BINS, T_FRAMES = 4, 256, 256
WAV_LEN = 32640  # 2.04 s at 16 kHz: 256 STFT frames at hop 128
SEED = 0
REPS = 25
# Tolerances, relative to max|plain| of each comparison.
TOL = {
    # f32: sums of <= 16 taps, or group statistics, in another order.
    ("upfirdn2d", "float32"): 1e-5,
    ("group_norm_act", "float32"): 2e-5,
    # bf16: both round the same float32 value once; they differ where the
    # order of a float32 sum moves it across a rounding boundary: one bf16 step.
    ("upfirdn2d", "bfloat16"): 2.0**-7,
    ("group_norm_act", "bfloat16"): 2.0**-7,
}
FORWARD_TOL = 1e-3     # full f32 forward, kernels vs plain, relative to max|plain|
ENHANCE_TOL = 1e-3     # short f32 enhance, kernels vs plain, relative to max|plain|
PER_FORWARD = {"upfirdn2d": 36, "group_norm_act": 109}
REPLACES = {
    "upfirdn2d": ("sgmse_tpu_torch/csrc/upfirdn2d.cu", "sgmse_tpu/ops/upfirdn2d.py:84"),
    "group_norm_act": ("sgmse_tpu_torch/csrc/group_norm_act.cu",
                       "sgmse_tpu/models/blocks.py:157"),
}


def card_identity() -> str:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is false; this script "
                           "runs only on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    return card


@contextlib.contextmanager
def routed(calls=None, plain=False):
    """Route the network's two kernel dispatchers through a recorder of their
    call signatures (``calls``) and, with ``plain``, to the plain versions."""
    from sgmse_tpu_torch.ops import group_norm as gn
    from sgmse_tpu_torch.ops import upfirdn2d as ufd

    orig_u, orig_g = ufd.upfirdn2d, gn.group_norm_act

    def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
        if calls is not None:
            calls.append(("upfirdn2d", (tuple(x.shape), up, down, tuple(pad),
                                        tuple(np.asarray(kernel, np.float32).ravel()))))
        return (ufd.upfirdn2d_plain if plain else orig_u)(x, kernel, up, down, pad)

    def group_norm_act(x, gamma, beta, num_groups, eps=1e-6, silu=True):
        if calls is not None:
            calls.append(("group_norm_act", (tuple(x.shape), num_groups, eps, bool(silu))))
        return (gn.group_norm_act_plain if plain else orig_g)(x, gamma, beta, num_groups,
                                                              eps, silu)

    ufd.upfirdn2d, gn.group_norm_act = upfirdn2d, group_norm_act
    try:
        yield calls
    finally:
        ufd.upfirdn2d, gn.group_norm_act = orig_u, orig_g


def counters():
    from sgmse_tpu_torch.ops import group_norm as gn
    from sgmse_tpu_torch.ops import upfirdn2d as ufd

    return {"upfirdn2d": ufd.upfirdn2d_cuda.launches,
            "group_norm_act": gn.group_norm_act_cuda.launches}


def reset_counters():
    from sgmse_tpu_torch.ops import group_norm as gn
    from sgmse_tpu_torch.ops import upfirdn2d as ufd

    ufd.upfirdn2d_cuda.launches = 0
    gn.group_norm_act_cuda.launches = 0


def time_ms(fn) -> float:
    """Median of REPS launches, each bracketed by CUDA events, after warm-up."""
    import torch

    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(REPS)]
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def full_model(dev):
    """The default (full-width) ScoreModel with seeded weights. init_scale 1
    instead of the DDPM 0 (1e-10), so that every layer contributes to the output."""
    import torch
    from sgmse_tpu_torch.model import ScoreModel

    model = ScoreModel("ncsnpp", "ouve", init_scale=1.0)
    model.init_params(torch.Generator().manual_seed(SEED))
    return model.to(dev, memory_format=torch.channels_last).eval()


def network_inputs(dev):
    import torch

    rng = np.random.default_rng(SEED)
    shape = (B, 1, F_BINS, T_FRAMES)
    cplx = lambda: (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * 0.3
    x, y = cplx().astype(np.complex64), cplx().astype(np.complex64)
    t = rng.uniform(0.03, 1.0, (B,)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (x, y, t))


def check_kernels(calls, dev):
    """Phase 3: every recorded signature, kernel vs plain, float32 and bfloat16."""
    import torch
    from sgmse_tpu_torch.ops import group_norm as gn
    from sgmse_tpu_torch.ops import upfirdn2d as ufd

    gen = torch.Generator(device=dev).manual_seed(SEED)
    sigs = {}
    for name, sig in calls:
        sigs[(name, sig)] = sigs.get((name, sig), 0) + 1
    rows = []
    for (name, sig), per_forward in sigs.items():
        shape = sig[0]
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            x = x.contiguous(memory_format=torch.channels_last)
            if name == "upfirdn2d":
                _, up, down, pad, taps = sig
                k = np.asarray(taps, np.float32).reshape(4, 4)
                k_dev = torch.from_numpy(k).to(dev)  # no taps copy inside the plain's bracket
                run_k = lambda: ufd.upfirdn2d_cuda(x, k, up, down, pad)
                run_p = lambda: ufd.upfirdn2d_plain(x, k_dev, up, down, pad)
            else:
                _, groups, eps, silu = sig
                c = shape[1]
                gamma = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
                beta = 0.1 * torch.randn(c, generator=gen, device=dev)
                run_k = lambda: gn.group_norm_act_cuda(x, gamma, beta, groups, eps, silu)
                run_p = lambda: gn.group_norm_act_plain(x, gamma, beta, groups, eps, silu)
            got, ref = run_k(), run_p()
            torch.cuda.synchronize()
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError(f"{name} {sig}: kernel gave {tuple(got.shape)} {got.dtype}, "
                                     f"plain {tuple(ref.shape)} {ref.dtype}")
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            tol = TOL[(name, str(dtype).split(".")[-1])] * scale
            label = (f"{shape} up={sig[1]} down={sig[2]} pad={sig[3]}" if name == "upfirdn2d"
                     else f"{shape} groups={sig[1]} silu={sig[3]}")
            row = dict(kernel=name, sig=label, dtype=str(dtype).split(".")[-1],
                       per_forward=per_forward, max_abs_err=err, max_abs_ref=scale, tol=tol)
            if not err <= tol:
                raise AssertionError(f"{name} {sig} {dtype}: max |kernel - plain| {err} > {tol}")
            if dtype == torch.bfloat16:  # the main path's dtype
                row["ms"], row["plain_ms"] = time_ms(run_k), time_ms(run_p)
            rows.append(row)
    return rows


def summarize(rows, launches):
    out = []
    for name in PER_FORWARD:
        mine = [r for r in rows if r["kernel"] == name]
        timed = [r for r in mine if "ms" in r]
        source, replaces = REPLACES[name]
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in mine if r["dtype"] == "float32"),
            max_abs_err_bf16=max(r["max_abs_err"] for r in mine if r["dtype"] == "bfloat16"),
            # per network evaluation: each bf16 shape's median times its calls per forward
            ms=sum(r["ms"] * r["per_forward"] for r in timed),
            plain_ms=sum(r["plain_ms"] * r["per_forward"] for r in timed)))
    return out


def write_wavs(dirname: Path):
    from sgmse_tpu_torch.data.wav import write_wav

    rng = np.random.default_rng(SEED)
    n = np.arange(WAV_LEN) / 16000.0
    for i in range(B):
        f0 = 110.0 + 40.0 * i
        speech = sum(np.sin(2 * np.pi * f0 * h * n) / h for h in range(1, 8))
        speech *= 0.5 * (1.0 + np.sin(2 * np.pi * 3.0 * n))  # syllable-rate envelope
        noisy = 0.2 * speech / np.abs(speech).max() + 0.05 * rng.standard_normal(WAV_LEN)
        write_wav(dirname / f"utt{i}.wav", noisy.astype(np.float32), 16000)


def main():
    card = card_identity()
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    OUT_DIR.mkdir(exist_ok=True)
    report = {"card": card, "device": torch.cuda.get_device_name(0)}

    # --- 2. build -------------------------------------------------------------------------
    from sgmse_tpu_torch import kernels

    t0 = time.time()
    so = kernels.build()
    kernels.lib()
    report["build_s"] = time.time() - t0
    print(f"build: {report['build_s']:.1f} s -> {so.relative_to(ROOT)}")
    (OUT_DIR / "build.log").write_text((so.parent / "build.log").read_text()
                                       if (so.parent / "build.log").exists() else "cached\n")

    # --- 3. kernels vs plain at the main path's shapes ---------------------------------
    model = full_model(dev)
    n_params = sum(p.numel() for p in model.parameters())
    x, y, t = network_inputs(dev)
    with torch.inference_mode():
        with routed(calls=[], plain=True) as calls:
            out_plain = model.dnn(x, y, t)
    rows = check_kernels(calls, dev)
    n_sigs = {k: len({r["sig"] for r in rows if r["kernel"] == k}) for k in PER_FORWARD}
    print(f"kernel checks: {len(rows)} passed over {n_sigs} shapes, tolerances {TOL}")
    for r in rows:
        if "ms" in r:
            print(f"  {r['kernel']:15s} x{r['per_forward']} {r['sig']}: bf16 {r['ms']:.4f} ms "
                  f"(plain {r['plain_ms']:.4f} ms)")
    report["kernel_checks"] = rows

    # --- 4. full-width forward, kernels vs plain -----------------------------------------
    silu_split = [sum(1 for n, s in calls if n == "group_norm_act" and s[3] == flag)
                  for flag in (True, False)]
    before = counters()
    with torch.inference_mode():
        out_kernel = model.dnn(x, y, t)
    torch.cuda.synchronize()
    moved = {k: counters()[k] - before[k] for k in before}
    rel = ((out_kernel - out_plain).abs().max() / out_plain.abs().max()).item()
    print(f"full forward: {n_params} params, B={B} F={F_BINS} T={T_FRAMES} f32, "
          f"kernels vs plain rel err {rel:.3e} (bound {FORWARD_TOL}); launches {moved}, "
          f"group_norm_act with/without SiLU {silu_split}")
    if n_params != 65_590_822:
        raise AssertionError(f"expected the 65.59M-param flagship, got {n_params}")
    if not (torch.isfinite(out_kernel).all() and rel <= FORWARD_TOL):
        raise AssertionError(f"full forward: kernels vs plain rel err {rel} > {FORWARD_TOL}")
    if moved != PER_FORWARD or silu_split != [105, 4]:
        raise AssertionError(f"launches per forward {moved}, SiLU split {silu_split}; "
                             f"expected {PER_FORWARD} and [105, 4]")
    report["forward"] = dict(params=n_params, rel_err=rel, launches=moved, silu_split=silu_split)

    # --- 5. main path through the entry point ------------------------------------------
    from sgmse_tpu_torch import convert, enhance
    from sgmse_tpu_torch.data.wav import read_wav

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "noisy").mkdir()
        write_wavs(tmp / "noisy")
        convert.save_npz(tmp / "weights.npz", convert.jax_tree_from_state_dict(
            model.dnn.state_dict()))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        stats = enhance.main([
            "--test_dir", str(tmp / "noisy"), "--enhanced_dir", str(tmp / "enhanced"),
            "--weights", str(tmp / "weights.npz"), "--batch_size", "4", "--N", "30",
            "--corrector", "ald", "--snr", "0.5", "--precision", "bfloat16", "--timeit"])
        launches = counters()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        outs = sorted((tmp / "enhanced").glob("*.wav"))
        wavs = [read_wav(p)[0][0] for p in outs]
    evals = stats["nfe"] + stats["warmup_nfe"]
    print(f"main path [{card}]: {stats['audio_s_per_wall_s']:.3f} audio-s/wall-s "
          f"(RTF {stats['rtf']:.4f}, wall {stats['wall_s']:.3f} s for {stats['audio_s']:.2f} "
          f"audio-s), NFE {stats['nfe']} (+{stats['warmup_nfe']} warm-up), peak memory "
          f"{peak_gib:.2f} GiB, launches {launches}")
    if len(wavs) != B or any(len(w) != WAV_LEN or not np.isfinite(w).all() for w in wavs):
        raise AssertionError(f"expected {B} finite wavs of {WAV_LEN} samples, got "
                             f"{[len(w) for w in wavs]}")
    if not stats["all_finite"] or stats["nfe"] != 60:
        raise AssertionError(f"main path: finite={stats['all_finite']}, NFE {stats['nfe']}")
    expected = {k: v * evals for k, v in PER_FORWARD.items()}
    if launches != expected:
        raise AssertionError(f"main path launches {launches}, expected {expected}")
    report["main_path"] = dict(stats, peak_gib=peak_gib, launches=launches)

    # The same path on a short input, kernels vs plain, float32.
    short = np.asarray(wavs[0][:16000], np.float32)
    kw = dict(N=5, corrector="ald", snr=0.5)
    got = model.enhance(short, generator=torch.Generator(device=dev).manual_seed(1), **kw)
    with routed(plain=True):
        ref = model.enhance(short, generator=torch.Generator(device=dev).manual_seed(1), **kw)
    rel_e = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"short enhance, kernels vs plain: rel err {rel_e:.3e} (bound {ENHANCE_TOL})")
    if not (np.isfinite(got).all() and rel_e <= ENHANCE_TOL):
        raise AssertionError(f"short enhance: rel err {rel_e} > {ENHANCE_TOL}")
    report["short_enhance_rel_err"] = rel_e

    summary = summarize(rows, launches)
    report["kernels"] = summary
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main()
