#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``sgmse_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero, and only a run that
passes them all prints the final ``{"ok": true, ...}`` line:

1. card identity (``nvidia-smi`` name and power limit); no CUDA -> fail;
2. build the hand-written kernels from ``sgmse_tpu_torch/csrc``;
3. hold each kernel against its plain PyTorch version at every call signature
   the full-width NCSN++ gives it (B=4, F=T=256; group_norm_act with and
   without its pre-bias, upfirdn2d single and paired), in float32 and
   bfloat16; check that group_norm_act repeats bit for bit; check each library
   yardstick against the plain version of the function it computes; then time
   kernel, plain and library in bfloat16 as device time (CUDA graphs of 25
   back-to-back calls, ``sgmse_tpu_torch.kernel_times``) beside each call's
   byte/operation bound;
4. full-width forward (65.59M params, seeded weights) through the kernels and
   through the plain versions: relative error, and the launch counts per
   forward (24 upfirdn2d, 109 group_norm_act);
5. the main path through the entry point ``sgmse_tpu_torch.enhance.main`` on
   four 2.04 s wavs (PC N=30, ald corrector, bf16), with the launch counts of
   that run; then the same path on a short input through the kernels and
   through the plain versions, which must agree.

Details go to ``chiprun_out/chip_smoke.json``.
"""
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
B = 4
WAV_LEN = 32640  # 2.04 s at 16 kHz: 256 STFT frames at hop 128
SEED = 0
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
PER_FORWARD = {"upfirdn2d": 24, "group_norm_act": 109}
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


def as_tuple(r):
    return r if isinstance(r, tuple) else (r,)


def rel_check(what, got, ref, tol_rel):
    """max |got - ref| over the tuple's tensors; raise past tol_rel * max|ref|."""
    got, ref = as_tuple(got), as_tuple(ref)
    for g, r in zip(got, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{what}: gave {tuple(g.shape)} {g.dtype}, plain "
                                 f"{tuple(r.shape)} {r.dtype}")
    err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
    scale = max(r.float().abs().max().item() for r in ref)
    if not err <= tol_rel * scale:
        raise AssertionError(f"{what}: max |diff| {err} > {tol_rel} * {scale}")
    return err, scale


def check_kernels(counts, dev):
    """Phase 3: every recorded signature, kernel vs plain in float32 and
    bfloat16, bit-for-bit repeats of group_norm_act, each library yardstick vs
    the plain version of its function; bf16 device times and bounds."""
    import torch
    from sgmse_tpu_torch import kernel_times as kt

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for (name, sig), per_forward in counts.items():
        for dtype in (torch.float32, torch.bfloat16):
            case = kt.make_case(name, sig, dtype, dev, gen)
            dt = case["dtype"]
            tol = TOL[(name, dt)]
            got, ref = case["kernel"](), case["plain"]()
            torch.cuda.synchronize()
            err, scale = rel_check(f"{name} {case['sig']} {dt}", got, ref, tol)
            if name == "group_norm_act" and not torch.equal(got, case["kernel"]()):
                raise AssertionError(f"{name} {case['sig']} {dt}: two runs differ")
            row = dict(name=name, sig=case["sig"], dtype=dt, per_forward=per_forward,
                       max_abs_err=err, max_abs_ref=scale, tol=tol * scale)
            if "library" in case:
                row["library_err"], _ = rel_check(f"{name} library {case['sig']} {dt}",
                                                  case["library"](), case["library_ref"](), tol)
            if dtype == torch.bfloat16:  # the main path's dtype
                timed = kt.time_case(case)
                row.update({k: timed[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                  "bound_by", "bytes", "ops")})
            rows.append(row)
            del case, got, ref
        torch.cuda.empty_cache()
    return rows


def summarize(rows, launches):
    from sgmse_tpu_torch import kernel_times as kt

    sums = kt.per_nfe([r for r in rows if "ms" in r])
    out = []
    for name in PER_FORWARD:
        mine = [r for r in rows if r["name"] == name]
        source, replaces = REPLACES[name]
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in mine if r["dtype"] == "float32"),
            max_abs_err_bf16=max(r["max_abs_err"] for r in mine if r["dtype"] == "bfloat16"),
            **sums[name]))  # per network evaluation, from the bf16 device times
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
    from sgmse_tpu_torch import kernel_times as kt

    model = kt.full_model(dev)
    n_params = sum(p.numel() for p in model.parameters())
    x, y, t = kt.network_inputs(dev)
    with torch.inference_mode():
        with kt.routed(calls=[], plain=True) as calls:
            out_plain = model.dnn(x, y, t)
    counts = kt.per_forward(calls)
    rows = check_kernels(counts, dev)
    n_sigs = {k: sum(1 for n, _ in counts if n == k) for k in PER_FORWARD}
    print(f"kernel checks: {len(rows)} passed over {n_sigs} call signatures (f32, bf16; "
          f"group_norm_act repeats bit for bit; library yardsticks agree), tolerances {TOL}")
    for r in rows:
        if "ms" in r:
            lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            print(f"  {r['name']:15s} x{r['per_forward']} {r['sig']}: bf16 device "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, library {lib}, "
                  f"bound {r['bound_ms']:.4f} ({r['bound_by']})")
    report["kernel_checks"] = rows

    # --- 4. full-width forward, kernels vs plain -----------------------------------------
    gn_sigs = [s for n, s in calls if n == "group_norm_act"]
    silu_split = [sum(1 for s in gn_sigs if s[3] == flag) for flag in (True, False)]
    with_bias = sum(1 for s in gn_sigs if s[4])
    reset_counters()
    with torch.inference_mode():
        out_kernel = model.dnn(x, y, t)
    torch.cuda.synchronize()
    moved = counters()
    rel = ((out_kernel - out_plain).abs().max() / out_plain.abs().max()).item()
    print(f"full forward: {n_params} params, B={B} F=T={kt.F_BINS} f32, kernels vs plain "
          f"rel err {rel:.3e} (bound {FORWARD_TOL}); launches {moved}, group_norm_act "
          f"with/without SiLU {silu_split}, with the temb pre-bias {with_bias}")
    if n_params != 65_590_822:
        raise AssertionError(f"expected the 65.59M-param flagship, got {n_params}")
    if not (torch.isfinite(out_kernel).all() and rel <= FORWARD_TOL):
        raise AssertionError(f"full forward: kernels vs plain rel err {rel} > {FORWARD_TOL}")
    if moved != PER_FORWARD or silu_split != [105, 4] or with_bias != 49:
        raise AssertionError(f"launches per forward {moved}, SiLU split {silu_split}, "
                             f"pre-bias {with_bias}; expected {PER_FORWARD}, [105, 4], 49")
    report["forward"] = dict(params=n_params, rel_err=rel, launches=moved,
                             silu_split=silu_split, pre_bias=with_bias)

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
    with kt.routed(plain=True):
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
