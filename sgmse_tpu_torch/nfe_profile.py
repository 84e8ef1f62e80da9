"""Where the time of one score-network evaluation, or of one train step, goes
on the card.

    python -m sgmse_tpu_torch.nfe_profile [--backbone ncsnpp_48k|dcunet] [--out DIR]
    python -m sgmse_tpu_torch.nfe_profile --variant 48k_residual [--train --batch 8]
    python -m sgmse_tpu_torch.nfe_profile --train [--backbone dcunet] [--out DIR]

Builds a full-width NCSN++ (seeded weights, bfloat16 compute, channels_last),
or with ``--backbone dcunet`` DilDCUNet-v2 as the JAX training CLI builds it
at n_fft 512 (``DCUNET``), and evaluates it on a (4, 1, F, 256) input (four
2.04-s utterances; F = 256 for the flagship ``ncsnpp``, 768 for
``ncsnpp_48k``, 257 for DCUNet), as one step of the sampler does:

- wall time per evaluation: CUDA events around windows of 20 back-to-back
  evaluations (no synchronisation inside a window, as in the sampler's loop),
  after warm-up; the median of three windows, and all three;
- a ``torch.profiler`` trace of 5 evaluations, from which the device's
  busy time (kernel intervals merged), its idle share over the traced span,
  the kernel launches and the kernel time per kind of op are read.

The trace inflates host time, so the idle share of the traced span is an upper
bound; the busy time against the untraced wall time gives the other reading.
For DCUNet it adds the byte bound of its block epilogues
(``dcunet_epilogue_bound``), the candidate for a fused kernel. ``--variant``
profiles a ``kernel_times.VARIANTS`` net instead (the 48 kHz net with residual
pyramids runs K6, ``csrc/fir_conv.cu``), and with ``--train`` its train step.
Prints one JSON line; writes the trace to ``DIR/nfe_trace.json``.

With ``--train`` the unit is one train step of the backbone (the flagship at
full width, ``ncsnpp_48k`` on the 48 kHz STFT, or DCUNet as above) at the JAX training defaults (B=8 2.04-s crops, or ``--batch``; float32, Adam + EMA,
seeded weights): CUDA events around windows of ``TRAIN_REPS`` steps
(steps/s, samples/s), the peak device memory, and a trace of
``TRAIN_TRACED`` steps (``DIR/train_trace.json``) read the same way.
"""
from __future__ import annotations

import argparse
import bisect
import json
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from .kernel_times import BINS, PEAK_BYTES_PER_S, VARIANTS

BATCH, FRAMES = 4, 256  # the main path's batch of 2.04-s utterances
REPS = 20               # evaluations per timed window
TRACED = 5              # profiled evaluations
TRAIN_BATCH = 8         # the JAX training CLI's default batch (--batch)
TRAIN_REPS = 3          # train steps per timed window
TRAIN_TRACED = 2        # profiled train steps

KINDS = (  # (kind, substrings of the kernel name), first match wins
    ("NCCL collectives", ("nccl",)),
    ("K6 fir_conv", ("fir_conv",)),
    ("K2 group_norm_act", ("gn_act_kernel",)),
    ("K8 residual_merge", ("residual_merge_kernel",)),
    ("K2b group_norm_act_bwd", ("gn_bwd_",)),
    ("K1 upfirdn2d", ("upfirdn2d",)),
    ("convolution (cuDNN)", ("fprop", "dgrad", "wgrad", "nhwcAddPadding", "cudnn", "xmma",
                             "implicit_gemm")),
    ("matmul", ("nvjet", "gemm")),
    ("dtype casts", ("copy_kernel",)),
    ("concat", ("CatArray",)),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)),
)
# The 48 kHz recipe's STFT (the JAX CLI's 48 kHz flags): the 768 bins of
# BINS["ncsnpp_48k"], and train crops of 255 hops of 384 samples.
STFT_48K = dict(n_fft=1534, hop_length=384, spec_factor=0.065, spec_abs_exponent=0.667)
# DilDCUNet-v2 as the JAX training CLI builds it at n_fft 512 (hop 128, 257 frequency
# bins; the CLI's one global time-embedding layer and leaky_relu, bN norms).
DCUNET = dict(n_fft=512, hop_length=128, dcunet_temb_layers_global=1,
              dcunet_activation="leaky_relu")
DCUNET_BINS = 257


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def breakdown(events, evaluations: int) -> dict:
    """Device busy time, idle share and kernel time per kind, per evaluation,
    from the events of a chrome trace (``cat == "kernel"``, times in us)."""
    kernels = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    if not kernels:
        raise ValueError("the trace holds no device kernels")
    busy, cur_start, cur_end = 0.0, None, None
    per_kind: dict = {}
    for e in kernels:
        start, end = e["ts"], e["ts"] + e["dur"]
        if cur_end is None or start > cur_end:
            busy += 0.0 if cur_end is None else cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
        kind = kind_of(e["name"])
        ms, n = per_kind.get(kind, (0.0, 0))
        per_kind[kind] = (ms + e["dur"] / 1000.0, n + 1)
    busy += cur_end - cur_start
    span = max(e["ts"] + e["dur"] for e in kernels) - kernels[0]["ts"]
    return dict(
        busy_ms=busy / 1000.0 / evaluations,
        span_ms=span / 1000.0 / evaluations,
        idle_share_traced=1.0 - busy / span,
        launches=len(kernels) / evaluations,
        kinds={k: dict(ms=ms / evaluations, launches=n / evaluations)
               for k, (ms, n) in sorted(per_kind.items(), key=lambda kv: -kv[1][0])})


def stream_overlap(events, key: str = "gn_act_kernel") -> dict:
    """How the kernels of different CUDA streams overlapped in a chrome trace:
    the busy time, the time during which kernels of two or more streams ran
    at once (and its share of the busy time), and, of the kernels whose name
    holds ``key`` (K2, a cooperative launch), how many ran while a kernel of
    another stream was running. Times in ms."""
    kernels = sorted(((e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("stream", e.get("tid")),
                       e["name"]) for e in events if e.get("cat") == "kernel"),
                     key=lambda k: k[:2])
    if not kernels:
        raise ValueError("the trace holds no device kernels")
    edges = sorted([(s, 1, st) for s, _, st, _ in kernels] + [(e, -1, st) for _, e, st, _ in kernels],
                   key=lambda x: (x[0], x[1]))
    active: dict = {}
    busy = concurrent = 0.0
    last = edges[0][0]
    for t, step, stream in edges:
        running = sum(1 for n in active.values() if n > 0)
        busy += (t - last) if running >= 1 else 0.0
        concurrent += (t - last) if running >= 2 else 0.0
        active[stream] = active.get(stream, 0) + step
        last = t
    starts = [k[0] for k in kernels]
    longest = max(e - s for s, e, _, _ in kernels)
    keyed = [k for k in kernels if key in k[3]]
    overlapped = 0
    for s, e, stream, _ in keyed:
        lo = bisect.bisect_left(starts, s - longest)
        hi = bisect.bisect_left(starts, e)
        overlapped += any(o_st != stream and o_e > s for _, o_e, o_st, _ in kernels[lo:hi])
    return dict(streams=len({k[2] for k in kernels}), busy_ms=busy / 1000.0,
                concurrent_ms=concurrent / 1000.0, concurrent_share=concurrent / busy,
                keyed=len(keyed), keyed_overlapped=overlapped,
                keyed_overlapped_share=overlapped / len(keyed) if keyed else None)


def _card() -> str:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    return card.splitlines()[0] if card else torch.cuda.get_device_name(0)


def dcunet_epilogue_bound(model, x, y, t) -> dict:
    """The byte bound of DCUNet's block epilogues (the K7 candidate: the
    complex recombination of a block's two real convolutions, the
    time-embedding add, the norm in eval mode and the activation) at one
    evaluation of ``model`` (a DCUNet ScoreModel) on (x, y, t): each block
    must read its convolution's float32 output (two values per complex
    output element, the stacked [re; im] of 2B rows) once and write the
    activation once in the compute dtype. Shapes come from forward hooks, so
    it runs on any device."""
    blocks = [m for name, m in model.dnn.named_children() if name[:7] in ("encoder", "decoder")]
    out_bytes = torch.empty((), dtype=model.dnn.compute_dtype or torch.float32).element_size()
    sizes = []
    hooks = [b.register_forward_hook(lambda m, args, out: sizes.append(out.numel()))
             for b in blocks]
    try:
        with torch.inference_mode():
            model(x, y, t)
    finally:
        for h in hooks:
            h.remove()
    n_bytes = sum(n * (2 * 4 + out_bytes) for n in sizes)
    return dict(blocks=len(sizes), elements=sum(sizes), bytes=n_bytes,
                bound_ms=n_bytes / PEAK_BYTES_PER_S * 1e3)


def evaluation_profile(model, x, y, t, out_dir, trace_name: str = "nfe_trace.json") -> dict:
    """Wall ms per evaluation of ``model`` (a ScoreModel on the card) at
    (x, y, t) in windows of ``REPS``, and the device breakdown of a trace of
    ``TRACED`` evaluations, written to ``out_dir/trace_name``."""
    with torch.inference_mode():
        for _ in range(3):
            model(x, y, t)
        times = []
        for _ in range(3):  # windows of back-to-back evaluations, as the sampler runs them
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                model(x, y, t)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / REPS)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(TRACED):
                model(x, y, t)
            torch.cuda.synchronize()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    trace = out / trace_name
    prof.export_chrome_trace(str(trace))
    result = dict(card=_card(), backbone=model.backbone, precision=model.dnn.precision,
                  batch=x.shape[0], bins=x.shape[2], frames=x.shape[3],
                  wall_ms=statistics.median(times), wall_ms_windows=times,
                  **breakdown(json.loads(trace.read_text())["traceEvents"], TRACED))
    result["idle_share_untraced"] = 1.0 - result["busy_ms"] / result["wall_ms"]
    return result


def train_step_profile(model, out_dir, batch: int, seed: int = 0,
                       trace_name: str = "train_trace.json") -> dict:
    """Steps/s, samples/s, peak memory and the device breakdown of train steps
    of ``model`` (a ScoreModel on the card, with its own loss) on a seeded
    batch of ``batch`` crops of ``model.spec.target_len`` samples. In a process
    group the steps average their gradients over the ranks, and the
    all-reduce is the trace's ``NCCL collectives``."""
    from . import train

    dev = model.device
    state = train.create_train_state(model, torch.Generator().manual_seed(seed))
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    shape = (batch, model.spec.target_len)
    x = torch.from_numpy((0.3 * rng.standard_normal(shape)).astype(np.float32)).to(dev)
    y = x + torch.from_numpy((0.1 * rng.standard_normal(shape)).astype(np.float32)).to(dev)
    train.train_step(model, state, x, y, gen)  # warm-up: cuDNN plans, allocator growth
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TRAIN_REPS):
            loss = train.train_step(model, state, x, y, gen)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / TRAIN_REPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(TRAIN_TRACED):
            train.train_step(model, state, x, y, gen)
        torch.cuda.synchronize()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    trace = out / trace_name
    prof.export_chrome_trace(str(trace))
    wall = statistics.median(times)
    result = dict(card=_card(), batch=batch, samples=shape[1],
                  params=sum(p.numel() for p in model.parameters()),
                  precision=model.dnn.precision, wall_ms=wall, wall_ms_windows=times,
                  steps_per_s=1e3 / wall, samples_per_s=batch * 1e3 / wall,
                  peak_gib=peak, last_loss=float(loss),
                  **breakdown(json.loads(trace.read_text())["traceEvents"], TRAIN_TRACED))
    result["idle_share_untraced"] = 1.0 - result["busy_ms"] / wall
    return result


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--backbone", choices=sorted(BINS) + ["dcunet"], default="ncsnpp")
    parser.add_argument("--variant", choices=sorted(VARIANTS), default=None,
                        help="profile this kernel_times.VARIANTS net instead")
    parser.add_argument("--train", action="store_true",
                        help="profile a train step (float32) of the backbone instead")
    parser.add_argument("--batch", type=int, default=TRAIN_BATCH,
                        help="the train step's batch (with --train)")
    parser.add_argument("--out", type=str, default="chiprun_out")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("nfe_profile runs on the card only")
    from .model import ScoreModel

    dev = torch.device("cuda", 0)
    if args.variant:
        args.backbone, variant = VARIANTS[args.variant]
    dcunet = args.backbone == "dcunet"
    settings = DCUNET if dcunet else dict(init_scale=1.0, **(variant if args.variant else {}),
                                          **(STFT_48K if args.backbone == "ncsnpp_48k" else {}))
    if args.train:
        model = ScoreModel(args.backbone, "ouve", **settings).to(
            dev, memory_format=torch.channels_last)
        result = train_step_profile(model, args.out, args.batch)
        print(json.dumps(result))
        return result
    model = ScoreModel(args.backbone, "ouve", precision="bfloat16", **settings)
    model.init_params(torch.Generator().manual_seed(0))
    model = model.to(dev, memory_format=torch.channels_last).eval()
    rng = np.random.default_rng(0)
    shape = (BATCH, 1, DCUNET_BINS if dcunet else BINS[args.backbone], FRAMES)
    x, y = (torch.from_numpy((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                             .astype(np.complex64) * 0.3).to(dev) for _ in range(2))
    t = torch.full((BATCH,), 0.5, device=dev)
    result = evaluation_profile(model, x, y, t, args.out)
    if dcunet:
        result["epilogue_bound"] = dcunet_epilogue_bound(model, x, y, t)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
