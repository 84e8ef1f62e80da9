"""The 48 kHz network and the long-recording path against the benchmark's
plain reference (``portbench/reference/nets48k.py``, ``enhance_long.py``),
on the CPU at a tiny width with seeded weights; ``enhance_long``'s counter
(``model.LONG_SERVED``) against the shapes' arithmetic, and its spans."""
import collections

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.reference import enhance_long as ref_long
from portbench.reference import lowp, nets48k
from portbench.reference import sdes as ref_sdes
from sgmse_tpu_torch import model as port_model
from sgmse_tpu_torch.dsp import pad_spec
from sgmse_tpu_torch.model import ScoreModel
from sgmse_tpu_torch.utils import profiling

NET = dict(nf=16, ch_mult=[1, 2, 2], num_res_blocks=1, fir_kernel=[1, 3, 3, 1])
STFT = dict(n_fft=62, hop_length=16, spec_factor=0.065, spec_abs_exponent=0.667, num_frames=64)
SDE = dict(theta=2.0, sigma_min=0.1, sigma_max=1.0, N=2)
SR = 16000
CHUNK_SECONDS, OVERLAP = 0.06, 0.1  # 960-sample chunks, 864 apart: 61 frames, padded to 64


def config():
    return dict(backbone="ncsnpp_48k", sde="ouve", sr=SR, network=dict(NET), stft=dict(STFT),
                sde_params=dict(SDE), t_eps=0.03,
                sampler=dict(type="pc", predictor="reverse_diffusion", corrector="ald",
                             corrector_steps=1, snr=0.5, pad_mode="reflection"))


def models(seed=5):
    """(port ScoreModel in float32, plain reference net), one seeded state dict."""
    cfg = config()
    ref = nets48k.build(cfg)
    state = weights.make(ref, seed, torch.device("cpu"), state_input_scale=0.1)
    ref.load_state_dict(state)
    port = ScoreModel("ncsnpp_48k", "ouve", sr=SR, t_eps=0.03, **NET, **STFT, **SDE)
    port.dnn.load_state_dict(state)
    return port.eval(), ref


def test_ncsnpp_48k_forward_matches_the_plain_reference():
    port, ref = models()
    gen = torch.Generator().manual_seed(3)
    x, y = (ref_sdes.crandn((2, 1, 32, 64), gen) for _ in range(2))
    t = torch.tensor([0.05, 0.7])
    with torch.no_grad(), lowp.strict_f32():
        got, want = port.dnn(x, y, t), ref(x, y, t)
    # Both float32 on the CPU; they differ only in the order of sums (channels_last
    # convolutions, the GroupNorm's statistics, the FIR taps), which leaves ~1e-6 of
    # the output's scale over ~60 layers: 1e-4 of it is round-off, not mathematics.
    assert got.shape == want.shape == (2, 1, 32, 64)
    err = (got - want).abs().max() / want.abs().max()
    assert err < 1e-4, err


def test_enhance_long_matches_the_plain_reference_chunk_for_chunk():
    port, ref = models()
    cfg = config()
    rng = np.random.default_rng(0)
    y = (0.3 * rng.standard_normal(2300)).astype(np.float32)  # 3 chunks, the last padded
    chunk, hop, n = ref_long.grid(len(y), SR, CHUNK_SECONDS, OVERLAP)
    assert n == 3 and (n - 1) * hop + chunk > len(y)
    shape = (1, 1, STFT["n_fft"] // 2 + 1, 64)
    gen = torch.Generator().manual_seed(11)
    noises = [(ref_sdes.crandn((SDE["N"] + 1, *shape), gen),
               ref_sdes.crandn((SDE["N"], 1, *shape), gen)) for _ in range(n)]
    handed = iter(noises)

    def enhance(seg, **kw):  # each chunk's noise, as the benchmark hands it over
        prior, corr = next(handed)
        return port.enhance(seg, prior_noise=prior, corrector_noise=corr, **kw)

    got, nfe, _ = port.enhance_long(y, chunk_seconds=CHUNK_SECONDS, overlap=OVERLAP,
                                    timeit=True, enhance=enhance, N=SDE["N"],
                                    pad_mode="reflection")
    with lowp.strict_f32():
        want = ref_long.enhance_long(cfg, ref, ref_sdes.build(cfg), torch.as_tensor(y), noises,
                                     CHUNK_SECONDS, OVERLAP).numpy()
        first = ref_long.enhance_long(cfg, ref, ref_sdes.build(cfg), torch.as_tensor(y),
                                      noises[:2], CHUNK_SECONDS, OVERLAP).numpy()
    assert nfe == n * 2 * SDE["N"] and got.shape == want.shape == y.shape
    # float32 on both sides through 12 network evaluations; the sampler's map at
    # these seeded weights passes round-off on at about its own size.
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()
    # two chunks alone determine the samples before the third starts
    assert first.shape == (2 * hop,)
    np.testing.assert_array_equal(first, want[:2 * hop])


def _fake_enhance(seg, **kw):
    return np.zeros_like(seg), 0, 0.0


@pytest.mark.parametrize("length,chunks,chunk", [(700, 1, 700), (2300, 3, 960)])
def test_long_served_counts_the_shapes(length, chunks, chunk):
    """A recording shorter than a chunk is one chunk of its own length; a longer
    one needs a padded last chunk. Enhanced samples: the frames ``enhance``'s
    prep hands the sampler (chunks x frames padded to 64) x hop."""
    port, _ = models()
    received = []

    def enhance(seg, **kw):  # the frames enhance's prep would hand its sampler
        y = torch.as_tensor(seg)[None]
        received.append(pad_spec(port.spec.wav_to_spec(y)[:, None], mode="reflection").shape[-1])
        return _fake_enhance(seg)

    before = dict(port_model.LONG_SERVED)
    port.enhance_long(np.zeros(length, np.float32), chunk_seconds=CHUNK_SECONDS,
                      overlap=OVERLAP, enhance=enhance)
    frames = chunk // STFT["hop_length"] + 1  # the centred STFT of an even n_fft
    assert received == [-(-frames // 64) * 64] * chunks
    delta = {k: port_model.LONG_SERVED[k] - before[k] for k in before}
    assert delta == dict(calls=1, chunks=chunks, input_samples=length,
                         enhanced_samples=sum(received) * STFT["hop_length"])


def test_long_spans_under_a_profiler_and_one_no_op_without(monkeypatch):
    port, _ = models()
    y = np.zeros(2300, np.float32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        port.enhance_long(y, chunk_seconds=CHUNK_SECONDS, overlap=OVERLAP, enhance=_fake_enhance)
    spans = sorted((e.start_ns(), e.end_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("sgmse.enhance.long"))
    names = collections.Counter(n for _, _, n in spans)
    assert names == {"sgmse.enhance.long": 1, "sgmse.enhance.long.merge": 3}
    (lo, hi, _), merges = spans[0], spans[1:]
    assert all(lo <= s <= e <= hi for s, e, _ in merges)

    def record_function(name):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    assert profiling.span("enhance.long") is profiling.span("enhance.long.merge")
    port.enhance_long(y, chunk_seconds=CHUNK_SECONDS, overlap=OVERLAP, enhance=_fake_enhance)


def test_warm_up_in_chunks_runs_each_shape_through_enhance_long():
    """``enhance.warm_up`` with ``chunk_seconds`` runs each shape as one chunk of
    ``enhance_long`` (where a card's CUDA graphs are captured); on the CPU the
    samplers evaluate the plain forward there too, and the result is the
    plain path's."""
    from sgmse_tpu_torch import enhance

    port, _ = models()
    used, score_fn = [], port.score_fn
    port.score_fn = lambda: used.append(score_fn()) or used[-1]
    before = port_model.LONG_SERVED["calls"]
    nfe = enhance.warm_up(port, {(700,), (960,)}, torch.Generator().manual_seed(0),
                          dict(N=SDE["N"], pad_mode="reflection"), CHUNK_SECONDS)
    assert port_model.LONG_SERVED["calls"] - before == 2 and nfe == 2 * 2
    assert used == [port.forward] * 2
    y = np.zeros(960, np.float32)
    short = dict(N=1, pad_mode="reflection", sde=port.sde)
    np.testing.assert_array_equal(
        port.enhance_long(y, chunk_seconds=CHUNK_SECONDS, **short),
        port.enhance(y, generator=torch.Generator().manual_seed(0), **short))
