"""The per-evaluation breakdown of sgmse_tpu_torch.nfe_profile, on a made-up
trace: overlapping kernels count once towards busy time, gaps are idle."""
import pytest

from sgmse_tpu_torch import nfe_profile


def _kernel(name, ts, dur):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur}


def test_breakdown_merges_intervals_and_sorts_kinds():
    events = [
        {"cat": "cpu_op", "name": "aten::conv2d", "ts": 0.0, "dur": 500.0},
        _kernel("void (anonymous namespace)::gn_act_kernel<__nv_bfloat16>", 0.0, 100.0),
        _kernel("void (anonymous namespace)::upfirdn2d_tile_kernel<float, 1, 2>", 50.0, 100.0),
        _kernel("sm90_xmma_fprop_implicit_gemm_bf16bf16", 300.0, 300.0),
        _kernel("void at::native::vectorized_elementwise_kernel<8, add>", 800.0, 200.0),
    ]
    got = nfe_profile.breakdown(events, evaluations=2)
    # busy: [0, 150] + [300, 600] + [800, 1000] = 650 us over a 1000 us span
    assert got["busy_ms"] == pytest.approx(0.325)
    assert got["span_ms"] == pytest.approx(0.5)
    assert got["idle_share_traced"] == pytest.approx(0.35)
    assert got["launches"] == 2
    assert list(got["kinds"]) == ["convolution (cuDNN)", "elementwise", "K2 group_norm_act",
                                  "K1 upfirdn2d"]
    assert got["kinds"]["K1 upfirdn2d"] == {"ms": pytest.approx(0.05), "launches": 0.5}


def test_breakdown_refuses_a_trace_without_device_work():
    with pytest.raises(ValueError, match="no device kernels"):
        nfe_profile.breakdown([{"cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 1}], 1)


def _on(stream, name, ts, dur):
    return dict(_kernel(name, ts, dur), args={"stream": stream})


def test_stream_overlap_counts_concurrent_streams_and_keyed_kernels():
    events = [
        _on(7, "void (anonymous namespace)::gn_act_kernel<__nv_bfloat16>", 0.0, 100.0),
        _on(9, "sm90_xmma_fprop_implicit_gemm_bf16bf16", 50.0, 100.0),  # overlaps K2
        _on(7, "elementwise", 200.0, 100.0),
        _on(9, "void (anonymous namespace)::gn_act_kernel<__nv_bfloat16>", 400.0, 50.0),  # alone
        _on(9, "elementwise", 450.0, 50.0),
        {"cat": "cpu_op", "name": "aten::add", "ts": 0.0, "dur": 900.0},
    ]
    got = nfe_profile.stream_overlap(events)
    # busy: [0, 150] + [200, 300] + [400, 500] = 350 us; two streams at once on [50, 100]
    assert got["streams"] == 2
    assert got["busy_ms"] == pytest.approx(0.35)
    assert got["concurrent_ms"] == pytest.approx(0.05)
    assert got["concurrent_share"] == pytest.approx(0.05 / 0.35)
    assert (got["keyed"], got["keyed_overlapped"]) == (2, 1)
    assert got["keyed_overlapped_share"] == pytest.approx(0.5)


def test_dcunet_epilogue_bound_counts_each_block_output():
    """The K7 candidate's byte bound: per block, two float32 values read and
    one compute-dtype value written per element of its stacked output."""
    import torch

    from sgmse_tpu_torch.model import ScoreModel

    model = ScoreModel("dcunet", "ouve", dcunet_architecture="DCUNet-10", n_fft=64,
                       precision="bfloat16")
    x = torch.zeros(2, 1, 33, 32, dtype=torch.complex64)
    got = nfe_profile.dcunet_epilogue_bound(model.eval(), x, x, torch.full((2,), 0.5))
    shapes = [(64, 17, 17), (128, 9, 9), (128, 5, 5), (128, 3, 3), (128, 2, 3),
              (128, 3, 3), (128, 5, 5), (128, 9, 9), (64, 17, 17)]  # (B x C, H, W)
    elements = sum(c * h * w for c, h, w in shapes)
    assert got["blocks"] == 9 and got["elements"] == 2 * elements  # [re; im]: 2B rows
    assert got["bytes"] == got["elements"] * (8 + 2)
    assert got["bound_ms"] == got["bytes"] / 3.35e12 * 1e3
