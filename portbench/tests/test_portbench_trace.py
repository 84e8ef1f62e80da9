"""The reading of a device trace (busy time, kinds, launches, idle gaps by
host activity) on a made-up trace, and the kernel-call recorder on the CPU."""
import types

import pytest
import torch

from conftest import tiny

from portbench import trace
from portbench.readers import roofline_pct


class Event:
    def __init__(self, name, start, end, device, span=False):
        self._n, self._s, self._e, self._d, self._span = name, start, end, device, span

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._d else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._span


def fake_prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


def test_analyse_merges_busy_time_and_names_idle_gaps():
    lambda_add = ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl"
                  "<at::native::CUDAFunctor_add<float> >(...)::{lambda(int)#1}>(int, ...)")
    ev = [Event("portbench.window", 1000, 11000, False, span=True),
          Event("portbench.window", 1000, 11000, True, span=True),  # the span's device mirror
          Event("Optimizer.step#Adam.step", 5800, 7200, False, span=True),
          Event("Optimizer.step#Adam.step", 6000, 7000, True),  # its mirror, not flagged
          Event("portbench.loader_wait", 5000, 9000, False, span=True),
          Event("aten::conv2d", 1000, 2000, False),
          Event("void gn_act_kernel<float>(GnArgs)", 1000, 3000, True),
          Event("sm90_xmma_fprop_implicit_gemm_cudnn", 2500, 4000, True),  # overlaps
          Event(lambda_add, 4000, 4500, True),  # a "#" in a kernel's name: still a kernel
          Event("Memcpy HtoD (Pageable -> Device)", 9500, 10000, True),
          Event("void upfirdn2d_tile_kernel<float>", 10000, 10500, True),
          Event("void gn_act_kernel<float>(GnArgs)", 500, 900, True)]  # before the window
    a = trace.analyse(fake_prof(ev))
    assert a["window_s"] == pytest.approx(10000e-9)
    # [1000,4500] + [9500,10500]
    assert a["busy_s"] == pytest.approx((3500 + 1000) * 1e-9)
    assert a["launches"] == 4
    assert a["kinds"]["elementwise"] == dict(seconds=pytest.approx(500e-9), launches=1)
    assert a["kinds"]["K2"] == dict(seconds=pytest.approx(2000e-9), launches=1)
    assert a["kinds"]["convolution"]["launches"] == 1
    assert a["kinds"]["copy/set"]["launches"] == 0
    gaps = dict(a["idle_gaps"])
    # 4500 .. 9500: the optimizer's span is innermost over the gap's middle, 7000
    assert gaps["Optimizer.step#Adam.step"] == pytest.approx(5000e-9)
    assert gaps["(no host event)"] == pytest.approx(500e-9)  # 10500 .. 11000
    assert a["device_ops"][0][0] == "void gn_act_kernel<float>(GnArgs)"


def test_calls_records_every_kernel_call_by_signature():
    from portbench import program

    config, _ = tiny("sgmse-plus-16k.enhance-b16", "bfloat16")
    model = program.score_model(config, "bfloat16", torch.device("cpu")).eval()
    model.dnn.load_state_dict(program.seeded_weights(config, 3, "cpu"))
    x = torch.zeros(2, 1, 32, 64, dtype=torch.complex64)
    calls = trace.Calls()
    with calls.active(), torch.no_grad():
        model(x, x, torch.full((2,), 0.5))
    names = {name for name, _ in calls.counts}
    assert names == {"group_norm_act", "upfirdn2d"}
    gn = [sig for (name, sig), n in calls.counts.items() if name == "group_norm_act"]
    assert all(sig[-1] == "bfloat16" and sig[0][0] == 2 for sig in gn)
    ctx = dict(calls=calls, analysis=dict(kinds={"K2": dict(seconds=1.0, launches=1)}))
    assert 0 < roofline_pct(ctx, ("group_norm_act",), "K2") < 1e-3
    assert roofline_pct(ctx, ("upfirdn2d",), "K1") is None  # no K1 time to read
