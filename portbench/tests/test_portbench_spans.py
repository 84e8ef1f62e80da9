"""The attribution of a traced window to the port's spans (``portbench/spans.py``)
on made-up traces: idle cut at span boundaries, busy charged by the launch's
correlation id (from any thread, to the window thread's span), overlaps to the
earliest launch, the sums equal to ``trace.analyse``'s to the nanosecond, and
the blocking runtime calls tallied by span; the cost of a span with no
profiler; then on a real CPU trace of the tiny enhance cell, whose span counts match
the window's."""
import types

import pytest
import torch

from conftest import tiny

from portbench import harness, spans, trace

MAIN, AUTOGRAD = 11, 12  # thread ids


class Event:
    def __init__(self, name, start, end, device=False, span=False, corr=0, tid=MAIN):
        self._n, self._s, self._e, self._d, self._span = name, start, end, device, span
        self._corr, self._tid = corr, tid

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

    def correlation_id(self):
        return self._corr

    def start_thread_id(self):
        return self._tid


def fake_prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


def span(name, start, end, tid=MAIN):
    return Event(name, start, end, span=True, tid=tid)


def kernel(name, start, end, corr, launched, tid=MAIN):
    """A kernel and the runtime call that launched it."""
    return [Event(name, start, end, device=True, corr=corr),
            Event("cudaLaunchKernel", launched, launched + 50, corr=corr, tid=tid)]


def ns(a, name, key):
    return round(a.get(name, {}).get(key, 0.0) * 1e9)


def check_sums(a, prof):
    """Busy over the names is analyse's busy_s, busy plus idle its window_s."""
    old = trace.analyse(prof)
    busy = sum(round(v["busy_s"] * 1e9) for v in a.values())
    idle = sum(round(v["idle_s"] * 1e9) for v in a.values())
    assert busy == round(old["busy_s"] * 1e9)
    assert busy + idle == round(old["window_s"] * 1e9)


def test_idle_is_cut_at_span_boundaries():
    ev = [span("portbench.window", 1000, 11000),
          span("sgmse.sampler", 1000, 9000), span("sgmse.net", 2000, 6000),
          span("sgmse.net", 7000, 8000, tid=AUTOGRAD),  # another thread's: not the timeline
          *kernel("void gn_act_kernel<float>(GnArgs)", 3000, 4000, 7, launched=2500)]
    prof = fake_prof(ev)
    a = spans.attribute(prof)
    assert ns(a, "sgmse.net", "busy_s") == 1000
    assert ns(a, "sgmse.sampler", "idle_s") == 1000 + 3000  # [1000, 2000) and [6000, 9000)
    assert ns(a, "sgmse.net", "idle_s") == 1000 + 2000  # [2000, 3000) and [4000, 6000)
    assert ns(a, spans.OUTSIDE, "idle_s") == 2000  # [9000, 11000)
    assert a["sgmse.net"]["count"] == 1 and a["sgmse.sampler"]["count"] == 1
    assert ns(a, "sgmse.net", "host_s") == 4000
    check_sums(a, prof)


def test_busy_goes_by_correlation_to_the_window_threads_span():
    ev = [span("portbench.window", 0, 10000),
          span("sgmse.train.step", 0, 9000), span("sgmse.train.backward", 2000, 6000),
          span("sgmse.train.optimizer", 6000, 9000),
          # launched from the autograd thread during the backward, run in the optimizer's span
          *kernel("sm90_xmma_wgrad", 6500, 7500, 21, launched=5000, tid=AUTOGRAD),
          # launched in the backward, run on into the optimizer's span
          *kernel("multi_tensor_apply_kernel", 5500, 6200, 22, launched=5400),
          Event("Memcpy HtoD (Pageable -> Device)", 500, 900, device=True, corr=23),
          Event("cudaMemcpyAsync", 100, 200, corr=23),
          Event("aten::copy_", 100, 300, corr=23)]  # a host op of the same number: not a launch
    prof = fake_prof(ev)
    a = spans.attribute(prof)
    assert ns(a, "sgmse.train.backward", "busy_s") == 1000 + 700
    assert ns(a, "sgmse.train.step", "busy_s") == 400  # the copy, launched at 100
    assert ns(a, "sgmse.train.optimizer", "busy_s") == 0
    # idle: [0,500) [900,2000) step; [2000,5500) backward; [6200,6500) [7500,9000) optimizer
    assert ns(a, "sgmse.train.step", "idle_s") == 500 + 1100
    assert ns(a, "sgmse.train.backward", "idle_s") == 3500
    assert ns(a, "sgmse.train.optimizer", "idle_s") == 300 + 1500
    assert ns(a, spans.OUTSIDE, "idle_s") == 1000
    check_sums(a, prof)


def test_overlapping_operations_charge_the_earliest_launch():
    ev = [span("portbench.window", 0, 10000),
          span("sgmse.sampler", 0, 8000), span("sgmse.net", 1000, 3000),
          *kernel("k_net", 3000, 5000, 1, launched=2500),
          *kernel("k_sampler", 4000, 6000, 2, launched=500),  # launched first
          Event("k_no_launch", 7000, 7600, device=True),  # no runtime call: at its own start
          Event("gn_act_kernel", 9000, 12000, device=True, corr=3)]  # past the window: left out
    prof = fake_prof(ev)
    a = spans.attribute(prof)
    assert ns(a, "sgmse.net", "busy_s") == 1000  # [3000, 4000)
    assert ns(a, "sgmse.sampler", "busy_s") == 2000 + 600  # [4000, 6000) and k_no_launch
    check_sums(a, prof)


def test_sums_hold_on_analyses_own_made_up_trace():
    """The events of ``test_portbench_trace``'s reading, span mirrors and a
    kernel before the window included, with spans and launches added."""
    ev = [span("portbench.window", 1000, 11000),
          Event("portbench.window", 1000, 11000, device=True, span=True),
          span("Optimizer.step#Adam.step", 5800, 7200),
          Event("Optimizer.step#Adam.step", 6000, 7000, device=True),
          span("portbench.loader_wait", 5000, 9000), span("sgmse.data.wait", 5100, 8900),
          Event("aten::conv2d", 1000, 2000),
          *kernel("void gn_act_kernel<float>(GnArgs)", 1000, 3000, 1, launched=950),
          *kernel("sm90_xmma_fprop_implicit_gemm_cudnn", 2500, 4000, 2, launched=990),
          *kernel("elementwise_kernel", 4000, 4500, 3, launched=1200),
          Event("Memcpy HtoD (Pageable -> Device)", 9500, 10000, device=True),
          Event("void upfirdn2d_tile_kernel<float>", 10000, 10500, device=True),
          Event("void gn_act_kernel<float>(GnArgs)", 500, 900, device=True)]
    prof = fake_prof(ev)
    a = spans.attribute(prof)
    check_sums(a, prof)
    assert ns(a, "sgmse.data.wait", "idle_s") == 8900 - 5100
    assert ns(a, spans.OUTSIDE, "busy_s") == 3500 + 1000
    m = spans.metrics(a, dict(steps=2))
    assert m["train.loader_idle_ms_per_step"] == pytest.approx(3800e-9 * 1e3 / 2)
    assert m["train.data_wait_ms_per_step"] == pytest.approx(3800e-9 * 1e3 / 2)
    assert m["train.backward_idle_ms_per_step"] == 0.0


def test_blocking_calls_are_tallied_by_span():
    ev = [span("portbench.window", 0, 10000),
          span("sgmse.sampler.step", 0, 5000), span("sgmse.net", 5000, 9000),
          Event("cudaStreamSynchronize", 1000, 3000, corr=5),
          Event("cudaMemcpyAsync", 500, 600, corr=6),  # pageable: the host waits it out
          Event("Memcpy HtoD (Pageable -> Device)", 600, 700, device=True, corr=6),
          Event("cudaMemcpyAsync", 5100, 5200, corr=7),  # pinned: it does not block
          Event("Memcpy HtoD (Pinned -> Device)", 5200, 5300, device=True, corr=7),
          Event("cudaDeviceSynchronize", 6000, 6500, corr=8, tid=AUTOGRAD),
          *kernel("gn_act_kernel", 5300, 5900, 9, launched=5250),  # a launch does not block
          Event("cudaStreamSynchronize", 10500, 11000, corr=10)]  # past the window
    prof = fake_prof(ev)
    a = spans.attribute(prof)
    assert ns(a, "sgmse.sampler.step", "blocking_s") == 2000 + 100
    assert a["sgmse.sampler.step"]["blocking"] == 2
    assert ns(a, "sgmse.net", "blocking_s") == 500 and a["sgmse.net"]["blocking"] == 1
    assert a[spans.OUTSIDE]["blocking"] == 0
    assert "blocked s" in spans.table(a).splitlines()[0]
    check_sums(a, prof)


def test_a_span_costs_one_check_with_no_profiler():
    cost = spans.gate_cost(calls=2000, repeats=3)
    assert set(cost) == {"check_us", "span_us", "record_function_us", "empty_with_us"}
    assert all(len(v) == 3 and all(x > 0 for x in v) for v in cost.values())
    assert min(cost["span_us"]) < min(cost["record_function_us"])


def test_metrics_need_their_units():
    a = {"sgmse.net": dict(busy_s=1.0, idle_s=0.5, host_s=2.0, count=10),
         "sgmse.sampler.step": dict(busy_s=0.2, idle_s=0.1, host_s=0.4, count=5)}
    m = spans.metrics(a, dict(nfe=10, batches=1))
    assert m["enhance.net_idle_ms_per_nfe"] == pytest.approx(50.0)
    assert m["enhance.sampler_ms_per_step"] is None  # no sampler_steps in the window
    assert m["enhance.prep_ms_per_batch"] == 0.0
    assert set(spans.metrics(a, {})) == set()


def test_a_real_cpu_trace_of_the_tiny_enhance_cell():
    config, cell = tiny("sgmse-plus-16k.enhance-b16")
    run = harness.driver(cell["driver"]).Run(config, cell, 5, torch.device("cpu"))
    run.setup()
    with trace.profile() as prof:
        with torch.profiler.record_function("portbench.window"):
            window = run.window(0.0, traced=True)
    a = spans.attribute(prof)
    check_sums(a, prof)
    window["sampler_steps"] = config["sde_params"]["N"] * window["batches"]
    assert all(got == want for got, want in spans.counts(a, window).values()), \
        spans.counts(a, window)
    assert a["sgmse.net"]["count"] == window["nfe"] > 0
    m = spans.metrics(a, window)
    assert all(v is not None and v >= 0 for v in m.values()) and len(m) == 4
