"""``chip_smoke.py``'s torch.profiler readers on the CPU, with a stand-in profiler.

On the H100 CUPTI now and then keeps no device record for a while. The readers
take such a trace again after a pause, and where every trace is lost
:func:`chip_smoke.device_ms` times the call with CUDA events instead while
:func:`chip_smoke.device_launch_ms` and :func:`chip_smoke.profile_device`
give None for what they cannot see; none of them raises. The stand-in yields
the traces a test gives it, in turn; pauses and CUDA calls are stubbed.
"""

import contextlib
import types

import pytest
import torch

import chip_smoke

CUDA = torch.autograd.DeviceType.CUDA


def _event(name: str, start: float, us: float, device=CUDA):
    span = types.SimpleNamespace(start=start, elapsed_us=lambda: us)
    return types.SimpleNamespace(name=name, device_type=device, time_range=span, kernels=[], input_shapes=[])


@pytest.fixture
def traces(monkeypatch):
    """Set the list of traces (each a list of events) the stand-in profiler yields;
    returns it and the pauses taken."""
    queue, pauses = [], []

    @contextlib.contextmanager
    def profile(**_):
        events = queue.pop(0) if queue else []
        yield types.SimpleNamespace(events=lambda: events)

    class Event:
        def __init__(self, **_):
            pass

        def record(self):
            pass

        def elapsed_time(self, _):
            return 12.0

    monkeypatch.setattr(torch.profiler, "profile", profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(chip_smoke.time, "sleep", pauses.append)
    monkeypatch.setattr(chip_smoke, "log", lambda *a: None)
    return queue, pauses


def test_device_ms_takes_a_lost_trace_again(traces):
    queue, pauses = traces
    queue.extend([[], [_event("cpu op", 0, 99.0, device=torch.autograd.DeviceType.CPU)],
                  [_event("k", 0, 1000.0), _event("k", 5, 3000.0), _event("k", 9, 2000.0)]])
    assert chip_smoke.device_ms(lambda: None, iters=3) == pytest.approx(2.0)
    assert pauses == [chip_smoke.PROFILER_PAUSE_S, 2 * chip_smoke.PROFILER_PAUSE_S]


def test_device_ms_falls_back_to_cuda_events(traces):
    queue, pauses = traces
    calls = []
    assert chip_smoke.device_ms(lambda: calls.append(1), iters=3, traces=4) == pytest.approx(12.0 / 3)
    assert len(pauses) == 3 and max(pauses) <= chip_smoke.PROFILER_PAUSE_MAX_S
    assert len(calls) == 1 + 4 * 3 + 3 + 1  # warm-up, the traces, time_ms's warm-up and its calls


def test_device_launch_ms_waits_for_a_whole_trace(traces):
    queue, pauses = traces
    whole = [_event("copy_kernel", 0, 1000.0), _event("gemm_kernel", 1, 4000.0),
             _event("copy_kernel", 2, 3000.0), _event("gemm_kernel", 3, 6000.0)]
    queue.extend([whole[:3], whole])
    assert chip_smoke.device_launch_ms(lambda: None, ("copy", "gemm"), iters=2) == pytest.approx([2.0, 5.0])
    assert len(pauses) == 1


def test_device_launch_ms_gives_none_where_every_trace_is_lost(traces):
    queue, _ = traces
    assert chip_smoke.device_launch_ms(lambda: None, ("copy", "gemm"), traces=3) == [None, None]
    assert chip_smoke.per_flop_rate(1e9, None) is None
    assert chip_smoke.per_flop_rate(2e9, 2.0) == pytest.approx(1.0)


def test_profile_device_takes_a_lost_trace_again(traces):
    queue, pauses = traces
    queue.extend([[], [_event("k", 0, 6000.0)]])
    out = chip_smoke.profile_device("t", lambda: None, 10.0, passes=2)
    assert out["device_busy_ms_per_run"] == pytest.approx(3.0) and out["device_ops_per_run"] == 0.5
    assert out["idle_share_vs_median"] == pytest.approx(0.7) and len(pauses) == 1


def test_profile_device_gives_none_where_every_trace_is_lost(traces):
    _, pauses = traces
    out = chip_smoke.profile_device("t", lambda: None, 10.0, passes=2)
    assert out == {"device_busy_ms_per_run": None, "device_ops_per_run": None, "idle_share_vs_median": None}
    assert len(pauses) == chip_smoke.PROFILER_TRACES - 1
