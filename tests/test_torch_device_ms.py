"""``chip_smoke.device_ms``'s rule for profiler traces that lost records,
on recorded trace dictionaries and on a scripted profiler (CPU only).

A trace is ``{kernel name: (records, summed µs)}`` over ``reps`` equal
calls. For a call of one kernel whose CUDA-event time (``cuda_ms``, an
upper bound on its device time) is at least
``TRACE_EVENTS_FLOOR_MS``, a reading between ``TRACE_HOST_BOUND_SHARE``
and ``TRACE_SHARE_OF_EVENTS`` of that time is set aside and another trace
taken: two traces that lost the same half of their records agree with
each other, and must not be taken. Below the lower share the host sets the
event time, and the reading stands.

Where every trace lost the same share of a call's records, the call's
launches come from sources that lose none (the wrappers' counters, the
runtime records on the host), and each kernel's count is raised to them.
"""
import json
import sys

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from tests.test_torch_slice import REPO

sys.path.insert(0, str(REPO))
try:
    import chip_smoke
finally:
    sys.path.pop(0)


def trace(ms_per_call, reps=20, records=None, name="k1r"):
    """One kernel's trace: ``records`` kept of ``reps`` launches, each of
    ``ms_per_call``."""
    n = reps if records is None else records
    return {name: (n, n * ms_per_call * 1e3)}


def test_the_rule_and_its_constants():
    assert chip_smoke.TRACE_SHARE_OF_EVENTS == 0.75
    assert chip_smoke.TRACE_HOST_BOUND_SHARE == 0.25
    assert chip_smoke.TRACE_EVENTS_FLOOR_MS == 0.2


def test_two_short_traces_that_agree_are_set_aside():
    """A low reading seen of K1r on quadratic: two traces at 0.5245 ms
    agree with each other, but the call's CUDA-event time is 1.09 ms."""
    short = [trace(0.5245), trace(0.5245)]
    assert chip_smoke.agreed_reading(
        chip_smoke.plausible_readings(short, 20)) == pytest.approx(0.5245)
    assert chip_smoke.plausible_readings(short, 20, 1.09) == []
    assert chip_smoke.agreed_reading(
        chip_smoke.plausible_readings(short, 20, 1.09)) is None
    full = short + [trace(1.081), trace(1.085)]
    got = chip_smoke.agreed_reading(
        chip_smoke.plausible_readings(full, 20, 1.09))
    assert got == pytest.approx(1.085)


@pytest.mark.parametrize("share, kept", [(0.24, True), (0.26, False),
                                         (0.74, False), (0.76, True)])
def test_the_shares_are_the_boundaries(share, kept):
    got = chip_smoke.plausible_readings([trace(share * 2.0)], 20, 2.0)
    assert bool(got) is kept


def test_short_calls_and_calls_of_several_kernels_are_not_held():
    """Below the floor the host sets the event time (a 0.012 ms kernel in
    a 0.05 ms call); a call of two kernels is not a call of one."""
    assert chip_smoke.plausible_readings([trace(0.012)], 20, 0.05) \
        == pytest.approx([0.012])
    # eight launches of one kernel in a loop: host-bound above the floor
    eight = [trace(0.0235 / 8, records=160), trace(0.0235 / 8, records=160)]
    assert chip_smoke.agreed_reading(chip_smoke.plausible_readings(
        eight, 20, 0.449)) == pytest.approx(0.0235)
    two = [{"a": (20, 20 * 100.0), "b": (20, 20 * 200.0)}]
    assert chip_smoke.plausible_readings(two, 20, 1.0) \
        == pytest.approx([0.3])
    assert chip_smoke.one_kernel([trace(1.0), trace(1.0)], 20)
    assert not chip_smoke.one_kernel(two, 20)
    assert not chip_smoke.one_kernel([{}], 20)
    # one kernel launched four times a call: the gaps between the
    # launches are in the event time (the plain permute, 0.148 ms of
    # device time in 0.205 ms of events), so the readings stand
    four = [trace(0.148 / 4, records=80), trace(0.148 / 4, records=80)]
    assert not chip_smoke.one_kernel(four, 20)
    assert not chip_smoke.one_kernel(eight, 20)
    assert chip_smoke.agreed_reading(chip_smoke.plausible_readings(
        four, 20, 0.205)) == pytest.approx(0.148)


class _Event:
    def __init__(self, key, count, us):
        self.key, self.count, self.self_device_time_total = key, count, us
        self.device_type = DeviceType.CUDA


def test_device_ms_retakes_short_traces(monkeypatch):
    """``device_ms`` over a scripted profiler: the first two traces of a
    one-kernel call read 0.5245 ms (half their records lost), the CUDA
    events 1.09 ms; it takes more traces and returns the agreeing pair
    near 1.09, where before the rule it returned 0.5245."""
    script = [trace(0.5245), trace(0.5245), trace(1.081), trace(1.086)]
    taken, timed = [], []

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            taken.append(script[len(taken)])

        def key_averages(self):
            return [_Event(k, n, us) for k, (n, us) in taken[-1].items()]

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, reps: timed.append(reps) or 1.09)
    ms = chip_smoke.device_ms(lambda: None, 20)
    assert ms == pytest.approx(1.086) and ms.by == "profiler"
    assert len(taken) == 4 and timed == [20]
    np.testing.assert_allclose(
        chip_smoke.whole_readings(script[:2], 20), [0.5245, 0.5245])


def test_device_ms_takes_cuda_events_when_every_trace_is_empty(monkeypatch,
                                                              capsys):
    """Eight empty traces (CUPTI recorded no device time, seen once for a
    plain pack after 14 phases of tracing): the CUDA-event time is taken
    and a line says so, and the time says how it was taken (its row of
    the kernels line carries that, ``timed_by``)."""
    taken, timed = [], []

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            taken.append({})

        def key_averages(self):
            return []

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, reps: timed.append(reps) or 0.131)
    ms = chip_smoke.device_ms(lambda: None, 20)
    assert ms == pytest.approx(0.131) and ms.by == "cuda_events"
    assert len(taken) == 8 and timed == [20]
    assert "no device time in eight traces" in capsys.readouterr().out
    line = dict(ms=chip_smoke.Timing(0.2, "profiler"), plain_ms=ms,
                library_ms=None)
    assert chip_smoke.timed_by(line) == {"ms": "profiler",
                                         "plain_ms": "cuda_events"}
    assert json.loads(json.dumps(line)) == {"ms": 0.2, "plain_ms": 0.131,
                                            "library_ms": None}


def test_an_eight_launch_call_that_lost_two_records_a_call_reads_whole():
    """K7's value over 8 shards, every trace keeping 6 of each call's 8
    records: read ¾ from the records alone, whole over the launches the
    calls made; a call that lost nothing, or whose launches are not known,
    reads as before, and a count below the records' lowers nothing."""
    us = 12.5
    lost = [{"k7": (6 * 20, 6 * 20 * us)}, {"k7": (6 * 20, 6 * 20 * us)}]
    np.testing.assert_allclose(chip_smoke.whole_readings(lost, 20),
                               [6 * us / 1e3] * 2)
    np.testing.assert_allclose(
        chip_smoke.whole_readings(lost, 20, [160, 160]), [8 * us / 1e3] * 2)
    assert chip_smoke.agreed_reading(chip_smoke.plausible_readings(
        lost, 20, None, [160, 160])) == pytest.approx(8 * us / 1e3)
    whole = [{"k7": (160, 160 * us)}]
    np.testing.assert_allclose(chip_smoke.whole_readings(whole, 20, [160]),
                               [8 * us / 1e3])
    np.testing.assert_allclose(chip_smoke.whole_readings(whole, 20, [100]),
                               [8 * us / 1e3])
    # two kernels a call, one of each lost in every trace: both raised
    two = [{"a": (20, 20 * 10.0), "b": (40, 40 * 30.0)}]
    np.testing.assert_allclose(chip_smoke.whole_readings(two, 20, [80]),
                               [(10.0 + 2 * 30.0) * 4 / 3 / 1e3])


def test_a_one_kernel_call_reads_as_before():
    one = [trace(0.3), trace(0.3)]
    np.testing.assert_allclose(chip_smoke.whole_readings(one, 20, [20, 20]),
                               chip_smoke.whole_readings(one, 20))
    assert chip_smoke.agreed_reading(chip_smoke.plausible_readings(
        one, 20, 0.31, [20, 20])) == pytest.approx(0.3)


@pytest.mark.parametrize("sees", [True, False])
def test_the_launches_of_a_call(monkeypatch, sees):
    """The port's counted launches and the runtime records, counted once
    whether or not the runtime records hold the port's launches; the L2
    flush's launches left out; no probe where one count is 0."""
    asked = []
    monkeypatch.setattr(chip_smoke, "runtime_sees_port",
                        lambda: asked.append(1) or sees)
    assert chip_smoke.call_launches(160, 0) == 160
    assert chip_smoke.call_launches(0, 60, 20) == 40 and not asked
    got = chip_smoke.call_launches(60, 100 if sees else 40)
    assert got == (100 if sees else 100) and asked


class _CpuEvent(_Event):
    def __init__(self, key, count):
        super().__init__(key, count, 0.0)
        self.device_type = DeviceType.CPU


@pytest.mark.parametrize("who", ["port", "pytorch"])
def test_device_ms_reads_an_eight_launch_call_whole(monkeypatch, who):
    """``device_ms`` over a scripted profiler whose every trace kept 6 of
    each call's 8 records: the port's kernel (its wrappers count 8
    launches a call) and PyTorch's (the trace holds 8 runtime records a
    call) both read 8 launches' time, where they read ¾ before."""
    us = 12.5
    counted = [0]
    calls = []

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            calls.clear()
            return self

        def __exit__(self, *exc):
            pass

        def key_averages(self):
            n = len(calls)
            out = [_Event("k", 6 * n, 6 * n * us)]
            if who == "pytorch":
                out.append(_CpuEvent("cudaLaunchKernel", 8 * n))
            return out

    def fn():
        calls.append(1)
        if who == "port":
            counted[0] += 8

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(chip_smoke, "port_launches", lambda: counted[0])
    monkeypatch.setattr(chip_smoke, "runtime_sees_port", lambda: True)
    ms = chip_smoke.device_ms(fn, 20)
    assert ms == pytest.approx(8 * us / 1e3) and ms.by == "profiler"
