"""The phase readers (benchmark/harness/phases.py) on a planted trace:
known spans, launch calls, device operations and gaps."""

import pytest

from benchmark.harness import phases

# (name, parent, t0_ns, t1_ns): "inner" nests in "mac"
SPANS = [("dt", None, 1000, 2000), ("mac", None, 3000, 6000),
         ("inner", 1, 4000, 5000), ("nodal", None, 7000, 9000)]
# (launch_ns, name, start_us, duration_us)
OPS = [(1500, "a", 10.0, 2.0),      # dt; 5 us after the window opens
       (3500, "b", 12.0, 3.0),      # mac, no gap
       (4500, "c", 20.0, 1.0),      # inner, after a 5 us gap
       (8000, "d", 21.0, 4.0),      # nodal
       (8500, "e", 24.0, 2.0),      # nodal, overlapping d: union 5 us
       (10000, "f", 30.0, 1.0),     # no span holds its launch: 4 us gap
       (None, "g", 31.0, 1.0)]      # no launch call in the trace
WINDOW = (5000, 40000)              # ns: 5 us before a, 8 us after g
WANT = {"dt": (2.0, 5.0, 1), "mac": (3.0, 0.0, 1), "inner": (1.0, 5.0, 1),
        "nodal": (5.0, 0.0, 2), phases.OUTSIDE: (2.0, 12.0, 2)}


def test_planted_busy_and_idle_by_span():
    got = phases.attribute(SPANS, OPS, WINDOW)
    assert {k: (v["busy_us"], v["idle_us"], v["ops"])
            for k, v in got.items()} == WANT
    busy = sum(v["busy_us"] for v in got.values())
    idle = sum(v["idle_us"] for v in got.values())
    assert busy == 13.0 and busy + idle == (WINDOW[1] - WINDOW[0]) * 1e-3


def test_without_a_window_only_the_gaps_between_operations_count():
    got = phases.attribute(SPANS, list(reversed(OPS)))
    assert got["dt"]["idle_us"] == 0.0
    assert got[phases.OUTSIDE]["idle_us"] == 4.0
    assert got["inner"]["idle_us"] == 5.0


def test_longest_gaps_are_named_by_the_span_that_ended_them():
    assert phases.longest_gaps(SPANS, OPS, top=2) == [
        ["inner", "c", pytest.approx(5e-6)],
        [phases.OUTSIDE, "f", pytest.approx(4e-6)]]


def test_readers_per_step_and_none_without_spans():
    record = {"steps": 2, "trace": {"spans": SPANS, "launches": OPS,
                                    "window_ns": WINDOW}}
    assert phases.phase_ms(record, "nodal") == pytest.approx(2.5e-3)
    assert phases.phase_idle_ms(record, "dt") == pytest.approx(2.5e-3)
    assert phases.phase_ms(record, "predict") == 0.0
    assert phases.phase_idle_ms(record, phases.OUTSIDE) == \
        pytest.approx(6e-3)
    for bare in ({"steps": 2}, {"steps": 2, "trace": {"events": []}},
                 {"steps": 2, "trace": {"spans": [], "launches": OPS}},
                 {"steps": 2, "trace": {"spans": None, "launches": OPS}}):
        assert phases.phase_ms(bare, "nodal") is None
        assert phases.phase_idle_ms(bare, "nodal") is None


def test_an_open_span_holds_what_follows_its_start():
    spans = [("step", None, 0, None), ("mac", 0, 100, 200)]
    got = phases.attribute(spans, [(150, "x", 1.0, 1.0), (300, "y", 2.0, 1.0),
                                   (-5, "z", 3.0, 1.0)])
    assert {k: v["ops"] for k, v in got.items()} == {
        "mac": 1, "step": 1, phases.OUTSIDE: 1}


class _Event:
    def __init__(self, host, corr, name, start_ns, dur_ns=0):
        from torch.autograd import DeviceType
        self._dt = DeviceType.CPU if host else DeviceType.CUDA
        self._c, self._n, self._s, self._d = corr, name, start_ns, dur_ns

    def device_type(self):
        return self._dt

    def correlation_id(self):
        return self._c

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


class _Prof:
    def __init__(self, events):
        class R:
            def events(self_):
                return events

        class P:
            kineto_results = R()
        self.profiler = P()


def test_launches_pair_each_operation_with_its_launch_call():
    prof = _Prof([_Event(False, 7, "k2", 9000, 500),
                  _Event(True, 6, "Lazy Function Loading", 150),
                  _Event(True, 6, "cudaLaunchKernel", 100),
                  _Event(True, 7, "cudaLaunchKernel", 200),
                  _Event(False, 6, "k1", 8000, 1000),
                  _Event(False, 9, "Memcpy DtoH", 9500, 100),
                  _Event(False, 0, "k0", 7000, 100)])
    assert phases.launches(prof) == [(None, "k0", 7.0, 0.1),
                                     (100, "k1", 8.0, 1.0),
                                     (200, "k2", 9.0, 0.5),
                                     (None, "Memcpy DtoH", 9.5, 0.1)]
