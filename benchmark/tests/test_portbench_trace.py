"""The trace's reduction on hand-made events: busy time is the union of
the device's intervals within the benchmark's ranges, kernel time is
summed by name, and idle gaps go to the innermost host op."""

import pytest

from benchmark.trace import HOST_IDLE, Trace


class Ev:
    def __init__(self, name, start, end, cpu, annotation=False):
        self._n, self._s, self._d, self._cpu = name, start, end - start, cpu
        self._a = annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CPU" if self._cpu else "DeviceType.CUDA"

    def is_user_annotation(self):
        return self._a


def _trace():
    return Trace([
        Ev("bench::window", 0, 1000, True),
        Ev("bench::prove", 100, 500, True),
        Ev("bench::prove", 600, 900, True),
        Ev("bench::prove", 100, 500, False, annotation=True),  # mirrored
        Ev("aten::mul", 100, 300, True),
        Ev("aten::to", 300, 470, True),
        Ev("aten::copy_", 320, 460, True),
        Ev("fold_evals_kernel<4, 0, false>", 120, 200, False),
        Ev("fold_evals_kernel<4, 0, false>", 150, 250, False),  # overlaps
        Ev("msm_windows_kernel", 400, 550, False),  # crosses a range end
        Ev("memcpy", 650, 700, False),
        Ev("stray", 950, 990, False),  # outside every prove
    ])


def test_busy_and_kernel_times():
    t = _trace()
    assert t.span_s("bench::prove") == pytest.approx(700e-9)
    # union within proves: [120, 250] + [400, 500] + [650, 700]
    assert t.busy_s("bench::prove") == pytest.approx(280e-9)
    assert t.busy_s("bench::window") == pytest.approx(370e-9)
    by = t.device_s_by_name("bench::prove")
    assert by["fold_evals_kernel<4, 0, false>"] == pytest.approx(180e-9)
    assert by["msm_windows_kernel"] == pytest.approx(100e-9)
    assert t.kernel_s("bench::prove", lambda n: "msm_" in n) == \
        pytest.approx(100e-9)
    assert t.top_device_ops("bench::prove", 1)[0][0].startswith("fold")


def test_idle_gaps_by_host_activity():
    t = _trace()
    gaps = dict(t.idle_by_host("bench::prove"))
    # [100, 120]: aten::mul; [250, 400]: its middle 325 lies in aten::to
    # and in its child aten::copy_, the innermost; [600, 650] and
    # [700, 900]: no host op
    assert gaps == pytest.approx({"aten::mul": 20e-9, "aten::copy_": 150e-9,
                                  HOST_IDLE: 250e-9})
    assert sum(gaps.values()) == pytest.approx(700e-9 - 280e-9)
