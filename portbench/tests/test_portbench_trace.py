"""The idle arithmetic: a union of intervals counts an overlap once."""

import pytest

from pbcore import trace


def test_union_counts_overlap_once():
    assert trace.union_length([0.0, 1.0], [2.0, 3.0]) == pytest.approx(3.0)
    assert trace.union_length([0.0, 0.5], [1.0, 0.8]) == pytest.approx(1.0)   # nested
    assert trace.union_length([2.0, 0.0], [3.0, 1.0]) == pytest.approx(2.0)   # apart, unsorted
    assert trace.union_length([], []) == 0.0


def test_idle_gaps():
    gaps = trace.idle_gaps([1.0, 1.5, 4.0], [2.0, 3.0, 5.0], 0.0, 6.0)
    assert gaps == [(0.0, 1.0), (3.0, 4.0), (5.0, 6.0)]


def test_reduce_events_clips_to_window_and_names_gaps():
    device = (["k1", "k2", "Memcpy HtoD", "k1"], [0.5, 1.5, 2.5, 9.0], [2.0, 2.5, 3.0, 11.0],
              [True, True, False, True])
    host = (["portbench.window", "np.partition", "aten::mm"], [1.0, 3.2, 1.0],
            [10.0, 3.9, 2.0])
    s = trace.reduce_events(device, host, (1.0, 10.0))
    assert s["window_s"] == pytest.approx(9.0)
    # device busy over [1, 3] and [9, 10]; kernels alone over [1, 2.5] and [9, 10]
    assert s["busy_s"] == pytest.approx(3.0)
    assert s["kernel_s"] == pytest.approx(2.5)
    assert s["device_ops"][0] == ["k1", pytest.approx(2.0)]
    # the gap [3, 9] is named by the innermost host operation at its middle
    assert s["idle_gaps"][0] == ["portbench.window", pytest.approx(6.0)]
    assert 1.0 - s["busy_s"] / s["window_s"] == pytest.approx(6.0 / 9.0)


def test_gap_named_by_innermost_operation():
    s = trace.reduce_events((["k"], [0.0], [1.0], [True]),
                            (["portbench.window", "wave"], [0.0, 1.0], [4.0, 3.0]), (0.0, 4.0))
    assert s["idle_gaps"] == [["wave", pytest.approx(3.0)]]
