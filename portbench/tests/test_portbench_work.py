"""The work count of the sweep against a count by hand."""

import pytest

from pbcore import work


def test_predict_flops_by_hand():
    # n = 2 training points, D = 1 input, one output: the cross-covariance
    # 2 * (3 + 2), the substitution 2^2, the mean and |v|^2 4 * 2
    assert work.predict_flops(2, 1, 1) == 10 + 4 + 8
    assert work.predict_flops(2, 1, 3) == 3 * 22


def test_predict_flops_headline():
    # n = 210, D = 14, 64 outputs: 3.47e6 a point, 34.7 TFLOP a 10^7 wave
    assert work.predict_flops(210, 14, 64) == 3467520
    assert work.predict_flops(210, 14, 64) * 10**7 / 1e12 == pytest.approx(34.6752)


def test_least_seconds_takes_the_larger_bound():
    peak = work.PEAKS["flops_per_s"]["float32"]
    rate = work.PEAKS["bytes_per_s"]
    assert work.least_seconds(peak, 0.0) == pytest.approx(1.0)
    assert work.least_seconds(0.0, rate) == pytest.approx(1.0)
    assert work.least_seconds(peak, 2 * rate) == pytest.approx(2.0)
    assert work.predict_bytes(14, 2) == 64
