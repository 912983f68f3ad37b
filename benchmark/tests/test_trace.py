"""The trace reader on a synthetic event list."""

import pytest

from benchmark import trace


def test_busy_time_is_the_union_of_intervals():
    events = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30), ("d", 22, 25)]
    assert trace.merged(events) == [(0, 15), (20, 30)]
    assert trace.busy_us(events) == 25


def test_time_by_kernel_name_groups_templates_and_arguments():
    events = [("void at::native::elementwise_kernel<128, 4, F>(int, F)", 0, 2),
              ("void at::native::elementwise_kernel<128, 2, G>(int, G)", 2, 5),
              ("ampere_sgemm_64x64_nn", 5, 9)]
    assert trace.time_by_name(events) == {"at::native::elementwise_kernel": 5,
                                          "ampere_sgemm_64x64_nn": 4}
    assert trace.matching_us(events, ["sgemm"]) == 4


def test_idle_gaps_go_to_the_span_open_on_the_host():
    device = [("k", 10, 20), ("k", 30, 35), ("k", 33, 40)]
    spans = [("request", 0, 100), ("load", 0, 8), ("forward", 8, 60), ("write", 60, 100)]
    idle = trace.idle_by_span(device, spans, 0, 100)
    # 0-10: load then forward (the gap starts in load); 20-30 forward; 40-100 forward
    assert idle == {"load": 10, "forward": 70}
    assert trace.top(idle, 1, scale=1.0) == [["forward", 70]]
    assert sum(idle.values()) + trace.busy_us(device) == pytest.approx(100)


def test_no_span_open_is_labelled_none():
    assert trace.open_span([("a", 5, 6)], 1) == "none"
