"""The program-span reader (benchmark/program_spans.py) and the readers of
the per-layer metrics built on it, on synthetic spans and device lists."""

from collections import namedtuple

import pytest

from benchmark import harness, program_spans

# The fields the readers use of the program's records.
Span = namedtuple("Span", "name id parent group start_ns end_ns counts")


def spans_of(*rows):
    """Spans from (name, id, parent, start µs, end µs[, counts])."""
    out = []
    for name, sid, parent, s, e, *counts in rows:
        out.append(Span(name, sid, parent, sid if parent == 0 else parent, int(s * 1e3),
                        int(e * 1e3), counts[0] if counts else {}))
    return out


def test_innermost_pieces_name_the_latest_span_open():
    pieces = program_spans.innermost([("step", 0, 100), ("generator", 10, 40),
                                      ("gen_backward", 40, 90)])
    assert pieces == [("step", 0, 10), ("generator", 10, 40), ("gen_backward", 40, 90),
                      ("step", 90, 100)]
    # Two spans that start together: the one that ends first is the inner.
    assert program_spans.innermost([("request", 0, 50), ("load", 0, 20)]) == [
        ("load", 0, 20), ("request", 20, 50)]


def test_a_gap_that_crosses_two_spans_is_split_between_them():
    spans = spans_of(("step", 1, 0, 0, 100), ("generator", 2, 1, 10, 40),
                     ("gen_backward", 3, 1, 40, 90), ("step", 4, 0, 200, 300))
    device = [("k", 0, 5), ("k", 20, 30), ("k", 25, 50), ("k", 95, 250), ("k", 260, 300)]
    idle = program_spans.idle_by_span(device, spans)
    # 5-20 crosses step (5-10) and generator (10-20); 50-90 gen_backward;
    # 90-95 step; 100-200 lies outside every step and is nobody's; 250-260 step.
    assert idle == pytest.approx({"step": 5 + 5 + 10, "generator": 10, "gen_backward": 40})
    assert sum(idle.values()) == pytest.approx(200 - (5 + 30 + 55 + 40))


@pytest.fixture
def recorded(monkeypatch):
    """Readers see ``spans`` as the program's records."""
    box = []
    monkeypatch.setattr(program_spans, "recorded", lambda: list(box) or None)
    return box


def serve_spans():
    """Two requests: a one-segment clip, and a five-segment one whose
    segments run as a bucket-4 forward of three and a bucket-2 of two."""
    return spans_of(
        ("request", 1, 0, 0, 100), ("load", 2, 1, 0, 10), ("forward", 3, 1, 10, 80),
        ("generator", 4, 3, 10, 75, {"bucket": 1, "segments": 1}), ("save", 5, 1, 80, 100),
        ("request", 6, 0, 200, 400), ("load", 7, 6, 200, 230), ("forward", 8, 6, 230, 380),
        ("unfold", 9, 8, 230, 240), ("generator", 10, 8, 240, 300, {"bucket": 4, "segments": 3}),
        ("generator", 11, 8, 300, 360, {"bucket": 2, "segments": 2}), ("fold", 12, 8, 360, 380),
        ("save", 13, 6, 380, 400))


def test_serve_readers(recorded):
    recorded.extend(serve_spans())
    device = [("k", 20, 70), ("k", 250, 290), ("k", 310, 390)]
    ctx = {"kind": "serve", "device": device}
    read = {m: harness.metric_reader(m)(ctx) for m in (
        "load_host_ms.serve", "save_host_ms.serve", "generator_idle_ms.serve",
        "padded_segment_share.serve")}
    assert read["load_host_ms.serve"] == pytest.approx((10 + 30) / 2 / 1e3)
    assert read["save_host_ms.serve"] == pytest.approx((20 + 20) / 2 / 1e3)
    # Idle under generator: 10-20 and 70-75; 240-250, 290-300 and 300-310.
    assert read["generator_idle_ms.serve"] == pytest.approx((15 + 30) / 2 / 1e3)
    assert read["padded_segment_share.serve"] == pytest.approx(1 / 7)
    # A train ctx reads none of them.
    assert harness.metric_reader("load_host_ms.serve")({"kind": "train", "device": []}) is None


def test_train_readers(recorded):
    recorded.extend(spans_of(
        ("step", 1, 0, 0, 1000), ("generator", 2, 1, 0, 100), ("gen_loss", 3, 1, 100, 200),
        ("gen_backward", 4, 1, 200, 500), ("gen_update", 5, 1, 500, 550),
        ("disc_loss", 6, 1, 550, 700, {"disc": "mpd"}),
        ("disc_backward", 7, 1, 700, 900, {"disc": "mpd"}),
        ("disc_update", 8, 1, 900, 950, {"disc": "mpd"}), ("metrics", 9, 1, 950, 1000)))
    device = [("k", 50, 150), ("k", 300, 500), ("k", 600, 800), ("k", 920, 1000)]
    ctx = {"kind": "train", "device": device}
    read = {m: harness.metric_reader(m)(ctx) for m in (
        "gen_forward_idle_ms.train", "gen_backward_idle_ms.train", "disc_idle_ms.train")}
    assert read == pytest.approx({"gen_forward_idle_ms.train": (50 + 50) / 1e3,
                                  "gen_backward_idle_ms.train": 100 / 1e3,
                                  "disc_idle_ms.train": (50 + 100) / 1e3})
    idle = program_spans.idle_by_span(device, recorded)
    assert (idle["gen_update"], idle["disc_update"], idle["metrics"]) == (50, 20, 0)


def test_without_program_spans_every_reader_reads_nothing(recorded):
    """A program that records no spans (one without the recorder): None."""
    for name, kind in (("load_host_ms.serve", "serve"), ("save_host_ms.serve", "serve"),
                       ("generator_idle_ms.serve", "serve"),
                       ("padded_segment_share.serve", "serve"),
                       ("gen_forward_idle_ms.train", "train"),
                       ("gen_backward_idle_ms.train", "train"),
                       ("disc_idle_ms.train", "train")):
        assert harness.metric_reader(name)({"kind": kind, "device": [("k", 0, 1)]}) is None
