"""profile_round.py's device-time measure on synthetic timelines: kernels
on two streams that overlap count once, so a round whose work forks is
never more than 100 % busy, and a captured run's replay window starts
after the capture's pause."""

import pytest

pytest.importorskip("torch")

import profile_round  # noqa: E402


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0, 10), (20, 30)], 20.0),
    ([(0, 10), (5, 15)], 15.0),
    ([(0, 30), (5, 10), (12, 20)], 30.0),
    ([(20, 30), (0, 10), (10, 20)], 30.0),
])
def test_union_counts_overlap_once(spans, want):
    assert profile_round.union_us(spans) == want


def test_replay_window_skips_the_capture_and_unions_streams():
    # four rounds of one main kernel each; round 1 runs eagerly, the host
    # then captures (the device idle 100 us), rounds 2-4 replay, each with
    # a gather on a side stream that overlaps its kernel by 4 us
    events = [("main", 0, 10), ("gather", 10, 12)]
    for start in (112, 124, 136):
        events += [("main", start, start + 10), ("gather", start + 6,
                                                  start + 12)]
    wall, dev, launches = profile_round.replay_window(events, "main", 4)
    assert (wall, dev, launches) == (36 / 1e3 / 3, 36 / 1e3 / 3, 2.0)
