"""``portbench/spans.py`` on the CPU: the innermost span at a point, and
the device-clock window's readings per unit (the CPU timer falls back to
the host clock)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import spans  # noqa: E402


def test_innermost_span_at_each_point():
    nested = [(0, 10, "a"), (1, 4, "b"), (2, 3, "c"), (5, 9, "d"),
              (12, 14, "e")]
    points = [0.5, 1.5, 2.5, 3.5, 4.5, 6, 9.5, 11, 13, 15]
    assert spans.innermost(nested, points) == [
        "a", "b", "c", "b", "a", "d", "a", None, "e", None]


def test_device_span_window_reads_per_unit():
    def unit(timer):
        with timer("outer"):
            for _ in range(3):
                with timer("inner"):
                    pass
        return 1

    summary = spans.SpanSummary()
    spans.device_span_window(summary, unit, 2, "cpu")
    assert summary.span_counts == {"outer": 1.0, "inner": 3.0}
    assert summary.device_span_ms("outer") >= summary.device_span_ms("inner")
    assert summary.device_span_ms("outer", "missing") is None
