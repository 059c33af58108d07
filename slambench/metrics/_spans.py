"""Span arithmetic shared by the per-layer readers."""

CHILDREN = ("slam.scan", "slam.readback", "slam.drain", "slam.promote_bundle",
            "slam.attempt")


def covered(lo: float, hi: float, spans) -> float:
    """Seconds of [lo, hi] that the union of `spans` covers."""
    total, end = 0.0, lo
    for _n, s, e, _t in sorted(spans, key=lambda x: x[1]):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def wall_s(spans) -> float:
    return sum(e - s for _n, s, e, _t in spans)
