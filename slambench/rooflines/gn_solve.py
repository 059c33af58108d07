"""Least time of a Gauss-Newton solve of the ICP loop (the point-to-plane
reduction of the matched rows, the damped 6×6 solve and the pose update)
at each call's shapes.

Per call with N rows of which M are matched: read every row's weight
(4 B) and the matched rows' source point, target point and normal
(36 B); read and write the loop's 64-float carry (512 B).  About 100
operations a matched row (transform, residual, Huber weight, Jacobian,
the 21 + 6 + 3 sums) and 600 for the solve.
"""

BYTES_PER_ROW = 4
BYTES_PER_MATCH = 36
FLOP_PER_MATCH = 100


def call(rows: float, matched: float) -> tuple:
    """(bytes, operations) of one solve."""
    return (BYTES_PER_ROW * rows + BYTES_PER_MATCH * matched + 512,
            FLOP_PER_MATCH * matched + 600)


def least_seconds(work, peaks: dict) -> float:
    total = 0.0
    for rows, matched in work.gn:
        b, f = call(rows, matched)
        total += max(b / peaks["bytes_per_s"], f / peaks["flop_per_s_f32"])
    return total
