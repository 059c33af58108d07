"""Least time of the ICP's projective association (the posed row gather
of the tracking and verification loops) at each call's shapes.

Per call with N source rows of which V are valid (the mask): read the
mask (1 B a row), the valid rows' points and normals (24 B), one packed
target row each (8 × float16 = 16 B) and the pose (64 B); write each
row's weight (4 B) and the valid rows' matched point and normal (24 B).
About 50 operations a valid row (transform, rotation, projection,
distance and normal gates).  Each byte is counted once, whatever a
kernel reads again; the calls are those the inputs need (an ICP loop
that has converged issues none), as the plain reference counts them.
"""

BYTES_PER_ROW = 1 + 4
BYTES_PER_VALID = 24 + 16 + 24
FLOP_PER_VALID = 50


def call(rows: float, valid: float) -> tuple:
    """(bytes, operations) of one association."""
    return (BYTES_PER_ROW * rows + BYTES_PER_VALID * valid + 64,
            FLOP_PER_VALID * valid)


def least_seconds(work, peaks: dict) -> float:
    total = 0.0
    for rows, valid in work.assoc:
        b, f = call(rows, valid)
        total += max(b / peaks["bytes_per_s"], f / peaks["flop_per_s_f32"])
    return total
