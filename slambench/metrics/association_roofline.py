"""The projective association's share of its roofline
(`rooflines/association.py`; kernels under `rooflines/association.kernels/`,
today `csrc/correspond.cu`), from the slice."""

from slambench.metrics import _roofline


def read(ctx):
    return _roofline.share(ctx, "association")
