"""The Gauss-Newton solve's share of its roofline (`rooflines/gn_solve.py`;
kernels under `rooflines/gn_solve.kernels/`, today `csrc/gn_step.cu`), from
the slice."""

from slambench.metrics import _roofline


def read(ctx):
    return _roofline.share(ctx, "gn_solve")
