"""B1's share of its roofline: the least time of the sweeps' DP rows
(bytes at HBM rate vs operations at the FP32 rate, the benchmark's own
count) over the device time of the Poisson-binomial kernel."""
from portbench.metrics import roofline_percent
from portbench.work.peaks import FP32_FLOP_PER_S


def read(ctx):
    return roofline_percent(ctx, "b1", FP32_FLOP_PER_S, "pb_tails")
