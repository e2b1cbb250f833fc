"""Share of the traced window in which no operation ran on the device."""
from portbench.metrics import idle_percent


def read(ctx):
    return idle_percent(ctx)
