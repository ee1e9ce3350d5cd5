"""The share of the traced window in which no operation ran on the
device (torch.profiler)."""
from snarkbench.readings import idle_pct


def read(rec):
    return idle_pct(rec)
