"""The port's kernel launches (cuda_lib.launches) a proof verified."""
from snarkbench.readings import launches_per_lane


def read(rec):
    return launches_per_lane(rec)
