"""Model operations of the window over its time, % of the bf16 peak."""
from benchmark import readers


def read(run):
    return readers.mfu(run)
