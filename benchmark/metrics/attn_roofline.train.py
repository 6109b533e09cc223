"""B1-B4 (forward kernels, backward kernels and their pre-pass) at the cell's shapes: bound over device time, %."""
from benchmark import readers


def read(run):
    return readers.roofline(run, ("attention_fwd", "attention_bwd"), "attention")
