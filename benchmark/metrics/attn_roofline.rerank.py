"""B1 and B2 (attention_fwd_kernel) at the cell's shapes: bound over device time, %."""
from benchmark import readers


def read(run):
    return readers.roofline(run, ("attention_fwd",), "attention")
