"""B5 and B6 (row pass and column sums) at the cell's shapes: bound over device time, %."""
from benchmark import readers


def read(run):
    return readers.roofline(run, ("epilogue",), "epilogue")
