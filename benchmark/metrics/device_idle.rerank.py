"""% of the traced segment in which the device ran nothing."""
from benchmark import readers


def read(run):
    return readers.device_idle(run)
