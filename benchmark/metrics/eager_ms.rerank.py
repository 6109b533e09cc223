"""Device ms per request in eager elementwise and reduction kernels."""
from benchmark import readers


def read(run):
    return readers.eager_ms(run)
