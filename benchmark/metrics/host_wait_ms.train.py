"""Mean host-clock ms per step that the window waits for its next device batch."""
from benchmark import readers


def read(run):
    return readers.host_wait_ms(run)
