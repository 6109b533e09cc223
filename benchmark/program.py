"""What the drivers take from the program: its model loaded with the
benchmark's weights, its kernels built in the benchmark's cache, and its
feed of batches."""
from __future__ import annotations

import collections

import torch

from benchmark import harness
from benchmark.reference import lily as ref_lily


def prepare(build_dir, device) -> None:
    """Kernels built under ``build_dir``; the native store reader there."""
    from youtube_vln_tpu_torch.data import store
    from youtube_vln_tpu_torch.ops import _build
    _build.set_build_dir(build_dir)
    if device.type == "cuda" and store.get_native() is None:
        raise RuntimeError("the native store reader (native/libvlnstore.so) "
                           "did not build")


def model(run: harness.Run, device):
    """(LilyConfig, Lily) with the weights the benchmark draws from the
    seed (``reference/lily.py:make_weights``)."""
    from youtube_vln_tpu_torch.models import Lily
    cfg = harness.port_config(run.cell.config)
    net = Lily(cfg, device=device)
    weights = ref_lily.make_weights(run.model, run.seed, device)
    net.load_state_dict(weights, strict=True)
    del weights
    return cfg, net


def peak_and_free(device) -> int:
    """The device's peak allocation so far (before the reference runs)."""
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


class NoTF32:
    """f32 matrix products in full f32 while the reference runs."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


class Feed:
    """The ``Loader``'s host batches through the program's
    ``device.prefetch_to_device``, as its entries feed them; ``take()``
    returns the next (host batch, device batch)."""

    def __init__(self, loader, device, depth: int, drop=()):
        from youtube_vln_tpu_torch.device import prefetch_to_device
        self._fifo = collections.deque()
        self._host = self._batches(loader, drop)
        self._device = prefetch_to_device(self._host, device, depth)

    def _batches(self, loader, drop):
        for batch in loader:
            batch = {k: v for k, v in batch.items() if k not in drop}
            self._fifo.append(batch)
            yield batch

    def take(self):
        dev = next(self._device, None)
        if dev is None:
            raise RuntimeError("the data ran out inside the window: raise "
                               "the traffic's n_paths or repeat")
        return self._fifo.popleft(), dev

    def close(self) -> None:
        """Stops the feed (and the Loader's worker processes)."""
        self._device.close()
        self._host.close()
