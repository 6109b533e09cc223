"""The port's entry points, run as ``python -m youtube_vln_tpu_torch.entries.<name>``."""
