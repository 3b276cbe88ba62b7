"""Runnable examples of the port (``python -m repro_torch.examples.<name>``);
each runs on the CUDA card unless given ``--device cpu``."""
