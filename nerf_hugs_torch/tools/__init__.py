"""Microbenchmarks of the port, run as `python -m nerf_hugs_torch.tools.X`."""
