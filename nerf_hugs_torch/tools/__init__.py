"""The port's tools, run as `python -m nerf_hugs_torch.tools.X`:
microbenchmarks, the scene and snapshot writers the checks use, and the
released-checkpoint converter."""
