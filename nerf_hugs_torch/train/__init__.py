"""Training: Adam, the finetune partition and the train step (step.py),
checkpoints, chunked rendering, and the two-stage driver of the yaml and
gin dialects (driver.py),
run as `python -m nerf_hugs_torch.train`."""


def main(argv=None):
    """The training driver's entry point (nerf_hugs_torch/train/driver.py)."""
    from nerf_hugs_torch.train import driver
    return driver.main(argv)
