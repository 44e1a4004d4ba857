"""Evaluation: the driver of the yaml and gin dialects (driver.py), run as
`python -m nerf_hugs_torch.eval`."""


def main(argv=None):
    """The evaluation driver's entry point (nerf_hugs_torch/eval/driver.py)."""
    from nerf_hugs_torch.eval import driver
    return driver.main(argv)
