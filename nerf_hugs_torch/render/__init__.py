"""Rendering: the driver of the yaml and gin dialects (driver.py), run as
`python -m nerf_hugs_torch.render`."""


def main(argv=None):
    """The render driver's entry point (nerf_hugs_torch/render/driver.py)."""
    from nerf_hugs_torch.render import driver
    return driver.main(argv)
