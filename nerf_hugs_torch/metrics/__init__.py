"""Image metrics (PSNR, SSIM, LPIPS, colour correction) and the scoring
CLI (score.py), run as `python -m nerf_hugs_torch.metrics`."""


def main(argv=None):
    """The scoring CLI's entry point (nerf_hugs_torch/metrics/score.py)."""
    from nerf_hugs_torch.metrics import score
    return score.cli(argv)
