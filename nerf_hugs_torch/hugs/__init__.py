"""HuGS static-mask generation (segment.py: SAM's automatic masks, the
colour-residual and SfM heuristics, their fusion), run as
`python -m nerf_hugs_torch.hugs`; SAM itself is in sam/."""


def main(argv=None):
    """The static-mask CLI (nerf_hugs_torch/hugs/segment.py)."""
    from nerf_hugs_torch.hugs import segment
    return segment.cli_main(argv)
