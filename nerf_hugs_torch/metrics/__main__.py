from nerf_hugs_torch.metrics.score import cli

if __name__ == "__main__":
    cli()
