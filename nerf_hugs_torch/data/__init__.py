"""Dataset registry. Only the procedural `synthetic` scene is ported; every
other loader waits for ROADMAP.md Queue 1 item 11."""

from __future__ import annotations


def load_dataset(split: str, data_dir: str, config, is_training: bool):
    """Construct the configured dataset (starts its prefetch thread)."""
    if config.dataset_loader != "synthetic":
        raise NotImplementedError(
            f"dataset_loader {config.dataset_loader!r} is not ported yet "
            "(ROADMAP.md Queue 1 item 11); only 'synthetic' is")
    from nerf_hugs_torch.data import synthetic
    return synthetic.Synthetic(
        split=split, is_training=is_training, batch_size=config.batch_size,
        patch_size=config.patch_size, patch_dilation=config.patch_dilation,
        image_num_per_batch=config.image_num_per_batch, data_dir=data_dir,
        config=config)
