"""Dataset registry: the procedural `synthetic` and `synthetic_distractor`
scenes and the `kubric` loader. Every other loader waits for ROADMAP.md
Queue 1 item 11b."""

from __future__ import annotations


def _loaders():
    from nerf_hugs_torch.data import kubric, synthetic
    return {"kubric": kubric.Kubric, "synthetic": synthetic.Synthetic,
            "synthetic_distractor": synthetic.SyntheticDistractor}


def load_dataset(split: str, data_dir: str, config, is_training: bool):
    """Construct the configured dataset (starts its prefetch thread)."""
    loaders = _loaders()
    if config.dataset_loader not in loaders:
        raise NotImplementedError(
            f"dataset_loader {config.dataset_loader!r} is not ported yet "
            f"(ROADMAP.md Queue 1 item 11b); ported: {sorted(loaders)}")
    return loaders[config.dataset_loader](
        split=split, is_training=is_training, batch_size=config.batch_size,
        patch_size=config.patch_size, patch_dilation=config.patch_dilation,
        image_num_per_batch=config.image_num_per_batch, data_dir=data_dir,
        config=config)
