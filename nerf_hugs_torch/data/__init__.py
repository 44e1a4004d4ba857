"""Dataset registry: the procedural `synthetic` and `synthetic_distractor`
scenes and the `kubric`, `distractor` and `phototourism` loaders. llff and
blender wait for ROADMAP.md Queue 1 item 11b."""

from __future__ import annotations

from typing import Optional


def _loaders():
    from nerf_hugs_torch.data import distractor, kubric, phototourism, \
        synthetic
    return {"kubric": kubric.Kubric, "distractor": distractor.Distractor,
            "phototourism": phototourism.Phototourism,
            "synthetic": synthetic.Synthetic,
            "synthetic_distractor": synthetic.SyntheticDistractor}


def check_loader(config) -> None:
    """Raise unless config.dataset_loader is ported."""
    if config.dataset_loader not in _loaders():
        raise NotImplementedError(
            f"dataset_loader {config.dataset_loader!r} is not ported yet "
            f"(ROADMAP.md Queue 1 item 11b); ported: {sorted(_loaders())}")


def load_dataset(split: str, data_dir: str, config, is_training: bool,
                 sample_from_half_image: bool = False,
                 batch_size: Optional[int] = None,
                 patch_size: Optional[int] = None,
                 patch_dilation: Optional[int] = None,
                 image_num_per_batch: Optional[int] = None):
    """Construct the configured dataset (starts its prefetch thread). The
    batch keywords override the config's (the finetune stage passes its
    finetune_* values)."""
    check_loader(config)
    pick = lambda value, default: default if value is None else value
    return _loaders()[config.dataset_loader](
        split=split, is_training=is_training,
        sample_from_half_image=sample_from_half_image,
        batch_size=pick(batch_size, config.batch_size),
        patch_size=pick(patch_size, config.patch_size),
        patch_dilation=pick(patch_dilation, config.patch_dilation),
        image_num_per_batch=pick(image_num_per_batch,
                                 config.image_num_per_batch),
        data_dir=data_dir, config=config)
