"""Dataset registry (reference names: MipNeRF360/internal/datasets.py:
57-66, nerfacto/datasets/__init__.py:1-13): the procedural `synthetic`,
`synthetic_distractor` and `synthetic_appearance` scenes and the `kubric`,
`distractor`, `phototourism`, `llff` and `blender` loaders. The
reference's Tanks-and-Temples and DTU loaders are stubs there and in JAX,
and are refused here before anything is built; any other name is
unknown, as JAX says (nerf_hugs_tpu/data/__init__.py:35-37)."""

from __future__ import annotations

from typing import Optional

# The reference's stub loaders (MipNeRF360/internal/datasets.py:792, 841,
# 908), by registry name.
_STUBS = {"tat_nerfpp": "TanksAndTemplesNerfPP",
          "tat_fvs": "TanksAndTemplesFVS", "dtu": "DTU"}


def _loaders():
    from nerf_hugs_torch.data import blender, distractor, kubric, llff, \
        phototourism, synthetic
    return {"blender": blender.Blender, "llff": llff.LLFF,
            "kubric": kubric.Kubric, "distractor": distractor.Distractor,
            "phototourism": phototourism.Phototourism,
            "synthetic": synthetic.Synthetic,
            "synthetic_distractor": synthetic.SyntheticDistractor,
            "synthetic_appearance": synthetic.SyntheticAppearance}


def check_loader(config) -> None:
    """Raise unless config.dataset_loader names a loader: a stub of the
    reference raises NotImplementedError, any other unknown name
    ValueError."""
    name = config.dataset_loader
    if name in _STUBS:
        raise NotImplementedError(
            f"{_STUBS[name]} is a stub in the reference too "
            "(MipNeRF360/internal/datasets.py:792,841,908)")
    if name not in _loaders():
        raise ValueError(
            f"unknown dataset_loader {name!r}; options: "
            f"{sorted(list(_loaders()) + list(_STUBS))}")


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
