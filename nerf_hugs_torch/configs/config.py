"""The unified configuration tree, the port's copy of
nerf_hugs_tpu/configs/config.py.

Field names, defaults and derived properties are identical to the JAX
package's: the yaml files and the checkpoints' model_compat.json depend on
them (tests/test_torch_port_configs.py holds the two loaders equal on every
configs/nerfacto/*.yml). YAML files (nerfacto/configs/*.yml) load through
configs.yaml_loader; base:/model: sections map onto Config +
Config.nerfacto (nerfacto/utils/config_utils.py:8-91); gin files
(configs/mipnerf360/*.gin) through configs.gin_parser, whose sections
Config. / Model. / NerfMLP. / PropMLP. map onto Config / Config.model /
Config.nerf_mlp / Config.prop_mlp.

Callables are stored as *names* (e.g. raydist_fn='reciprocal',
warp_fn='contract'), keeping the config tree plain python scalars; the
registries at the end resolve them to torch functions at model
construction, as the JAX package's resolve to jax functions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

# Canonical {train,test}_background_color palette (nerfacto/datasets/
# base.py:199-208; 'random' stands in as 0.5 for deterministic consumers).
# Single source of truth: the models' _background methods AND the GT
# compositing in eval/train/validate_quality must composite over the SAME
# value or every metric is silently skewed.
BACKGROUND_VALUES = {"white": 1.0, "gray": 0.5, "black": 0.0, "random": 0.5}


@dataclasses.dataclass
class MLPConfig:
    """Mip-NeRF 360 PosEnc MLP hyperparameters (models.py:360-392)."""
    net_depth: int = 8
    net_width: int = 256
    bottleneck_width: int = 256
    net_depth_viewdirs: int = 1
    net_width_viewdirs: int = 128
    net_depth_transient: int = 4
    net_width_transient: int = 128
    net_activation: str = "relu"
    min_deg_point: int = 0
    max_deg_point: int = 12
    weight_init: str = "he_uniform"
    skip_layer: int = 4
    skip_layer_dir: int = 4
    skip_layer_transient: int = 4
    num_rgb_channels: int = 3
    deg_view: int = 4
    bottleneck_noise: float = 0.0
    density_activation: str = "softplus"
    density_bias: float = -1.0
    density_noise: float = 0.0
    rgb_premultiplier: float = 1.0
    rgb_activation: str = "sigmoid"
    rgb_bias: float = 0.0
    rgb_padding: float = 0.001
    uncertainty_activation: str = "softplus"
    disable_rgb: bool = False
    disable_transient: bool = True
    warp_fn: Optional[str] = None       # 'contract' | None
    basis_shape: str = "icosahedron"
    basis_subdivisions: int = 2


@dataclasses.dataclass
class ModelConfig:
    """Mip-NeRF 360 sampling pipeline hyperparameters (models.py:46-71)."""
    num_prop_samples: int = 64
    num_nerf_samples: int = 32
    num_levels: int = 3
    bg_intensity_range: Tuple[float, ...] = (1.0, 1.0)
    anneal_slope: float = 10.0
    stop_level_grad: bool = True
    use_viewdirs: bool = True
    raydist_fn: Optional[str] = None    # 'reciprocal'|'log'|'exp'|'sqrt'|'square'|'piecewise'|None
    ray_shape: str = "cone"
    disable_integration: bool = False
    single_jitter: bool = True
    dilation_multiplier: float = 0.5
    dilation_bias: float = 0.0025
    num_glo_features: int = 0
    num_transient_features: int = 0
    num_embeddings: int = 3500
    near_anneal_rate: Optional[float] = None
    near_anneal_init: float = 0.95
    resample_padding: float = 0.0
    use_gpu_resampling: bool = False
    opaque_background: bool = False
    beta_min: float = 0.03
    # TPU memory/perf knobs (no reference equivalent; defaults preserve
    # reference numerics).
    remat_mlp: bool = False       # jax.checkpoint each MLP level (HBM saver)
    compute_dtype: str = "float32"  # 'bfloat16' halves MXU time; fp32 heads


@dataclasses.dataclass
class NerfactoConfig:
    """Nerfacto (hash-grid) model hyperparameters (nerfacto/models/nerfacto.py
    and nerfacto/utils/config_utils.py model section)."""
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    hidden_dim_color: int = 64
    hidden_dim_transient: int = 64
    num_levels: int = 16
    base_res: int = 16
    max_res: int = 2048
    log2_hashmap_size: int = 19
    features_per_level: int = 2
    # Hashed-level index combine for ALL hash grids in the model (field +
    # proposal nets). 'xor' = tcnn-exact (required to import released torch
    # checkpoints); 'add' = TPU-native additive hash whose fixed per-dim row
    # strides let the packed-corner fetch halve/quarter hashed-level gather
    # descriptors (ops/hashgrid.HashGridSpec.hash_impl). Changing it changes
    # the model function — checkpoints do not transfer between modes.
    hash_impl: str = "xor"
    enable_tcnn_mlp: bool = False       # reference ships False; kept for parity
    appearance_embed_dim: int = 32
    use_appearance_embedding: bool = False
    transient_embed_dim: int = 16
    opaque_background: bool = False
    num_nerf_samples_per_ray: int = 48
    num_proposal_samples_per_ray: Tuple[int, ...] = (256, 96)
    num_proposal_iterations: int = 2
    proposal_net_args_list: Tuple[Dict[str, Any], ...] = (
        {"base_res": 16, "hidden_dim": 16, "log2_hashmap_size": 17,
         "features_per_level": 2, "num_levels": 5, "max_res": 128},
        {"base_res": 16, "hidden_dim": 16, "log2_hashmap_size": 17,
         "features_per_level": 2, "num_levels": 5, "max_res": 256},
    )
    use_same_proposal_network: bool = False
    # Reproduce the reference's density_to_weight delta quirk
    # (ray_utils.py:231: deltas cumulative from the FIRST bin, not
    # per-interval). Off by default — it's a bug — but released torch
    # checkpoints were trained under it, so renders of imported weights
    # need it on for faithful outputs (models/nerfacto_import.py).
    legacy_cumulative_deltas: bool = False
    proposal_initial_sampler: str = "piecewise"  # 'piecewise' | 'uniform'
    proposal_histogram_padding: float = 0.01
    proposal_update_every: int = 5
    proposal_warmup: int = 5000
    proposal_weights_anneal_max_num_iters: int = 1000
    proposal_weights_anneal_slope: float = 10.0
    use_single_jitter: bool = True
    rgb_loss_type: str = "mse"
    rgb_loss_mult: float = 1.0
    interlevel_loss_mult: float = 1.0
    distortion_loss_mult: float = 0.002
    # Embedding knobs shared by nerfacto and vanilla nerf YAMLs.
    appearance_embedding_dim: int = 48
    transient_embedding_dim: int = 16
    use_transient_embedding: bool = False
    eval_embedding: str = "original"   # original | zero | average
    # Vanilla NeRF (model_type='nerf') fields (nerfacto/models/nerf.py);
    # names match the YAML model-section keys exactly.
    net_depth: int = 8
    net_width: int = 256
    num_coarse_nerf_samples_per_ray: int = 64
    num_fine_nerf_samples_per_ray: int = 128
    min_deg_point: int = 0
    max_deg_point: int = 10
    deg_view: int = 4
    coarse_rgb_loss_mult: float = 0.1
    fine_rgb_loss_mult: float = 1.0


@dataclasses.dataclass
class Config:
    """Top-level config; field names match the reference's gin Config
    (MipNeRF360/internal/configs.py:45-185) plus the nerfacto base-level
    fields that have no MipNeRF360 equivalent."""
    # Data.
    dataset_loader: str = "llff"
    batch_size: int = 16384
    patch_size: int = 1
    patch_dilation: int = 1
    image_num_per_batch: int = 64
    factor: int = 0
    load_alphabetical: bool = True
    forward_facing: bool = False
    render_path: bool = False
    llffhold: int = 8
    llff_use_all_images_for_training: bool = False
    gc_every: int = 10000
    disable_multiscale_loss: bool = False
    randomized: bool = True
    near: float = 2.0
    far: float = 6.0
    checkpoint_dir: Optional[str] = None
    render_dir: Optional[str] = None
    data_dir: Optional[str] = None
    vocab_tree_path: Optional[str] = None
    render_chunk_size: int = 16384
    # Synthetic (procedural) dataset scale — no reference equivalent; lets
    # hardware quality validation run the exact benched configs against a
    # scene with enough pixels to be non-trivial (tools/validate_quality.py).
    synthetic_num_images: int = 8
    synthetic_height: int = 24
    synthetic_width: int = 32
    # Uniformly scales the procedural world (camera orbit + sphere) so the
    # synthetic scene fits a real config's near/far/bound untouched (e.g.
    # kubric's near=0.1/far=1.2 with scale 0.35).
    synthetic_world_scale: float = 1.0
    num_showcase_images: int = 5
    deterministic_showcase: bool = True
    vis_num_rays: int = 16
    vis_decimate: int = 0
    transient_type: Optional[str] = None  # withmask|robustnerf|nerfw|hanerf

    # Train.
    max_steps: int = 250000
    early_exit_steps: Optional[int] = None
    checkpoint_every: int = 25000
    print_every: int = 100
    train_render_every: int = 5000
    data_loss_type: str = "charb"
    charb_padding: float = 0.001
    data_loss_mult: float = 1.0
    data_coarse_loss_mult: float = 0.0
    interlevel_loss_mult: float = 1.0
    weight_decay_mults: Dict[str, float] = dataclasses.field(default_factory=dict)
    lr_init: float = 0.002
    lr_final: float = 0.00002
    lr_delay_steps: int = 512
    lr_delay_mult: float = 0.01
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-6
    grad_max_norm: float = 0.001
    grad_max_val: float = 0.0
    distortion_loss_mult: float = 0.01

    enable_render_zero_glo: bool = False
    enable_render_zero_tra: bool = False

    # RobustNeRF loss.
    robustnerf_inlier_quantile: float = 0.5
    robustnerf_inlier_quantile_static: float = 0.95
    robustnerf_smoothed_filter_size: int = 3
    robustnerf_smoothed_inlier_quantile: float = 0.5
    robustnerf_inner_patch_size: int = 8
    robustnerf_inner_patch_inlier_quantile: float = 0.4

    # NeRF-W loss.
    nerfw_beta_loss_mult: float = 1.0
    nerfw_beta_loss_bias: float = 3.0
    nerfw_density_loss_mult: float = 0.01

    # HA-NeRF loss.
    hanerf_mask_size_loss_mult_min: float = 6.0e-3
    hanerf_mask_size_loss_mult_max: float = 5.0e-2
    hanerf_mask_size_loss_mult_k: float = 1.0e-3

    # withmask loss.
    withmask_transient_weight: float = 0.0
    static_mask_dir_name: str = "static_masks"

    # Finetune stage (embeddings-only test-time optimization).
    # NOTE (reference quirk, configs.py:137-140): the reference aliases these
    # defaults at class-definition time so they do NOT track an overridden
    # batch_size; we resolve None -> batch_size at load time instead, which
    # reproduces the sane interpretation while letting gin set both.
    finetune_enable: bool = False
    finetune_max_steps: int = 5000
    finetune_batch_size: Optional[int] = None
    finetune_patch_size: Optional[int] = None
    finetune_patch_dilation: Optional[int] = None
    finetune_image_num_per_batch: Optional[int] = None
    finetune_lr_decay_mult: float = 1.0
    finetune_lr_init: float = 0.005
    finetune_lr_final: float = 0.0005
    finetune_lr_delay_steps: int = 500
    finetune_lr_delay_mult: float = 0.01
    finetune_adam_beta1: float = 0.9
    finetune_adam_beta2: float = 0.999
    finetune_adam_eps: float = 1e-8

    # Eval.
    eval_only_once: bool = True
    eval_save_output: bool = True
    eval_save_ray_data: bool = False
    eval_render_interval: int = 1
    eval_dataset_limit: int = 2**31 - 1
    eval_quantize_metrics: bool = True
    eval_crop_borders: int = 0
    eval_data: str = "test"              # nerfacto: eval over train or test split
    use_eval_lpips: bool = False

    # Render.
    render_video_fps: int = 60
    render_video_crf: int = 18
    render_path_frames: int = 120
    z_variation: float = 0.0
    z_phase: float = 0.0
    render_dist_percentile: float = 0.5
    render_dist_curve_fn: str = "log"
    render_path_file: Optional[str] = None
    render_job_id: int = 0
    render_num_jobs: int = 1
    render_resolution: Optional[Tuple[int, int]] = None
    render_focal: Optional[float] = None
    render_camtype: Optional[str] = None
    render_embed_idx: Optional[int] = None
    render_spherical: bool = False
    render_save_async: bool = True
    render_spline_keyframes: Optional[str] = None
    render_spline_n_interp: int = 30
    render_spline_degree: int = 5
    render_spline_smoothness: float = 0.03

    # nerfacto-stack extras (nerfacto/utils/config_utils.py base section).
    seed: int = 12345678
    enable_amp: bool = True              # -> bf16 compute on TPU
    model_type: str = "mipnerf360"       # mipnerf360 | nerfacto | nerf
    bound: float = 1.0
    rescale_scene: bool = False
    enable_scene_contraction: bool = False
    enable_clip_near_far: bool = False
    train_background_color: str = "white"   # random|white|gray|black
    test_background_color: str = "white"
    warmup_steps: int = 500
    lr_decay_mult: float = 1.0
    eval_render_every: int = 5000
    eval_images_num: int = 4   # in-train eval window (config_utils.py:45)
    save_eval_render: bool = True
    save_weight_every: int = 25000
    save_test_render: bool = True
    finetune_params: Tuple[str, ...] = ("appearance_embedding",)

    # Sub-model configs.
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    nerf_mlp: MLPConfig = dataclasses.field(default_factory=lambda: MLPConfig())
    prop_mlp: MLPConfig = dataclasses.field(default_factory=lambda: MLPConfig(
        net_depth=4, net_width=256, disable_rgb=True))
    nerfacto: NerfactoConfig = dataclasses.field(default_factory=NerfactoConfig)

    def __post_init__(self):
        for name in ("batch_size", "patch_size", "patch_dilation",
                     "image_num_per_batch"):
            if getattr(self, f"finetune_{name}") is None:
                setattr(self, f"finetune_{name}", getattr(self, name))

    @property
    def num_ray_levels(self) -> int:
        """Renderings per forward pass (the per-level loss axis). The
        robustnerf inlier-threshold carried state has this shape; using it
        for the initial value keeps the train step's jit signature stable
        across the threshold feedback loop (one compile, not two — the
        reference keeps a fixed buffer for the same reason, train.py:130)."""
        if self.model_type == "nerfacto":
            return self.nerfacto.num_proposal_iterations + 1
        if self.model_type == "nerf":
            return 2  # coarse/fine
        return self.model.num_levels


# Callable registries resolved by models at construction (the torch
# counterparts of nerf_hugs_tpu/configs/config.py:359-395).
def resolve_activation(name: str):
    import torch
    from torch.nn import functional as F
    if name in ("exp", "safe_exp"):
        from nerf_hugs_torch.core import math as nh_math
        return nh_math.safe_exp
    # jax.nn.gelu defaults to the tanh approximation.
    table = {
        "relu": F.relu, "softplus": F.softplus, "sigmoid": torch.sigmoid,
        "silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "none": None, "identity": lambda x: x,
    }
    if name not in table:
        raise ValueError(f"unknown activation {name!r}")
    return table[name]


def resolve_raydist_fn(name: Optional[str]):
    """None, 'piecewise' or one of the torch functions whose __name__
    core.coord.construct_ray_warps reads to find its inverse."""
    import torch
    if name is None:
        return None
    if name == "piecewise":
        return "piecewise"
    table = {"reciprocal": torch.reciprocal, "log": torch.log,
             "exp": torch.exp, "sqrt": torch.sqrt, "square": torch.square}
    if name not in table:
        raise ValueError(f"unknown raydist_fn {name!r}")
    return table[name]


def resolve_warp_fn(name: Optional[str]):
    if name is None:
        return None
    if name == "contract":
        from nerf_hugs_torch.core import coord
        return coord.contract
    raise ValueError(f"unknown warp_fn {name!r}")
