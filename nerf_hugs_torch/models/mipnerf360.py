"""Mip-NeRF 360: hierarchical proposal sampling over cone Gaussians.

Twin of nerf_hugs_tpu/models/mipnerf360.py (MipNeRF360/internal/
models.py:73-330). Per level: dilate the previous weights, anneal them
(Schlick bias on train_frac), sample new intervals by inverse CDF in the
normalized s-space, warp them to metric t, cast cone Gaussians, run the
level's MLP and alpha-composite. The proposal levels share PropMLP_0, the
final level runs NerfMLP_0 with the GLO and transient vectors, NeRF-W's
dual rendering and HA-NeRF's implicit mask.

Contract: forward(rays, train_frac, compute_extras, rng, zero_glo,
zero_tra) -> (renderings, ray_history), one dict per level in each, the
JAX model's __call__ with rng=None as the deterministic path. With
compute_extras each rendering carries the first vis_num_rays rays'
`ray_sdist`, `ray_weights` and `ray_rgbs` bags.

Module names are the flax names (NerfMLP_0, PropMLP_0, GloEmbed_0,
TransientEmbed_0, ImplicitMask_0; Dense_k inside each MLP), which
models/from_jax.py and the per-module gradient clipping rely on.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from nerf_hugs_torch.configs import config as cfg
from nerf_hugs_torch.core import coord, render, stepfun
from nerf_hugs_torch.models.mlp import ImplicitMask, PosEncMLP
from nerf_hugs_torch.models.nerfacto import _embedding
from nerf_hugs_torch.utils import structs


def check_transient_config(config) -> None:
    """The transient-type checks the JAX model runs first
    (nerf_hugs_tpu/models/mipnerf360.py:33-45)."""
    transient_type = config.transient_type
    num_transient = config.model.num_transient_features
    if transient_type in (None, "withmask", "robustnerf"):
        if num_transient != 0:
            raise ValueError(f"transient_type={transient_type} requires "
                             "num_transient_features == 0")
    elif transient_type in ("nerfw", "hanerf"):
        if num_transient <= 0:
            raise ValueError(f"transient_type={transient_type} requires "
                             "num_transient_features > 0")
    else:
        raise ValueError(f"unknown transient_type {transient_type!r}")


def module_names(config) -> List[str]:
    """The top-level modules MipNerf360Model builds for `config`."""
    mc = config.model
    names = ["NerfMLP_0", "PropMLP_0"]
    if config.transient_type == "hanerf":
        names.append("ImplicitMask_0")
    if mc.num_glo_features > 0:
        names.append("GloEmbed_0")
    if mc.num_transient_features > 0:
        names.append("TransientEmbed_0")
    return names


class MipNerf360Model(nn.Module):
    """Parameters are drawn on the CPU from `generator` and then moved to
    `device`."""

    def __init__(self, config, device, generator: torch.Generator):
        super().__init__()
        check_transient_config(config)
        self.config = config
        mc = config.model
        nerf_mlp_cfg = cfg.MLPConfig(**vars(config.nerf_mlp))
        nerf_mlp_cfg.disable_transient = config.transient_type != "nerfw"
        prop_mlp_cfg = cfg.MLPConfig(**vars(config.prop_mlp))
        prop_mlp_cfg.disable_transient = True
        cdt = getattr(torch, mc.compute_dtype)
        self.NerfMLP_0 = PosEncMLP(
            nerf_mlp_cfg, cdt, generator, use_viewdirs=mc.use_viewdirs,
            glo_dim=mc.num_glo_features, tra_dim=mc.num_transient_features,
            remat=mc.remat_mlp)
        self.PropMLP_0 = PosEncMLP(prop_mlp_cfg, cdt, generator,
                                   use_viewdirs=mc.use_viewdirs,
                                   remat=mc.remat_mlp)
        self.ImplicitMask_0 = (
            ImplicitMask(mc.num_transient_features, generator)
            if config.transient_type == "hanerf" else None)
        self.GloEmbed_0 = (
            _embedding(mc.num_embeddings, mc.num_glo_features, generator)
            if mc.num_glo_features > 0 else None)
        self.TransientEmbed_0 = (
            _embedding(mc.num_embeddings, mc.num_transient_features,
                       generator)
            if mc.num_transient_features > 0 else None)
        self._raydist_fn = cfg.resolve_raydist_fn(mc.raydist_fn)
        self.to(device)

    @staticmethod
    def flax_path(name: str) -> tuple:
        """A parameter's path in the flax tree ('NerfMLP_0.Dense_0.weight'
        -> ('NerfMLP_0', 'Dense_0', 'kernel'), 'GloEmbed_0.weight' ->
        ('GloEmbed_0', 'embedding'))."""
        parts = name.split(".")
        if len(parts) == 2:
            return (parts[0], "embedding")
        return (parts[0], parts[1],
                "kernel" if parts[2] == "weight" else parts[2])

    def _embed(self, embed: Optional[nn.Embedding], rays, zero: bool):
        """[n, dim] rows at the rays' embed_idx, or zeros when `zero`;
        None without a table."""
        if embed is None:
            return None
        if zero:
            return torch.zeros(rays.origins.shape[:-1]
                               + (embed.embedding_dim,),
                               device=rays.origins.device)
        return embed(rays.embed_idx[..., 0])

    def forward(self, rays: structs.Rays, train_frac: float,
                compute_extras: bool,
                rng: Optional[torch.Generator] = None,
                zero_glo: bool = True, zero_tra: bool = True):
        mc = self.config.model
        glo_vec = self._embed(self.GloEmbed_0, rays, zero_glo)
        tra_vec = self._embed(self.TransientEmbed_0, rays, zero_tra)
        _, s_to_t = coord.construct_ray_warps(self._raydist_fn, rays.near,
                                              rays.far)
        # The schedule in float32, as the jitted JAX arithmetic on the
        # traced train_frac.
        f32 = np.float32
        frac = f32(train_frac)
        if mc.near_anneal_rate is None:
            init_s_near = 0.0
        else:
            init_s_near = float(np.clip(
                f32(1) - frac / f32(mc.near_anneal_rate), f32(0),
                f32(mc.near_anneal_init)))
        init_s_far = 1.0
        if mc.anneal_slope > 0:
            s = f32(mc.anneal_slope)
            anneal = float((s * frac) / ((s - f32(1)) * frac + f32(1)))
        else:
            anneal = 1.0
        domain = (init_s_near, init_s_far)
        sdist = torch.cat([torch.full_like(rays.near, init_s_near),
                           torch.full_like(rays.far, init_s_far)], dim=-1)
        weights = torch.ones_like(rays.near)
        prod_num_samples = 1

        renderings: List[dict] = []
        ray_history: List[dict] = []
        for i_level in range(mc.num_levels):
            is_prop = i_level < mc.num_levels - 1
            num_samples = (mc.num_prop_samples if is_prop
                           else mc.num_nerf_samples)
            dilation = mc.dilation_bias + mc.dilation_multiplier * (
                init_s_far - init_s_near) / prod_num_samples
            prod_num_samples *= num_samples
            # Under stop_level_grad no gradient crosses the sampling (the
            # JAX stop_gradient), so it runs without a graph: max_dilate's
            # [rays, 3n + 1, n] mask is not kept for a backward pass.
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and not mc.stop_level_grad):
                if i_level > 0 and (mc.dilation_bias > 0
                                    or mc.dilation_multiplier > 0):
                    sdist, weights = stepfun.max_dilate_weights(
                        sdist, weights, dilation, domain=domain)
                    sdist = sdist[..., 1:-1]
                    weights = weights[..., 1:-1]
                # log-space weights ** anneal; zero-width intervals -inf.
                logits = torch.where(
                    sdist[..., 1:] > sdist[..., :-1],
                    anneal * torch.log(weights + mc.resample_padding),
                    torch.full_like(weights, -float("inf")))
                sdist = stepfun.sample_intervals(
                    rng, sdist, logits, num_samples,
                    single_jitter=mc.single_jitter, domain=domain,
                    use_gpu_resampling=mc.use_gpu_resampling)

            tdist = s_to_t(sdist)
            gaussians = render.cast_rays(tdist, rays.origins,
                                         rays.directions, rays.radii,
                                         mc.ray_shape)
            if mc.disable_integration:
                gaussians = (gaussians[0], torch.zeros_like(gaussians[1]))
            mlp = self.PropMLP_0 if is_prop else self.NerfMLP_0
            ray_results = mlp(
                rng, gaussians,
                viewdirs=rays.viewdirs if mc.use_viewdirs else None,
                glo_vec=None if is_prop else glo_vec,
                tra_vec=None if is_prop else tra_vec)
            weights = render.compute_alpha_weights(
                ray_results["density"], tdist, rays.directions,
                opaque_background=mc.opaque_background)[0]
            bg_rgbs = self._background(rng, weights)
            rendering = render.volumetric_rendering(
                ray_results["rgb"], weights, tdist, bg_rgbs, rays.far,
                compute_extras)
            if compute_extras:
                n = self.config.vis_num_rays
                rgb = ray_results["rgb"]
                rendering["ray_sdist"] = sdist.reshape(
                    -1, sdist.shape[-1])[:n]
                rendering["ray_weights"] = weights.reshape(
                    -1, weights.shape[-1])[:n]
                rendering["ray_rgbs"] = rgb.reshape(
                    (-1,) + rgb.shape[-2:])[:n]
            if "density_transient" in ray_results:
                self._render_transient(rendering, ray_results, tdist,
                                       rays.directions, bg_rgbs)
            renderings.append(rendering)
            ray_results["sdist"] = sdist
            ray_results["weights"] = weights
            ray_history.append(ray_results)

        if compute_extras:
            # Proposal colours are meaningless: show the final colour.
            ws = [r["ray_weights"] for r in renderings]
            rgbs = [r["ray_rgbs"] for r in renderings]
            final_rgb = torch.sum(rgbs[-1] * ws[-1][..., None], dim=-2)
            for i in range(len(renderings) - 1):
                renderings[i]["ray_rgbs"] = final_rgb[:, None, :].expand(
                    rgbs[i].shape)
        if self.ImplicitMask_0 is not None:
            renderings[-1]["implicit_mask"] = self.ImplicitMask_0(
                rays.pix_coords, tra_vec)
        return renderings, ray_history

    def _background(self, rng: Optional[torch.Generator], weights):
        """A fixed background, the range's midpoint on the deterministic
        path, else one uniform draw per ray."""
        lo, hi = self.config.model.bg_intensity_range[:2]
        if lo == hi:
            return lo
        if rng is None:
            return (lo + hi) / 2
        shape = weights.shape[:-1] + (3,)
        return lo + (hi - lo) * torch.rand(shape, generator=rng,
                                           device=weights.device)

    def _render_transient(self, rendering: dict, ray_results: dict, tdist,
                          directions, bg_rgbs) -> None:
        """NeRF-W's buffers: the static and transient colours over their
        shared transmittance, and the per-ray uncertainty beta = sum of
        the transient-only weights x u + beta_min."""
        mc = self.config.model
        density_t = ray_results["density_transient"]
        w_s, w_t, w_c = render.compute_dual_alpha_weights(
            ray_results["density"], density_t, tdist, directions,
            opaque_background=mc.opaque_background)
        (rendering["rgb_combined"], rendering["rgb_static"],
         rendering["rgb_transient"]) = render.composite_combined_color(
            ray_results["rgb"], ray_results["rgb_transient"], bg_rgbs,
            w_s, w_t, w_c)
        w_tr = render.compute_alpha_weights(
            density_t, tdist, directions,
            opaque_background=mc.opaque_background)[0]
        rendering["uncertainty"] = (
            (w_tr[..., None] * ray_results["uncertainty"]).sum(dim=-2)
            + mc.beta_min)
