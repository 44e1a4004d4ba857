"""Vanilla NeRF: a coarse and a fine positional-encoding MLP.

Twin of nerf_hugs_tpu/models/vanilla.py (the reference's nerfacto/models/
nerf.py:119-912). The coarse pass evaluates uniform intervals in the warped
s-space; the fine pass draws intervals from the coarse weights by inverse
CDF, merges their centres with the coarse centres (a sorted union) and
re-fences the union at its midpoints, so the fine MLP sees both sets of
samples. Both passes composite over one background draw.

Contract: forward(rays, train_frac, compute_extras, rng, zero_glo,
zero_tra) -> (renderings, ray_history), [coarse, fine] in each, the JAX
model's __call__ with rng=None as the deterministic path; the loss weighs
the coarse rendering by data_coarse_loss_mult. NeRF-W's transient head
sits on the fine MLP, HA-NeRF's implicit mask (the positional-encoding
mask of models/mlp.py, no hash grid) on the fine rendering.

Module names are the flax names (coarse, fine, appearance_embedding,
transient_embedding, implicit_mask; Dense_k inside each MLP in flax's call
order), which models/from_jax.py, models/jax_init.py and the per-module
gradient clipping rely on. The MLPs are torch Linears: flax runs them as
nn.Dense outside any Pallas kernel.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn
from torch.nn import functional as F

from nerf_hugs_torch.configs import config as cfg
from nerf_hugs_torch.core import coord, render, stepfun
from nerf_hugs_torch.models.from_jax import dense_flax_path
from nerf_hugs_torch.models.mlp import (ImplicitMask, _dense, _Layers,
                                        _run_stack, _skip_stack)
from nerf_hugs_torch.models.nerfacto import (NerfactoModel, _embedding,
                                             check_transient_config)
from nerf_hugs_torch.utils import structs


def module_names(config) -> List[str]:
    """The top-level modules VanillaNerfModel builds for `config`."""
    nc = config.nerfacto
    names = ["coarse", "fine"]
    if nc.use_appearance_embedding:
        names.append("appearance_embedding")
    if nc.use_transient_embedding:
        names.append("transient_embedding")
    if config.transient_type == "hanerf":
        names.append("implicit_mask")
    return names


class PointMLP(nn.Module):
    """pos_enc(contract(x)) -> density trunk with skips -> bottleneck +
    pos_enc(viewdir) [+ appearance] -> rgb; with `transient`, NeRF-W's head
    off the bottleneck and the transient embedding (JAX vanilla.py:26-94).
    appearance_dim and transient_dim are the widths of the vectors the
    caller passes (0: none)."""

    def __init__(self, mlp_config: cfg.MLPConfig, use_contraction: bool,
                 transient: bool, compute_dtype: torch.dtype,
                 generator: torch.Generator, appearance_dim: int = 0,
                 transient_dim: int = 0):
        super().__init__()
        c = self.mlp_config = mlp_config
        if c.weight_init != "he_uniform":
            raise ValueError(f"weight_init {c.weight_init!r} is not ported")
        self.use_contraction = use_contraction
        self.compute_dtype = compute_dtype
        self.net_activation = cfg.resolve_activation(c.net_activation)
        self.density_activation = cfg.resolve_activation(c.density_activation)
        self.rgb_activation = cfg.resolve_activation(c.rgb_activation)

        layers = _Layers(self, generator)
        point_dim = 3 + 6 * (c.max_deg_point - c.min_deg_point)
        self.trunk, d = _skip_stack(layers, point_dim, c.net_width,
                                    c.net_depth, c.skip_layer)
        self.density_head = layers(d, 1)
        self.bottleneck = layers(d, c.bottleneck_width)
        view_in = c.bottleneck_width + 3 + 6 * c.deg_view + appearance_dim
        self.view, d = _skip_stack(layers, view_in, c.net_width_viewdirs,
                                   c.net_depth_viewdirs, c.skip_layer_dir)
        self.rgb_head = layers(d, c.num_rgb_channels)
        self.transient = None
        if transient and transient_dim > 0:
            stack, d = _skip_stack(layers, c.bottleneck_width + transient_dim,
                                   c.net_width_transient,
                                   c.net_depth_transient,
                                   c.skip_layer_transient)
            self.transient = stack + [layers(d, 1),
                                      layers(d, c.num_rgb_channels),
                                      layers(d, 1)]

    def _rgb(self, raw):
        c = self.mlp_config
        rgb = self.rgb_activation(c.rgb_premultiplier * raw + c.rgb_bias)
        return rgb * (1 + 2 * c.rgb_padding) - c.rgb_padding

    def forward(self, rng: Optional[torch.Generator], positions, viewdirs,
                embedded_appearance=None, embedded_transient=None) -> dict:
        """rng draws the density noise (None: none)."""
        c = self.mlp_config
        cdt = self.compute_dtype
        dense = lambda x, name: _dense(x, getattr(self, name), cdt)
        if self.use_contraction:
            positions = coord.contract(positions)
        x = coord.pos_enc(positions, c.min_deg_point,
                          c.max_deg_point).to(cdt)
        x = _run_stack(self, x, self.trunk, c.skip_layer,
                       self.net_activation, cdt)
        raw_density = dense(x, self.density_head)[..., 0].float()
        if rng is not None and c.density_noise > 0:
            raw_density = raw_density + c.density_noise * torch.randn(
                raw_density.shape, generator=rng, device=raw_density.device)
        outputs = {"density": self.density_activation(raw_density
                                                      + c.density_bias)}

        bottleneck = dense(x, self.bottleneck)
        branches = [bottleneck,
                    coord.pos_enc(viewdirs, 0, c.deg_view).to(cdt)]
        if embedded_appearance is not None:
            branches.append(embedded_appearance.to(cdt))
        x = _run_stack(self, torch.cat(branches, dim=-1), self.view,
                       c.skip_layer_dir, self.net_activation, cdt)
        outputs["rgb"] = self._rgb(dense(x, self.rgb_head).float())

        if self.transient is not None and embedded_transient is not None:
            *stack, density_t, rgb_t, uncertainty = self.transient
            x = _run_stack(self, torch.cat(
                [bottleneck, embedded_transient.to(cdt)], dim=-1), stack,
                c.skip_layer_transient, self.net_activation, cdt)
            outputs["density_transient"] = self.density_activation(
                dense(x, density_t)[..., 0].float() + c.density_bias)
            outputs["rgb_transient"] = self._rgb(dense(x, rgb_t).float())
            outputs["uncertainty"] = F.softplus(
                dense(x, uncertainty).float())
        return outputs


def merge_fine_intervals(sdist, new_sdist):
    """The fine pass's intervals (JAX vanilla.py:176-187): the coarse
    intervals' centres and those drawn from the coarse weights, merged as
    a sorted union and fenced at their midpoints, the outer fences
    reflected around the end centres and clamped to [0, 1]."""
    centers = 0.5 * (sdist[..., 1:] + sdist[..., :-1])
    centers_new = 0.5 * (new_sdist[..., 1:] + new_sdist[..., :-1])
    merged = torch.sort(torch.cat([centers, centers_new], -1), -1).values
    mid = 0.5 * (merged[..., 1:] + merged[..., :-1])
    return torch.cat([
        torch.clamp(2 * merged[..., :1] - mid[..., :1], min=0.0),
        mid,
        torch.clamp(2 * merged[..., -1:] - mid[..., -1:], max=1.0)], dim=-1)


class VanillaNerfModel(nn.Module):
    """Parameters are drawn on the CPU from `generator` and then moved to
    `device`."""

    def __init__(self, config, device, generator: torch.Generator):
        super().__init__()
        check_transient_config(config)
        self.config = config
        nc = config.nerfacto
        cdt = torch.bfloat16 if config.enable_amp else torch.float32
        mlp_cfg = cfg.MLPConfig(
            net_depth=nc.net_depth, net_width=nc.net_width,
            min_deg_point=nc.min_deg_point, max_deg_point=nc.max_deg_point,
            deg_view=nc.deg_view)
        appearance = (nc.appearance_embedding_dim
                      if nc.use_appearance_embedding else 0)
        transient = (nc.transient_embedding_dim
                     if nc.use_transient_embedding else 0)
        contraction = config.enable_scene_contraction
        self.coarse = PointMLP(mlp_cfg, contraction, False, cdt, generator,
                               appearance)
        self.fine = PointMLP(mlp_cfg, contraction,
                             config.transient_type == "nerfw", cdt,
                             generator, appearance, transient)
        num = config.model.num_embeddings
        self.appearance_embedding = (
            _embedding(num, nc.appearance_embedding_dim, generator)
            if nc.use_appearance_embedding else None)
        self.transient_embedding = (
            _embedding(num, nc.transient_embedding_dim, generator)
            if nc.use_transient_embedding else None)
        self.implicit_mask = (
            ImplicitMask(nc.transient_embedding_dim, generator)
            if config.transient_type == "hanerf" else None)
        warps = {"piecewise": "piecewise", "uniform": None,
                 "reciprocal": torch.reciprocal}
        sampler = nc.proposal_initial_sampler
        if sampler not in warps:
            raise ValueError(f"unknown proposal_initial_sampler {sampler!r}")
        self._warp_fn = warps[sampler]
        self.to(device)

    # A parameter's path in the flax tree.
    flax_path = staticmethod(dense_flax_path)

    # The eval_embedding modes, the background draw and NeRF-W's buffers
    # are nerfacto's (JAX vanilla.py:137-151, 253-258 and 214-234 repeat
    # nerfacto.py's).
    _get_embedding = NerfactoModel._get_embedding
    _background = NerfactoModel._background
    _render_transient = NerfactoModel._render_transient

    def forward(self, rays: structs.Rays, train_frac: float,
                compute_extras: bool,
                rng: Optional[torch.Generator] = None,
                zero_glo: bool = True, zero_tra: bool = True):
        nc = self.config.nerfacto
        deterministic = rng is None
        _, s_to_t = coord.construct_ray_warps(self._warp_fn, rays.near,
                                              rays.far)
        sdist = torch.cat([torch.zeros_like(rays.near),
                           torch.ones_like(rays.far)], dim=-1)
        weights = torch.ones_like(rays.near)
        # One background per ray for both composites and the target.
        bg_rgbs = self._background(rng, rays.origins.shape[:-1] + (3,),
                                   rays.origins.device)

        renderings: List[dict] = []
        ray_history: List[dict] = []
        for field_type in ("coarse", "fine"):
            num_samples = (nc.num_coarse_nerf_samples_per_ray
                           if field_type == "coarse"
                           else nc.num_fine_nerf_samples_per_ray)
            # The intervals take no gradient (the JAX stop_gradient).
            with torch.no_grad():
                logits = torch.where(sdist[..., 1:] > sdist[..., :-1],
                                     torch.log(weights),
                                     torch.full_like(weights, -float("inf")))
                new_sdist = stepfun.sample_intervals(
                    rng, sdist, logits, num_samples,
                    single_jitter=nc.use_single_jitter, domain=(0.0, 1.0))
                sdist = (new_sdist if field_type == "coarse"
                         else merge_fine_intervals(sdist, new_sdist))
            tdist = s_to_t(sdist)
            t_mids = 0.5 * (tdist[..., 1:] + tdist[..., :-1])
            positions = (rays.origins[..., None, :]
                         + rays.directions[..., None, :] * t_mids[..., None])
            vd = rays.viewdirs[..., None, :].expand(positions.shape)
            per_sample = lambda embed, zero: self._get_embedding(
                embed, rays.embed_idx, deterministic, zero).expand(
                    positions.shape[:-1] + (-1,))
            emb_a = (per_sample(self.appearance_embedding, zero_glo)
                     if self.appearance_embedding is not None else None)
            emb_t = None
            if (field_type == "fine" and self.transient_embedding is not None
                    and self.config.transient_type == "nerfw"):
                emb_t = per_sample(self.transient_embedding, zero_tra)
            mlp = self.coarse if field_type == "coarse" else self.fine
            field_outputs = mlp(rng, positions, vd, emb_a, emb_t)

            weights = torch.nan_to_num(render.compute_alpha_weights(
                field_outputs["density"], tdist, rays.directions,
                opaque_background=nc.opaque_background,
                cumulative_from_first=nc.legacy_cumulative_deltas)[0])
            rendering = render.volumetric_rendering(
                field_outputs["rgb"], weights, tdist, bg_rgbs, rays.far,
                compute_extras)
            if rng is not None:
                rendering["bg_rgb"] = bg_rgbs
            history = {"sdist": sdist, "weights": weights,
                       "density": field_outputs["density"]}
            if "density_transient" in field_outputs:
                self._render_transient(rendering, history, field_outputs,
                                       tdist, rays.directions, bg_rgbs)
            renderings.append(rendering)
            ray_history.append(history)

        if self.implicit_mask is not None:
            emb_t = self._get_embedding(self.transient_embedding,
                                        rays.embed_idx[..., 0],
                                        deterministic, zero_tra)
            renderings[-1]["implicit_mask"] = self.implicit_mask(
                rays.pix_coords, emb_t)
        return renderings, ray_history
