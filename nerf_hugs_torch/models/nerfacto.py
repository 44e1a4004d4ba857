"""Nerfacto: hash-grid fields + proposal sampling, in PyTorch.

Twin of nerf_hugs_tpu/models/nerfacto.py (the reference's nerfacto/models/
nerfacto.py without tiny-cuda-nn). Per level: sample intervals from the
previous level's weights without gradient, warp s -> t, positions
o + t*d, hash field, density -> weights, composite the final level.

Contract: forward(rays, train_frac, compute_extras, rng, zero_glo,
zero_tra) -> (renderings, ray_history), the JAX model's __call__ with
rng=None as the deterministic path. renderings holds the final level only
(plus HA-NeRF's per-ray `implicit_mask`); ray_history every level's
{sdist, weights, density} for the interlevel loss.

Module and parameter names mirror the flax tree (field/hashgrid,
field/mlp_base/Dense_k -> field.mlp_base.layers.k, field/mlp_base/w_i ->
field.mlp_base.w_i, proposal_i/..., appearance_embedding/embedding ->
appearance_embedding.weight, implicit_mask/{hashgrid,mlp}), so
models/from_jax.py maps one onto the other (the NeRF-W head is
field/mlp_transient -> field.mlp_transient).

Appearance and transient embeddings with their eval_embedding modes,
HA-NeRF's implicit mask (a 2-D hash grid on the pixel coordinates) and
NeRF-W's transient head (transient density, colour and uncertainty beside
the static field, composited over one transmittance) are ported.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from nerf_hugs_torch.configs import config as cfg
from nerf_hugs_torch.core import coord, render, stepfun
from nerf_hugs_torch.ops.fused_mlp import FusedMLP, fused_mlp
from nerf_hugs_torch.ops.hashgrid import HashGridEncoding, HashGridSpec
from nerf_hugs_torch.ops.sh import sh_encode
from nerf_hugs_torch.utils import structs


class _TruncExp(torch.autograd.Function):
    """exp with a clamped-input backward (tcnn's density activation)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.exp(torch.clamp(x, -15.0, 15.0)) * g


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)


class _ReluMLP(nn.Module):
    """ReLU MLP with the two paths of the reference's enable_tcnn_mlp
    switch (nerf_hugs_tpu/models/nerfacto.py:65-103):
      fused=False: flax Dense(dtype=compute_dtype) layers with biases and
        fp32 parameters; inputs, weights and biases are cast to the compute
        dtype (bf16 under enable_amp) inside every layer, as flax promotes
        them, and the result stays in the compute dtype;
      fused=True: bias-free fp32 weights w_i [d_in, d_out] (the flax
        layout), cast to the compute dtype and run through the fused MLP
        (the CUDA kernel on the card), which rounds to the compute dtype
        after every layer."""

    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int,
                 out_dim: int, compute_dtype: torch.dtype,
                 generator: torch.Generator, fused: bool = False):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.compute_dtype = compute_dtype
        self.fused = fused
        self.out_dim = out_dim
        if fused:
            self.num_weights = len(dims) - 1
            for i, w in enumerate(FusedMLP(dims).init(generator)):
                self.register_parameter(f"w_{i}", nn.Parameter(w))
            return
        self.layers = nn.ModuleList()
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            lin = nn.Linear(d_in, d_out)
            # flax he_uniform: uniform(+-sqrt(6 / fan_in)), zero bias.
            limit = math.sqrt(6.0 / d_in)
            with torch.no_grad():
                lin.weight.uniform_(-limit, limit, generator=generator)
                lin.bias.zero_()
            self.layers.append(lin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        if self.fused:
            lead = x.shape[:-1]
            flat = x.reshape(-1, x.shape[-1]).to(cdt)
            weights = [getattr(self, f"w_{i}").to(cdt)
                       for i in range(self.num_weights)]
            return fused_mlp(flat, weights).reshape(lead + (self.out_dim,))
        x = x.to(cdt)
        for i, lin in enumerate(self.layers):
            x = F.linear(x, lin.weight.to(cdt), lin.bias.to(cdt))
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def _normalize_positions(positions, bound: float, contraction: bool):
    """World positions -> [0,1]^3 grid coords + in-box selector."""
    if contraction:
        positions = (coord.contract(positions) + 2.0) / 4.0
    else:
        positions = (positions + bound) / (2 * bound)
    selector = torch.all((positions >= 0.0) & (positions <= 1.0), dim=-1)
    return positions * selector[..., None], selector


def _grid_spec(args: Dict[str, Any]) -> HashGridSpec:
    return HashGridSpec(
        num_levels=args.get("num_levels", 8),
        features_per_level=args.get("features_per_level", 2),
        log2_hashmap_size=args.get("log2_hashmap_size", 18),
        base_res=args.get("base_res", 16), max_res=args.get("max_res", 1024),
        hash_impl=args.get("hash_impl", "xor"))


TRANSIENT_TYPES = (None, "withmask", "robustnerf", "nerfw", "hanerf")


def check_transient_config(config) -> None:
    """Refuse a transient_type the model and losses do not know, and the
    two whose heads read the transient embedding without it: HA-NeRF's mask
    and NeRF-W's transient head (JAX builds no head then, and its NeRF-W
    loss fails on the missing uncertainty)."""
    if config.transient_type not in TRANSIENT_TYPES:
        raise ValueError(f"unknown transient_type {config.transient_type!r}")
    if config.transient_type in ("hanerf", "nerfw") \
            and not config.nerfacto.use_transient_embedding:
        raise ValueError(f"transient_type {config.transient_type!r} needs "
                         "use_transient_embedding: its head reads the "
                         "transient embedding")


def has_transient_head(config) -> bool:
    """Whether the field carries NeRF-W's transient head."""
    return (config.transient_type == "nerfw"
            and config.nerfacto.use_transient_embedding)


def module_names(config) -> List[str]:
    """The top-level modules NerfactoModel builds for `config` (the first
    element of its parameter names), without building it."""
    nc = config.nerfacto
    nets = 1 if nc.use_same_proposal_network else nc.num_proposal_iterations
    names = ["field"] + [f"proposal_{i}" for i in range(nets)]
    if nc.use_appearance_embedding:
        names.append("appearance_embedding")
    if nc.use_transient_embedding:
        names.append("transient_embedding")
    if config.transient_type == "hanerf":
        names.append("implicit_mask")
    return names


def fused_mlp_widths(config) -> Dict[str, tuple]:
    """{module name: layer widths} of the MLPs NerfactoModel builds for
    `config` with enable_tcnn_mlp on for the field and every proposal net:
    the shapes its fused MLP kernel takes."""
    nc = config.nerfacto
    appearance = (nc.appearance_embedding_dim
                  if nc.use_appearance_embedding else 0)
    widths = {
        "field.mlp_base": (nc.num_levels * nc.features_per_level,
                           nc.hidden_dim, 1 + nc.geo_feat_dim),
        "field.mlp_head": (16 + nc.geo_feat_dim + appearance,
                           nc.hidden_dim_color, nc.hidden_dim_color, 3)}
    if has_transient_head(config):
        widths["field.mlp_transient"] = (
            nc.geo_feat_dim + nc.transient_embedding_dim,
            nc.hidden_dim_transient, nc.hidden_dim_transient, 5)
    nets = 1 if nc.use_same_proposal_network else nc.num_proposal_iterations
    for i in range(nets):
        args = nc.proposal_net_args_list[
            min(i, len(nc.proposal_net_args_list) - 1)]
        widths[f"proposal_{i}.mlp_base"] = (_grid_spec(args).output_dim,
                                            args.get("hidden_dim", 64), 1)
    return widths


class NerfactoField(nn.Module):
    """Hash grid -> density + geo_feat; SH(dir) + geo_feat [+ appearance]
    -> rgb; with `transient`, NeRF-W's head on geo_feat + the transient
    embedding -> transient density, rgb and uncertainty."""

    def __init__(self, nc: cfg.NerfactoConfig, bound: float,
                 contraction: bool, compute_dtype: torch.dtype,
                 generator: torch.Generator, fused_ok: bool = False,
                 transient: bool = False):
        super().__init__()
        self.bound, self.contraction = bound, contraction
        self.compute_dtype = compute_dtype
        spec = HashGridSpec(
            num_levels=nc.num_levels, features_per_level=nc.features_per_level,
            log2_hashmap_size=nc.log2_hashmap_size, base_res=nc.base_res,
            max_res=nc.max_res, hash_impl=nc.hash_impl)
        self.hashgrid = HashGridEncoding(spec, generator)
        self.mlp_base = _ReluMLP(spec.output_dim, nc.hidden_dim, 2,
                                 1 + nc.geo_feat_dim, compute_dtype,
                                 generator, fused=fused_ok)
        appearance_dim = (nc.appearance_embedding_dim
                          if nc.use_appearance_embedding else 0)
        self.mlp_head = _ReluMLP(16 + nc.geo_feat_dim + appearance_dim,
                                 nc.hidden_dim_color, 3, 3, compute_dtype,
                                 generator, fused=fused_ok)
        self.mlp_transient = (
            _ReluMLP(nc.geo_feat_dim + nc.transient_embedding_dim,
                     nc.hidden_dim_transient, 3, 5, compute_dtype, generator,
                     fused=fused_ok) if transient else None)

    def forward(self, positions, viewdirs, embedded_appearance=None,
                embedded_transient=None):
        grid_pos, selector = _normalize_positions(positions, self.bound,
                                                  self.contraction)
        h = self.mlp_base(self.hashgrid(grid_pos))
        raw_density, geo_feat = h[..., :1].float(), h[..., 1:]
        density = trunc_exp(raw_density) * selector[..., None]
        color_in = [sh_encode(viewdirs, degree=4).to(self.compute_dtype),
                    geo_feat]
        if embedded_appearance is not None:
            color_in.append(embedded_appearance.to(self.compute_dtype))
        raw_rgb = self.mlp_head(torch.cat(color_in, dim=-1))
        outputs = {"density": density[..., 0],
                   "rgb": torch.sigmoid(raw_rgb.float())}
        if self.mlp_transient is not None:
            out = self.mlp_transient(torch.cat(
                [geo_feat, embedded_transient.to(self.compute_dtype)],
                dim=-1)).float()
            outputs["density_transient"] = (
                trunc_exp(out[..., :1]) * selector[..., None])[..., 0]
            outputs["rgb_transient"] = torch.sigmoid(out[..., 1:4])
            outputs["uncertainty"] = F.softplus(out[..., 4:])
        return outputs


class HashMLPDensityField(nn.Module):
    """Density-only proposal field."""

    def __init__(self, args: Dict[str, Any], bound: float, contraction: bool,
                 compute_dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.bound, self.contraction = bound, contraction
        spec = _grid_spec(args)
        self.hashgrid = HashGridEncoding(spec, generator)
        self.mlp_base = _ReluMLP(spec.output_dim, args.get("hidden_dim", 64),
                                 2, 1, compute_dtype, generator,
                                 fused=args.get("enable_tcnn_mlp", False))

    def forward(self, positions):
        grid_pos, selector = _normalize_positions(positions, self.bound,
                                                  self.contraction)
        raw = self.mlp_base(self.hashgrid(grid_pos))
        density = trunc_exp(raw.float()) * selector[..., None]
        return density[..., 0]


# HashImplicitMask's grid (JAX nerfacto.py:211-213): 16 levels of 2^19
# rows over the pixel coordinates, resolution 16 to 2048.
MASK_GRID = HashGridSpec(num_levels=16, features_per_level=2,
                         log2_hashmap_size=19, base_res=16, max_res=2048,
                         num_dims=2)


class HashImplicitMask(nn.Module):
    """HA-NeRF's implicit mask: the 2-D hash grid on the pixel coordinates
    and the transient embedding through a Dense ReLU MLP (-> 64 -> 64 -> 1)
    in the compute dtype, then a sigmoid in fp32 (JAX nerfacto.py:204-219)."""

    def __init__(self, transient_embedding_dim: int,
                 compute_dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.hashgrid = HashGridEncoding(MASK_GRID, generator)
        self.mlp = _ReluMLP(MASK_GRID.output_dim + transient_embedding_dim,
                            64, 3, 1, compute_dtype, generator)

    def forward(self, coords, embedded_transient):
        x = torch.cat([self.hashgrid(coords), embedded_transient], -1)
        return torch.sigmoid(self.mlp(x).float())


def _embedding(num: int, dim: int, generator: torch.Generator) -> nn.Embedding:
    """flax nn.Embed's default init: normal with variance 1 / dim."""
    embed = nn.Embedding(num, dim)
    with torch.no_grad():
        embed.weight.normal_(0.0, 1.0 / math.sqrt(dim), generator=generator)
    return embed


class NerfactoModel(nn.Module):
    """Proposal sampling + field + compositing for one ray batch.

    Parameters are drawn on the CPU from `generator` (so one seed gives the
    same weights on every device) and then moved to `device`."""

    def __init__(self, config, device, generator: torch.Generator):
        super().__init__()
        check_transient_config(config)
        nc = config.nerfacto
        self.config = config
        contraction = config.enable_scene_contraction
        bound = float(config.bound)
        cdt = torch.bfloat16 if config.enable_amp else torch.float32
        # The field follows the top-level switch; each proposal net its
        # own proposal_net_args_list entry's (JAX nerfacto.py:259, 272, 283).
        self.field = NerfactoField(nc, bound, contraction, cdt, generator,
                                   fused_ok=nc.enable_tcnn_mlp,
                                   transient=has_transient_head(config))
        self.prop_nets: List[HashMLPDensityField] = []
        if nc.use_same_proposal_network:
            if len(nc.proposal_net_args_list) != 1:
                raise ValueError("use_same_proposal_network requires exactly "
                                 "one proposal_net_args_list entry")
            args = dict(nc.proposal_net_args_list[0])
            args.setdefault("hash_impl", nc.hash_impl)
            self.proposal_0 = HashMLPDensityField(args, bound, contraction,
                                                  cdt, generator)
            self.prop_nets = [self.proposal_0] * nc.num_proposal_iterations
        else:
            for i in range(nc.num_proposal_iterations):
                args = dict(nc.proposal_net_args_list[
                    min(i, len(nc.proposal_net_args_list) - 1)])
                args.setdefault("hash_impl", nc.hash_impl)
                net = HashMLPDensityField(args, bound, contraction, cdt,
                                          generator)
                self.add_module(f"proposal_{i}", net)
                self.prop_nets.append(net)
        # Each table exists whenever its switch is on, whatever the eval
        # mode (the flax init-touch of JAX nerfacto.py:229-235).
        num = config.model.num_embeddings
        self.appearance_embedding = (
            _embedding(num, nc.appearance_embedding_dim, generator)
            if nc.use_appearance_embedding else None)
        self.transient_embedding = (
            _embedding(num, nc.transient_embedding_dim, generator)
            if nc.use_transient_embedding else None)
        self.implicit_mask = (
            HashImplicitMask(nc.transient_embedding_dim, cdt, generator)
            if config.transient_type == "hanerf" else None)
        sampler = nc.proposal_initial_sampler
        warps = {"piecewise": "piecewise", "uniform": None,
                 "reciprocal": torch.reciprocal}
        if sampler not in warps:
            raise ValueError(f"unknown proposal_initial_sampler {sampler!r}")
        self._warp_fn = warps[sampler]
        self.to(device)

    def proposal_schedule(self, train_frac: float):
        """(anneal, update_prop): the Schlick-biased proposal anneal and the
        warmup-interpolated update gating, in float32 like the jitted JAX
        arithmetic (nerf_hugs_tpu/models/nerfacto.py:318-329)."""
        nc = self.config.nerfacto
        f32 = np.float32
        curr_step = f32(train_frac) * f32(self.config.max_steps)
        frac = np.clip(curr_step / f32(nc.proposal_weights_anneal_max_num_iters),
                       f32(0), f32(1))
        s = f32(nc.proposal_weights_anneal_slope)
        anneal = (s * frac) / ((s - f32(1)) * frac + f32(1))
        interval = np.floor(np.clip(
            curr_step * f32(nc.proposal_update_every)
            / f32(max(nc.proposal_warmup, 1)),
            f32(1), f32(nc.proposal_update_every)))
        update_prop = bool((np.round(curr_step) % interval) < 0.5)
        return float(anneal), update_prop

    def _get_embedding(self, embed: nn.Embedding, embed_idx: torch.Tensor,
                       deterministic: bool, zero: bool) -> torch.Tensor:
        """[..., dim] rows of `embed` at `embed_idx`, under the
        eval_embedding modes (JAX nerfacto.py:226-243): zeros when `zero`,
        and on the deterministic path zeros ('zero') or the table's mean
        ('average'); else the rows ('original')."""
        mode = self.config.nerfacto.eval_embedding
        shape = embed_idx.shape + (embed.embedding_dim,)
        if zero or (deterministic and mode == "zero"):
            return torch.zeros(shape, device=embed.weight.device)
        if deterministic and mode == "average":
            return embed.weight.mean(dim=0).expand(shape)
        return embed(embed_idx)

    def forward(self, rays: structs.Rays, train_frac: float,
                compute_extras: bool,
                rng: Optional[torch.Generator] = None,
                zero_glo: bool = True, zero_tra: bool = True):
        """zero_glo / zero_tra zero the appearance / transient embeddings:
        training passes False for both, rendering the config's
        enable_render_zero_glo / enable_render_zero_tra."""
        nc = self.config.nerfacto
        deterministic = rng is None
        _, s_to_t = coord.construct_ray_warps(self._warp_fn, rays.near,
                                              rays.far)
        anneal, update_prop = self.proposal_schedule(train_frac)

        sdist = torch.cat([torch.zeros_like(rays.near),
                           torch.ones_like(rays.far)], dim=-1)
        weights = torch.ones_like(rays.near)
        renderings: List[dict] = []
        ray_history: List[dict] = []
        for i_level in range(nc.num_proposal_iterations + 1):
            is_prop = i_level < nc.num_proposal_iterations
            num_samples = (nc.num_proposal_samples_per_ray[i_level] if is_prop
                           else nc.num_nerf_samples_per_ray)
            # Sampling takes no gradient (the JAX stop_gradient); under
            # no_grad the -inf logits of empty intervals cannot leak NaNs
            # into a backward pass either.
            with torch.no_grad():
                logits = torch.where(
                    sdist[..., 1:] > sdist[..., :-1],
                    torch.log(weights + nc.proposal_histogram_padding)
                    * anneal,
                    torch.full_like(weights, -float("inf")))
                sdist = stepfun.sample_intervals(
                    rng, sdist, logits, num_samples,
                    single_jitter=nc.use_single_jitter, domain=(0.0, 1.0))
            tdist = s_to_t(sdist)
            t_mids = 0.5 * (tdist[..., 1:] + tdist[..., :-1])
            positions = (rays.origins[..., None, :]
                         + rays.directions[..., None, :] * t_mids[..., None])

            if is_prop:
                # Gradient gating: the proposal net trains only on update
                # steps; otherwise its densities are constants and its
                # backward never runs.
                with torch.set_grad_enabled(torch.is_grad_enabled()
                                            and update_prop):
                    density = self.prop_nets[i_level](positions)
                field_outputs = {"density": density}
            else:
                # One embedding row per ray, the same for each of its
                # samples.
                per_sample = lambda embed, zero: self._get_embedding(
                    embed, rays.embed_idx, deterministic, zero).expand(
                        positions.shape[:-1] + (-1,))
                emb_a = (per_sample(self.appearance_embedding, zero_glo)
                         if self.appearance_embedding is not None else None)
                emb_t = (per_sample(self.transient_embedding, zero_tra)
                         if self.field.mlp_transient is not None else None)
                vd = rays.viewdirs[..., None, :].expand(positions.shape)
                field_outputs = self.field(positions, vd, emb_a, emb_t)

            weights = render.compute_alpha_weights(
                field_outputs["density"], tdist, rays.directions,
                opaque_background=nc.opaque_background,
                cumulative_from_first=nc.legacy_cumulative_deltas)[0]
            weights = torch.nan_to_num(weights)

            history = {"sdist": sdist, "weights": weights,
                       "density": field_outputs["density"]}
            if not is_prop:
                bg_rgbs = self._background(rng, weights.shape[:-1] + (3,),
                                           weights.device)
                rendering = render.volumetric_rendering(
                    field_outputs["rgb"], weights, tdist, bg_rgbs, rays.far,
                    compute_extras)
                if rng is not None:
                    rendering["bg_rgb"] = bg_rgbs
                if "density_transient" in field_outputs:
                    self._render_transient(rendering, history, field_outputs,
                                           tdist, rays.directions, bg_rgbs)
                renderings.append(rendering)
            ray_history.append(history)
        if self.implicit_mask is not None:
            emb_t = self._get_embedding(self.transient_embedding,
                                        rays.embed_idx[..., 0], deterministic,
                                        zero_tra)
            renderings[-1]["implicit_mask"] = self.implicit_mask(
                rays.pix_coords, emb_t)
        return renderings, ray_history

    def _render_transient(self, rendering: dict, history: dict,
                          field_outputs: dict, tdist, directions,
                          bg_rgbs) -> None:
        """NeRF-W's buffers (JAX nerfacto.py:413-435): the static and
        transient colours over their shared transmittance, and the per-ray
        uncertainty beta = sum of the transient-only weights x u +
        beta_min."""
        nc = self.config.nerfacto
        switches = dict(opaque_background=nc.opaque_background,
                        cumulative_from_first=nc.legacy_cumulative_deltas)
        density_t = field_outputs["density_transient"]
        w_s, w_t, w_c = render.compute_dual_alpha_weights(
            field_outputs["density"], density_t, tdist, directions,
            **switches)
        (rendering["rgb_combined"], rendering["rgb_static"],
         rendering["rgb_transient"]) = render.composite_combined_color(
            field_outputs["rgb"], field_outputs["rgb_transient"], bg_rgbs,
            w_s, w_t, w_c)
        w_tr = render.compute_alpha_weights(density_t, tdist, directions,
                                            **switches)[0]
        rendering["uncertainty"] = (
            (w_tr[..., None] * field_outputs["uncertainty"]).sum(dim=-2)
            + self.config.model.beta_min)
        history["density_transient"] = density_t

    def _background(self, rng: Optional[torch.Generator], shape, device):
        color = (self.config.train_background_color if rng is not None
                 else self.config.test_background_color)
        if color == "random" and rng is not None:
            return torch.rand(shape, generator=rng, device=device)
        return torch.full(shape, cfg.BACKGROUND_VALUES[color], device=device)
