"""PosEnc MLP, the Mip-NeRF 360 field network, and HA-NeRF's implicit mask.

Twin of nerf_hugs_tpu/models/mlp.py (MipNeRF360/internal/models.py:
360-560, 651-675). PosEncMLP: Gaussians (optionally contracted by
linearization) -> lifted onto a geodesic basis and diagonalized ->
integrated positional encoding -> density trunk with skip concatenations
-> bottleneck -> [viewdir encoding | GLO] -> colour head, and NeRF-W's
transient head (transient density, colour, uncertainty) off the same
bottleneck.

Layers are flax Dense twins named Dense_k in flax's construction order
(models/from_jax.py relies on it): torch Linears with fp32 parameters,
whose inputs, weights and biases are cast to the compute dtype inside
every layer, as flax `Dense(dtype=...)` promotes them; the density,
colour and uncertainty heads go back to fp32. Weights are he_uniform and
biases zero, drawn from an explicit generator. With `remat`, the network
runs under torch.utils.checkpoint (its activations are recomputed in the
backward pass), as flax's nn.remat; the noise is drawn before it, so the
recomputation sees the same draws.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from nerf_hugs_torch.configs import config as cfg
from nerf_hugs_torch.core import coord, geopoly


def _he_uniform(d_in: int, d_out: int,
                generator: torch.Generator) -> nn.Linear:
    """flax Dense's he_uniform kernel (uniform(+-sqrt(6 / fan_in))) and
    zero bias."""
    lin = nn.Linear(d_in, d_out)
    limit = math.sqrt(6.0 / d_in)
    with torch.no_grad():
        lin.weight.uniform_(-limit, limit, generator=generator)
        lin.bias.zero_()
    return lin


def _dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype):
    """flax Dense(dtype=dtype): input, kernel and bias in `dtype`."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


class _Layers:
    """Adds Dense_k layers to a module in construction order; each call
    returns the new layer's name (the module holds the layer itself)."""

    def __init__(self, module: nn.Module, generator: torch.Generator):
        self.module, self.generator, self.count = module, generator, 0

    def __call__(self, d_in: int, d_out: int) -> str:
        name = f"Dense_{self.count}"
        self.module.add_module(name, _he_uniform(d_in, d_out,
                                                 self.generator))
        self.count += 1
        return name


def _skip_stack(layers: _Layers, d_in: int, width: int, depth: int,
                skip: int):
    """`depth` layers of `width` whose outputs at i % skip == 0, i > 0 are
    concatenated with the stack's input; returns (layers, output dim)."""
    stack, d = [], d_in
    for i in range(depth):
        stack.append(layers(d, width))
        d = width + (d_in if i % skip == 0 and i > 0 else 0)
    return stack, d


def _run_stack(module: nn.Module, x, stack: List[str], skip: int, act,
               dtype):
    inputs = x
    for i, name in enumerate(stack):
        x = act(_dense(x, getattr(module, name), dtype))
        if i % skip == 0 and i > 0:
            x = torch.cat([x, inputs], dim=-1)
    return x


class PosEncMLP(nn.Module):
    """The integrated-positional-encoding MLP of an MLPConfig. glo_dim and
    tra_dim are the widths of the GLO and transient vectors the caller
    will pass (0: none)."""

    def __init__(self, mlp_config: cfg.MLPConfig, compute_dtype: torch.dtype,
                 generator: torch.Generator, use_viewdirs: bool = True,
                 glo_dim: int = 0, tra_dim: int = 0, remat: bool = False):
        super().__init__()
        c = self.mlp_config = mlp_config
        if c.weight_init != "he_uniform":
            raise ValueError(f"weight_init {c.weight_init!r} is not ported")
        self.compute_dtype = compute_dtype
        self.remat = remat
        basis = geopoly.generate_basis(c.basis_shape, c.basis_subdivisions)
        self.register_buffer("pos_basis_t", torch.tensor(
            np.ascontiguousarray(basis.T), dtype=torch.float32),
            persistent=False)
        self.net_activation = cfg.resolve_activation(c.net_activation)
        self.density_activation = cfg.resolve_activation(c.density_activation)
        self.rgb_activation = cfg.resolve_activation(c.rgb_activation)
        self.uncertainty_activation = cfg.resolve_activation(
            c.uncertainty_activation)
        self.warp_fn = cfg.resolve_warp_fn(c.warp_fn)

        layers = _Layers(self, generator)
        feat_dim = 2 * basis.shape[0] * (c.max_deg_point - c.min_deg_point)
        self.trunk, d = _skip_stack(layers, feat_dim, c.net_width,
                                    c.net_depth, c.skip_layer)
        self.density_head = layers(d, 1)
        self.bottleneck = self.view = self.rgb_head = None
        self.transient = None
        if c.disable_rgb:
            return
        if use_viewdirs:
            if c.bottleneck_width > 0:
                self.bottleneck = layers(d, c.bottleneck_width)
            view_in = (max(c.bottleneck_width, 0) + 3 + 6 * c.deg_view
                       + glo_dim)
            self.view, d = _skip_stack(layers, view_in, c.net_width_viewdirs,
                                       c.net_depth_viewdirs, c.skip_layer_dir)
        self.rgb_head = layers(d, c.num_rgb_channels)
        if tra_dim > 0 and not c.disable_transient:
            stack, d = _skip_stack(layers, c.bottleneck_width + tra_dim,
                                   c.net_width_transient,
                                   c.net_depth_transient,
                                   c.skip_layer_transient)
            self.transient = stack + [layers(d, 1),
                                      layers(d, c.num_rgb_channels),
                                      layers(d, 1)]

    def forward(self, rng: Optional[torch.Generator], gaussians,
                viewdirs=None, glo_vec=None, tra_vec=None) -> dict:
        """rng: draws the density and bottleneck noise (None: none)."""
        c = self.mlp_config
        means = gaussians[0]
        lead = means.shape[:-1]
        dev = means.device
        density_noise = bottleneck_noise = None
        if rng is not None and c.density_noise > 0:
            density_noise = c.density_noise * torch.randn(
                lead, generator=rng, device=dev)
        if (rng is not None and c.bottleneck_noise > 0
                and self.bottleneck is not None and viewdirs is not None):
            bottleneck_noise = c.bottleneck_noise * torch.randn(
                lead + (c.bottleneck_width,), generator=rng, device=dev)
        args = (gaussians[0], gaussians[1], viewdirs, glo_vec, tra_vec,
                density_noise, bottleneck_noise)
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._body, *args, use_reentrant=False)
        return self._body(*args)

    def _body(self, means, covs, viewdirs, glo_vec, tra_vec, density_noise,
              bottleneck_noise) -> dict:
        c = self.mlp_config
        cdt = self.compute_dtype
        dense = lambda x, name: _dense(x, getattr(self, name), cdt)
        if self.warp_fn is not None:
            means, covs = coord.track_linearize(self.warp_fn, means, covs)
        lifted_means, lifted_vars = coord.lift_and_diagonalize(
            means, covs, self.pos_basis_t)
        feats = coord.integrated_pos_enc(lifted_means, lifted_vars,
                                         c.min_deg_point, c.max_deg_point)

        x = _run_stack(self, feats.to(cdt), self.trunk, c.skip_layer,
                       self.net_activation, cdt)
        raw_density = dense(x, self.density_head)[..., 0].float()
        if density_noise is not None:
            raw_density = raw_density + density_noise
        outputs = {"density": self.density_activation(raw_density
                                                      + c.density_bias)}
        if c.disable_rgb:
            outputs["rgb"] = torch.zeros_like(means)
            return outputs

        bottleneck = None
        if viewdirs is not None:
            branches = []
            if self.bottleneck is not None:
                bottleneck = dense(x, self.bottleneck)
                if bottleneck_noise is not None:
                    bottleneck = bottleneck + bottleneck_noise.to(cdt)
                branches.append(bottleneck)
            lead = x.shape[:-1]
            dir_enc = coord.pos_enc(viewdirs, min_deg=0, max_deg=c.deg_view)
            branches.append(dir_enc[..., None, :].expand(
                lead + dir_enc.shape[-1:]).to(cdt))
            if glo_vec is not None:
                branches.append(glo_vec[..., None, :].expand(
                    lead + glo_vec.shape[-1:]).to(cdt))
            x = _run_stack(self, torch.cat(branches, dim=-1), self.view,
                           c.skip_layer_dir, self.net_activation, cdt)

        raw_rgb = dense(x, self.rgb_head).float()
        rgb = self.rgb_activation(c.rgb_premultiplier * raw_rgb + c.rgb_bias)
        outputs["rgb"] = rgb * (1 + 2 * c.rgb_padding) - c.rgb_padding

        if tra_vec is not None and self.transient is not None:
            tra = tra_vec[..., None, :].expand(
                bottleneck.shape[:-1] + tra_vec.shape[-1:])
            *stack, density_t, rgb_t, uncertainty = self.transient
            x = _run_stack(self, torch.cat([bottleneck, tra.to(cdt)], dim=-1),
                           stack, c.skip_layer_transient,
                           self.net_activation, cdt)
            raw_density_t = dense(x, density_t)[..., 0].float()
            outputs["density_transient"] = self.density_activation(
                raw_density_t + c.density_bias)
            raw_rgb_t = dense(x, rgb_t).float()
            rgb_t = self.rgb_activation(c.rgb_premultiplier * raw_rgb_t
                                        + c.rgb_bias)
            outputs["rgb_transient"] = (rgb_t * (1 + 2 * c.rgb_padding)
                                        - c.rgb_padding)
            outputs["uncertainty"] = self.uncertainty_activation(
                dense(x, uncertainty).float())
        return outputs


class ImplicitMask(nn.Module):
    """HA-NeRF's 2-D implicit mask: PE(pixel coords) + the transient
    vector -> net_depth ReLU layers -> sigmoid, in fp32."""

    def __init__(self, tra_dim: int, generator: torch.Generator,
                 net_depth: int = 4, net_width: int = 256,
                 deg_coord: int = 10):
        super().__init__()
        self.deg_coord = deg_coord
        layers = _Layers(self, generator)
        d = 2 + 4 * deg_coord + tra_dim
        self.hidden = []
        for _ in range(net_depth):
            self.hidden.append(layers(d, net_width))
            d = net_width
        self.out = layers(d, 1)

    def forward(self, pix_coords, tra_vec):
        x = torch.cat([coord.pos_enc(pix_coords, min_deg=0,
                                     max_deg=self.deg_coord), tra_vec],
                      dim=-1)
        for name in self.hidden:
            x = F.relu(getattr(self, name)(x))
        return torch.sigmoid(getattr(self, self.out)(x))
