"""A plain nerfacto (nerfstudio's nerfacto as NeRF-HuGS configures it):
proposal sampling over hash-grid density fields, a hash-grid field with a
ReLU MLP to density and geometry features, spherical harmonics of the view
direction into a colour MLP, alpha compositing over the background, the
mean squared error and the interlevel loss.

In float32 throughout (the configuration's bfloat16 MLPs are the
program's business), or with `precision` fp8 for the control. Supports the
configuration's options only: a uniform initial sampler, xor hashing, no
scene contraction, no embeddings, no transient head; `check` refuses
others. Parameter names are the program's state-dict keys.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference import common
from benchmark.reference.hashgrid import Grid, encode


class _TruncExp(torch.autograd.Function):
    """exp(x), whose slope is taken at x clamped to [-15, 15]."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.exp(torch.clamp(x, -15.0, 15.0)) * g


def sh_encode(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics of degree 4 (16 features), tiny-cuda-nn's
    constants."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    out = [torch.full_like(x, 0.28209479177387814),
           -0.48860251190291987 * y, 0.48860251190291987 * z,
           -0.48860251190291987 * x,
           1.0925484305920792 * xy, -1.0925484305920792 * yz,
           0.94617469575755997 * zz - 0.31539156525251999,
           -1.0925484305920792 * xz, 0.54627421529603959 * (xx - yy),
           0.59004358992664352 * y * (-3.0 * xx + yy),
           2.8906114426405538 * xy * z,
           0.45704579946446572 * y * (1.0 - 5.0 * zz),
           0.3731763325901154 * z * (5.0 * zz - 3.0),
           0.45704579946446572 * x * (1.0 - 5.0 * zz),
           1.4453057213202769 * z * (xx - yy),
           0.59004358992664352 * x * (-xx + 3.0 * yy)]
    return torch.stack(out, dim=-1)


def field_grid(v: dict) -> Grid:
    return Grid(v["nerfacto.num_levels"], v["nerfacto.features_per_level"],
                v["nerfacto.log2_hashmap_size"], v["nerfacto.base_res"],
                v["nerfacto.max_res"])


def proposal_grids(v: dict) -> List[Tuple[Grid, int]]:
    """(grid, MLP width) of each proposal net."""
    out = []
    for args in v["nerfacto.proposal_net_args_list"]:
        out.append((Grid(args["num_levels"], args["features_per_level"],
                         args["log2_hashmap_size"], args["base_res"],
                         args["max_res"]), args["hidden_dim"]))
    return out


def check(v: dict) -> None:
    """Refuse options this reference does not compute."""
    wanted = {"nerfacto.proposal_initial_sampler": "uniform",
              "nerfacto.hash_impl": "xor",
              "enable_scene_contraction": False,
              "nerfacto.use_appearance_embedding": False,
              "nerfacto.use_transient_embedding": False,
              "nerfacto.use_same_proposal_network": False,
              "nerfacto.enable_tcnn_mlp": False,
              "nerfacto.legacy_cumulative_deltas": False,
              "transient_type": None, "distortion_loss_mult": 0.0}
    bad = {k: v[k] for k, want in wanted.items() if v[k] != want}
    if bad or v["nerfacto.num_proposal_iterations"] != len(
            v["nerfacto.proposal_net_args_list"]):
        raise ValueError(f"the nerfacto reference does not compute {bad}")


def _mlp(prefix: str, dims) -> list:
    specs = []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        specs.append((f"{prefix}.layers.{i}.weight", (d_out, d_in),
                      math.sqrt(6.0 / d_in)))
        specs.append((f"{prefix}.layers.{i}.bias", (d_out,), 0.0))
    return specs


def param_specs(v: dict) -> list:
    """[(name, shape, half-width of its uniform initial draw)]: he_uniform
    weights, zero biases, tables uniform in +-1e-4."""
    check(v)
    g = field_grid(v)
    hidden, geo = v["nerfacto.hidden_dim"], v["nerfacto.geo_feat_dim"]
    color = v["nerfacto.hidden_dim_color"]
    specs = [("field.hashgrid.table", (g.num_rows * g.features_per_level,),
              1e-4)]
    specs += _mlp("field.mlp_base", (g.output_dim, hidden, 1 + geo))
    specs += _mlp("field.mlp_head", (16 + geo, color, color, 3))
    for i, (pg, width) in enumerate(proposal_grids(v)):
        specs.append((f"proposal_{i}.hashgrid.table",
                      (pg.num_rows * pg.features_per_level,), 1e-4))
        specs += _mlp(f"proposal_{i}.mlp_base", (pg.output_dim, width, 1))
    return specs


def _relu_mlp(P, prefix: str, x, n_layers: int, precision: str):
    for i in range(n_layers):
        x = common.linear(x, P[f"{prefix}.layers.{i}.weight"],
                          P[f"{prefix}.layers.{i}.bias"], precision)
        if i < n_layers - 1:
            x = torch.relu(x)
    return x


def _grid_positions(positions, bound: float):
    """World positions -> [0, 1]^3 and whether they lie in the box."""
    p = (positions + bound) / (2 * bound)
    inside = torch.all((p >= 0.0) & (p <= 1.0), dim=-1)
    return p * inside[..., None], inside


def proposal_schedule(train_frac: float, v: dict):
    """(anneal, whether the proposal nets train this step), in float32."""
    f32 = np.float32
    step = f32(train_frac) * f32(v["max_steps"])
    frac = np.clip(step / f32(v["nerfacto.proposal_weights_anneal_max_num_iters"]),
                   f32(0), f32(1))
    s = f32(v["nerfacto.proposal_weights_anneal_slope"])
    anneal = (s * frac) / ((s - f32(1)) * frac + f32(1))
    every = v["nerfacto.proposal_update_every"]
    interval = np.floor(np.clip(
        step * f32(every) / f32(max(v["nerfacto.proposal_warmup"], 1)),
        f32(1), f32(every)))
    return float(anneal), bool((np.round(step) % interval) < 0.5)


def forward(P: Dict[str, torch.Tensor], rays: dict, train_frac: float,
            gen: torch.Generator, v: dict, precision: str):
    """(rgb [n, 3], [(sdist, weights)] of every level)."""
    bound = float(v["bound"])
    near, far = rays["near"], rays["far"]
    s_to_t = lambda s: s * far + (1 - s) * near
    anneal, update_prop = proposal_schedule(train_frac, v)
    sdist = torch.cat([torch.zeros_like(near), torch.ones_like(far)], -1)
    weights = torch.ones_like(near)
    props = proposal_grids(v)
    history = []
    for level in range(len(props) + 1):
        is_prop = level < len(props)
        n = (v["nerfacto.num_proposal_samples_per_ray"][level] if is_prop
             else v["nerfacto.num_nerf_samples_per_ray"])
        with torch.no_grad():
            logits = torch.where(
                sdist[..., 1:] > sdist[..., :-1],
                torch.log(weights + v["nerfacto.proposal_histogram_padding"])
                * anneal, torch.full_like(weights, -float("inf")))
            sdist = common.sample_intervals(
                gen, sdist, logits, n, v["nerfacto.use_single_jitter"],
                (0.0, 1.0))
        tdist = s_to_t(sdist)
        t_mids = 0.5 * (tdist[..., 1:] + tdist[..., :-1])
        positions = rays["origins"][..., None, :] \
            + rays["directions"][..., None, :] * t_mids[..., None]
        gp, inside = _grid_positions(positions, bound)
        if is_prop:
            grid, _ = props[level]
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and update_prop):
                raw = _relu_mlp(P, f"proposal_{level}.mlp_base",
                                encode(grid, P[f"proposal_{level}.hashgrid.table"],
                                       gp), 2, precision)
                density = (_TruncExp.apply(raw) * inside[..., None])[..., 0]
        else:
            h = _relu_mlp(P, "field.mlp_base",
                          encode(field_grid(v), P["field.hashgrid.table"],
                                 gp), 2, precision)
            density = (_TruncExp.apply(h[..., :1])
                       * inside[..., None])[..., 0]
            dirs = rays["viewdirs"][..., None, :].expand(positions.shape)
            raw_rgb = _relu_mlp(P, "field.mlp_head",
                                torch.cat([sh_encode(dirs), h[..., 1:]], -1),
                                3, precision)
            rgb = torch.sigmoid(raw_rgb)
        weights = torch.nan_to_num(common.alpha_weights(
            density, tdist, rays["directions"],
            v["nerfacto.opaque_background"]))
        history.append((sdist, weights))
    bg = common.draw_background(gen, weights.shape[:-1] + (3,),
                                weights.device, v["train_background_color"])
    return common.composite(rgb, weights, bg), history


def loss(P, rays, rgb_target, train_frac, gen, v, precision):
    """The data term (mse of the final level) plus the interlevel term."""
    rgb, history = forward(P, rays, train_frac, gen, v, precision)
    total = v["data_loss_mult"] * common.data_loss(rgb, rgb_target,
                                                   v["data_loss_type"])
    if v["interlevel_loss_mult"] > 0:
        total = total + common.interlevel_loss(history,
                                               v["interlevel_loss_mult"])
    return total


def step_flops(v: dict) -> float:
    """The model's matrix-product operations in one train step: 2 x the
    multiply-adds of each MLP a sample x its samples, three times over
    (forward, weight gradients, input gradients: every MLP's input takes a
    gradient, from a hash table or from the geometry features)."""
    g = field_grid(v)
    hidden, geo = v["nerfacto.hidden_dim"], v["nerfacto.geo_feat_dim"]
    color = v["nerfacto.hidden_dim_color"]
    macs = lambda dims: sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    field = (macs((g.output_dim, hidden, 1 + geo))
             + macs((16 + geo, color, color, 3)))
    total = field * v["nerfacto.num_nerf_samples_per_ray"]
    for (pg, width), n in zip(proposal_grids(v),
                              v["nerfacto.num_proposal_samples_per_ray"]):
        total += macs((pg.output_dim, width, 1)) * n
    return 2.0 * 3.0 * v["batch_size"] * total
