"""Segment Anything (SAM) in PyTorch, the port of
nerf_hugs_tpu/hugs/sam/modeling.py.

The SAM architecture (Kirillov et al. 2023; segment-anything, used by
HuGS/generate_static_mask.py:12-13, 190-202) in three parts:
  * ImageEncoderViT: a ViT with a 16x16 patch embedding, decomposed
    relative-position attention, window attention except at the global
    blocks, and a 256-channel convolutional neck. vit_h: 1280 wide, 32
    deep.
  * PromptEncoder: a random-Fourier positional embedding of points plus
    learned point-label embeddings, and the dense no-mask embedding
    (points only: the HuGS pipeline never gives a box or a mask prompt).
  * MaskDecoder: a two-way transformer (2 layers of tokens <-> image
    cross-attention), a 4x upscaling head, per-mask-token hypernetwork
    MLPs and an IoU head.

Parameter names are segment-anything's own state-dict keys
(`image_encoder.blocks.{i}.attn.qkv.weight`,
`mask_decoder.output_upscaling.{0,1,3}`, ...), so an official checkpoint
loads as it is (hugs/sam/weights.py) once its
`prompt_encoder.mask_downscaling.*` keys are dropped, and the layouts are
segment-anything's: the encoder's blocks run over BHWC tensors, the neck,
the image embedding and the decoder's upscaling over NCHW.

The numerics follow the JAX package wherever it differs from
segment-anything (ROADMAP.md Queue 3): every LayerNorm has epsilon 1e-6
(flax's default; segment-anything's decoder uses torch's 1e-5), point
prompts are normalised without segment-anything's half-pixel shift, and
the relative-position tables are resized with antialiasing when they
shrink, as jax.image.resize does. Attention is written out as JAX writes
it: (q * scale) @ k^T plus the decomposed relative-position bias, softmax,
then @ v. Float32 throughout, with TF32 off (utils/device.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# flax.linen.LayerNorm's default epsilon, used by every LayerNorm of the
# JAX model.
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class SamConfig:
    image_size: int = 1024
    patch_size: int = 16
    encoder_embed_dim: int = 1280      # vit_h
    encoder_depth: int = 32
    encoder_num_heads: int = 16
    encoder_global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    window_size: int = 14
    prompt_embed_dim: int = 256
    mask_threshold: float = 0.0
    pixel_mean: Tuple[float, ...] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, ...] = (58.395, 57.12, 57.375)


VIT_CONFIGS = {
    "vit_b": dict(encoder_embed_dim=768, encoder_depth=12,
                  encoder_num_heads=12,
                  encoder_global_attn_indexes=(2, 5, 8, 11)),
    "vit_l": dict(encoder_embed_dim=1024, encoder_depth=24,
                  encoder_num_heads=16,
                  encoder_global_attn_indexes=(5, 11, 17, 23)),
    "vit_h": dict(encoder_embed_dim=1280, encoder_depth=32,
                  encoder_num_heads=16,
                  encoder_global_attn_indexes=(7, 15, 23, 31)),
    # Tiny config for tests.
    "vit_t": dict(encoder_embed_dim=64, encoder_depth=2,
                  encoder_num_heads=2, encoder_global_attn_indexes=(1,)),
}


def make_sam_config(model_type: str, **overrides) -> SamConfig:
    if model_type == "default":
        model_type = "vit_h"
    return SamConfig(**{**VIT_CONFIGS[model_type], **overrides})


class LayerNorm2d(nn.Module):
    """Channel-wise LayerNorm over NCHW feature maps (SAM's LayerNorm2d)."""

    def __init__(self, num_channels: int, eps: float = LN_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.eps = eps

    def forward(self, x):
        mean = x.mean(1, keepdim=True)
        var = (x - mean).pow(2).mean(1, keepdim=True)
        x = (x - mean) / torch.sqrt(var + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


def _get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor
                 ) -> torch.Tensor:
    """Select (interpolating if needed) relative positional embeddings:
    [q_size, k_size, dim]. A table of another length than the sizes ask
    for (a checkpoint of another window) is resized linearly with
    half-pixel centres, antialiased when it shrinks, as jax.image.resize
    "linear" does."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        # [L, C] -> [1, C, 1, L]: a bilinear resize along L alone (the
        # antialiased resize of a [1, C, L, 1] map returns wrong values).
        resized = F.interpolate(rel_pos.t()[None, :, None, :],
                                size=(1, max_rel_dist), mode="bilinear",
                                align_corners=False, antialias=True)
        rel_pos = resized[0, :, 0, :].t()
    dev = rel_pos.device
    q_coords = torch.arange(q_size, device=dev)[:, None] * max(
        k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=dev)[None, :] * max(
        q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


def _add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_hw, k_hw):
    """SAM's decomposed relative position bias (mvitv2 style)."""
    q_h, q_w = q_hw
    k_h, k_w = k_hw
    rh = _get_rel_pos(q_h, k_h, rel_pos_h)  # [q_h, k_h, dim]
    rw = _get_rel_pos(q_w, k_w, rel_pos_w)
    b, _, dim = q.shape
    r_q = q.reshape(b, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    attn = attn.view(b, q_h, q_w, k_h, k_w)
    attn = attn + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]
    return attn.view(b, q_h * q_w, k_h * k_w)


class Attention(nn.Module):
    """Multi-head attention over a BHWC map with relative positions."""

    def __init__(self, dim: int, num_heads: int,
                 input_size: Tuple[int, int]):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(
            torch.zeros(2 * input_size[0] - 1, head_dim))
        self.rel_pos_w = nn.Parameter(
            torch.zeros(2 * input_size[1] - 1, head_dim))

    def forward(self, x):  # x: [B, H, W, C]
        b, h, w, c = x.shape
        head_dim = c // self.num_heads
        qkv = self.qkv(x.reshape(b, h * w, c))
        qkv = qkv.reshape(b, h * w, 3, self.num_heads, head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).reshape(
            3, b * self.num_heads, h * w, head_dim).unbind(0)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        attn = _add_decomposed_rel_pos(attn, q, self.rel_pos_h,
                                       self.rel_pos_w, (h, w), (h, w))
        attn = attn.softmax(dim=-1)
        x = (attn @ v).view(b, self.num_heads, h, w, head_dim)
        x = x.permute(0, 2, 3, 1, 4).reshape(b, h, w, c)
        return self.proj(x)


def window_partition(x, window_size: int):
    """[B, H, W, C] -> ([B * nW, ws, ws, C], (Hp, Wp)), zero-padded at the
    bottom and right to a multiple of the window."""
    b, h, w, c = x.shape
    pad_h = (window_size - h % window_size) % window_size
    pad_w = (window_size - w % window_size) % window_size
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // window_size, window_size, wp // window_size,
               window_size, c)
    windows = x.permute(0, 1, 3, 2, 4, 5).reshape(
        -1, window_size, window_size, c)
    return windows, (hp, wp)


def window_unpartition(windows, window_size: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window_size ** 2)
    x = windows.view(b, hp // window_size, wp // window_size, window_size,
                     window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w, :]


class MLPBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, act: str):
        super().__init__()
        self.lin1 = nn.Linear(dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, dim)
        self.act = act

    def forward(self, x):
        x = self.lin1(x)
        x = F.gelu(x) if self.act == "gelu" else F.relu(x)
        return self.lin2(x)


class Block(nn.Module):
    """A ViT block: windowed (window_size > 0) or global attention."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 input_size: Tuple[int, int]):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(
            dim, num_heads,
            (window_size, window_size) if window_size > 0 else input_size)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MLPBlock(dim, dim * 4, "gelu")
        self.window_size = window_size

    def forward(self, x):
        shortcut = x
        y = self.norm1(x)
        if self.window_size > 0:
            h, w = y.shape[1], y.shape[2]
            y, pad_hw = window_partition(y, self.window_size)
        y = self.attn(y)
        if self.window_size > 0:
            y = window_unpartition(y, self.window_size, pad_hw, (h, w))
        x = shortcut + y
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)

    def forward(self, x):  # [B, 3, H, W] -> [B, H/p, W/p, dim]
        return self.proj(x).permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    def __init__(self, config: SamConfig):
        super().__init__()
        c = config
        grid = c.image_size // c.patch_size
        self.patch_embed = PatchEmbed(c.patch_size, c.encoder_embed_dim)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, grid, grid, c.encoder_embed_dim))
        self.blocks = nn.ModuleList(
            Block(c.encoder_embed_dim, c.encoder_num_heads,
                  0 if i in c.encoder_global_attn_indexes else c.window_size,
                  (grid, grid))
            for i in range(c.encoder_depth))
        # Neck: 1x1 conv -> LN -> 3x3 conv -> LN, 256 channels, no bias.
        self.neck = nn.Sequential(
            nn.Conv2d(c.encoder_embed_dim, c.prompt_embed_dim, 1,
                      bias=False),
            LayerNorm2d(c.prompt_embed_dim),
            nn.Conv2d(c.prompt_embed_dim, c.prompt_embed_dim, 3, padding=1,
                      bias=False),
            LayerNorm2d(c.prompt_embed_dim))

    def forward(self, x):  # x: [B, 3, H, W] normalized
        x = self.patch_embed(x) + self.pos_embed
        for block in self.blocks:
            x = block(x)
        return self.neck(x.permute(0, 3, 1, 2))  # [B, 256, grid, grid]


class PositionEmbeddingRandom(nn.Module):
    """Random Fourier positional encoding (frozen gaussian matrix)."""

    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))

    def forward(self, coords_normalized):
        """coords in [0,1]^2 -> [..., 2*num_pos_feats]."""
        coords = 2 * coords_normalized - 1
        coords = coords @ self.positional_encoding_gaussian_matrix
        coords = 2 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def grid(self, size: int):
        """Dense PE over a size x size grid -> [size, size, C]."""
        dev = self.positional_encoding_gaussian_matrix.device
        side = (torch.arange(size, dtype=torch.float32, device=dev)
                + 0.5) / size
        ys, xs = torch.meshgrid(side, side, indexing="ij")
        return self(torch.stack([xs, ys], dim=-1))


class PromptEncoder(nn.Module):
    def __init__(self, config: SamConfig):
        super().__init__()
        c = config
        self.config = config
        self.pe_layer = PositionEmbeddingRandom(c.prompt_embed_dim // 2)
        # 0: negative point, 1: positive point, 2/3: box corners.
        self.point_embeddings = nn.ModuleList(
            nn.Embedding(1, c.prompt_embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, c.prompt_embed_dim)
        self.no_mask_embed = nn.Embedding(1, c.prompt_embed_dim)

    def forward(self, point_coords, point_labels):
        """point_coords: [B, N, 2] in image pixels (1024-scale);
        point_labels: [B, N] in {-1 pad, 0 neg, 1 pos}.
        Returns (sparse [B, N+1, C], dense [B, C, g, g])."""
        c = self.config
        b = point_coords.shape[0]
        # Pad with a sentinel point (SAM appends one when no box is given).
        coords = torch.cat([point_coords, point_coords.new_zeros(b, 1, 2)],
                           dim=1)
        labels = torch.cat([point_labels,
                            -point_labels.new_ones(b, 1)], dim=1)
        pe = self.pe_layer(coords / c.image_size + 0.0)
        labels = labels[..., None]
        pe = torch.where(labels == -1, self.not_a_point_embed.weight[0], pe)
        pe = pe + torch.where(labels == 0, self.point_embeddings[0].weight[0],
                              0.0)
        pe = pe + torch.where(labels == 1, self.point_embeddings[1].weight[0],
                              0.0)
        grid = c.image_size // c.patch_size
        dense = self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(
            b, -1, grid, grid)
        return pe, dense

    def get_dense_pe(self):
        """[1, C, g, g]."""
        grid = self.config.image_size // self.config.patch_size
        return self.pe_layer.grid(grid).permute(2, 0, 1)[None]


class _DownAttention(nn.Module):
    """Attention with internal downprojection (two-way transformer blocks);
    segment-anything's transformer.Attention."""

    def __init__(self, dim: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        inner = dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def _split(self, x):
        b, n, c = x.shape
        return x.reshape(b, n, self.num_heads, c // self.num_heads
                         ).transpose(1, 2)

    def forward(self, q, k, v):
        qp = self._split(self.q_proj(q))
        kp = self._split(self.k_proj(k))
        vp = self._split(self.v_proj(v))
        head_dim = qp.shape[-1]
        attn = (qp @ kp.transpose(-2, -1)) / math.sqrt(head_dim)
        out = attn.softmax(dim=-1) @ vp
        b, h, n, d = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, h * d))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int = 2048,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        self.self_attn = _DownAttention(dim, num_heads)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.cross_attn_token_to_image = _DownAttention(dim, num_heads, 2)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MLPBlock(dim, mlp_dim, "relu")
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm4 = nn.LayerNorm(dim, eps=LN_EPS)
        self.cross_attn_image_to_token = _DownAttention(dim, num_heads, 2)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)

        q = queries + query_pe
        k = keys + key_pe
        queries = queries + self.cross_attn_token_to_image(q, k, keys)
        queries = self.norm2(queries)

        queries = self.norm3(queries + self.mlp(queries))

        q = queries + query_pe
        k = keys + key_pe
        keys = keys + self.cross_attn_image_to_token(k, q, queries)
        keys = self.norm4(keys)
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, dim: int, depth: int = 2, num_heads: int = 8,
                 mlp_dim: int = 2048):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(dim, num_heads, mlp_dim,
                                 skip_first_layer_pe=(i == 0))
            for i in range(depth))
        self.final_attn_token_to_image = _DownAttention(dim, num_heads, 2)
        self.norm_final_attn = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding [B, C, h, w], image_pe [1, C, h, w], point
        embeddings [B, N, C] -> (queries [B, N, C], keys [B, h*w, C])."""
        keys = image_embedding.flatten(2).transpose(1, 2)
        key_pe = image_pe.flatten(2).transpose(1, 2)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q = queries + point_embedding
        k = keys + key_pe
        queries = queries + self.final_attn_token_to_image(q, k, keys)
        return self.norm_final_attn(queries), keys


class _MLP(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(
            nn.Linear(n, k) for n, k in zip(dims, dims[1:] + [output_dim]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, config: SamConfig, num_multimask_outputs: int = 3):
        super().__init__()
        c = config.prompt_embed_dim
        self.num_mask_tokens = num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(c)
        self.iou_token = nn.Embedding(1, c)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, c)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(c, c // 4, 2, stride=2),
            LayerNorm2d(c // 4),
            nn.GELU(),
            nn.ConvTranspose2d(c // 4, c // 8, 2, stride=2),
            nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            _MLP(c, c, c // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = _MLP(c, c, self.num_mask_tokens, 3)

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings, multimask_output: bool):
        """image_embeddings [1 or B, C, h, w] -> (masks [B, n, 4h, 4w],
        iou [B, n]); n = 3 with multimask_output, else 1."""
        b = sparse_prompt_embeddings.shape[0]
        output_tokens = torch.cat([self.iou_token.weight,
                                   self.mask_tokens.weight], dim=0)
        output_tokens = output_tokens[None].expand(b, -1, -1)
        tokens = torch.cat([output_tokens, sparse_prompt_embeddings], dim=1)

        src = image_embeddings + dense_prompt_embeddings
        hs, src = self.transformer(src, image_pe, tokens)
        iou_token_out = hs[:, 0, :]
        mask_tokens_out = hs[:, 1:1 + self.num_mask_tokens, :]

        _, c, h, w = image_embeddings.shape
        src = src.transpose(1, 2).reshape(b, c, h, w)
        upscaled = self.output_upscaling(src)  # [b, c/8, 4h, 4w]
        hyper = torch.stack([
            mlp(mask_tokens_out[:, i])
            for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        bb, cc, hh, ww = upscaled.shape
        masks = (hyper @ upscaled.reshape(bb, cc, hh * ww)).reshape(
            bb, self.num_mask_tokens, hh, ww)
        iou_pred = self.iou_prediction_head(iou_token_out)

        if multimask_output:
            return masks[:, 1:], iou_pred[:, 1:]
        return masks[:, :1], iou_pred[:, :1]


class Sam(nn.Module):
    """Bundled SAM modules; see hugs.sam.predictor for the user-facing
    API."""

    def __init__(self, config: SamConfig):
        super().__init__()
        self.config = config
        self.image_encoder = ImageEncoderViT(config)
        self.prompt_encoder = PromptEncoder(config)
        self.mask_decoder = MaskDecoder(config)

    def encode_image(self, x):
        return self.image_encoder(x)

    def predict_masks(self, image_embeddings, point_coords, point_labels,
                      multimask_output: bool = True):
        sparse, dense = self.prompt_encoder(point_coords, point_labels)
        image_pe = self.prompt_encoder.get_dense_pe()
        return self.mask_decoder(image_embeddings, image_pe, sparse, dense,
                                 multimask_output)

    def forward(self, x, point_coords, point_labels):
        emb = self.encode_image(x)
        return self.predict_masks(emb, point_coords, point_labels)


# Leaves a flax init leaves at zero (biases, pos_embed, rel_pos_*) or one
# (LayerNorm scales) keep those values; the rest draw as flax's
# initializers do (hugs/sam/predictor.py::build_sam).
@torch.no_grad()
def init_sam(sam: Sam, gen: Optional[torch.Generator] = None) -> Sam:
    """Seeded random weights: Linear, Conv and ConvTranspose weights from
    lecun_normal (a normal truncated at two standard deviations, variance
    1 / fan_in over the input channels times the kernel area), the
    embeddings and the Fourier matrix from N(0, 1), everything else as
    the modules build it (zeros, LayerNorm scales ones)."""
    for module in sam.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = module.weight
            if isinstance(module, nn.ConvTranspose2d):
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:
                fan_in = w[0].numel()
            # .87962566: the standard deviation of a unit normal truncated
            # at +-2.
            std = (1.0 / fan_in) ** 0.5 / .87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            nn.init.normal_(module.weight, generator=gen)
    nn.init.normal_(
        sam.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix,
        generator=gen)
    return sam
