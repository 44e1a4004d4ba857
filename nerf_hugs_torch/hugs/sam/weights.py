"""Official segment-anything checkpoints into the port's SAM.

The port's Sam (hugs/sam/modeling.py) names its parameters with the
official state-dict keys (facebookresearch/segment-anything,
sam_vit_{b,l,h}.pth):
  image_encoder.patch_embed.proj.{weight,bias}
  image_encoder.pos_embed
  image_encoder.blocks.{i}.{norm1,attn.qkv,attn.proj,attn.rel_pos_h,
                           attn.rel_pos_w,norm2,mlp.lin1,mlp.lin2}
  image_encoder.neck.{0,1,2,3}
  prompt_encoder.{pe_layer.positional_encoding_gaussian_matrix,
                  point_embeddings.{0..3}.weight, not_a_point_embed.weight,
                  no_mask_embed.weight}
  mask_decoder.{transformer.layers.{i}.*, transformer.final_attn_token_to_image,
                transformer.norm_final_attn, iou_token.weight,
                mask_tokens.weight, output_upscaling.{0,1,3},
                output_hypernetworks_mlps.{i}.layers.{j},
                iou_prediction_head.layers.{j}}
with segment-anything's layouts, so a checkpoint loads as it is: a
ConvTranspose2d weight stays (in, out, kH, kW), unflipped. Only the
mask-prompt downscaling convolutions are dropped: the HuGS pipeline never
feeds a mask prompt, so the model has no such layers. Any other key the
model does not hold, or a key it holds that the checkpoint lacks, is
refused, as the JAX package's strict conversion refuses them
(nerf_hugs_tpu/hugs/sam/weights.py:90-110).
"""

from __future__ import annotations

from typing import Dict

import torch

# Official checkpoint keys that are intentionally not loaded (see above).
INTENTIONALLY_UNUSED_PREFIXES = ("prompt_encoder.mask_downscaling.",)


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The official .pth (a plain state dict) without the unused keys."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in sd.items()
            if not k.startswith(INTENTIONALLY_UNUSED_PREFIXES)}


def checkpoint_sizes(sd: Dict[str, torch.Tensor], config) -> dict:
    """The image_size and window_size a checkpoint's tables were made for:
    pos_embed is [1, grid, grid, dim] over image_size / patch_size tokens,
    and a windowed block's rel_pos_h spans 2 * window_size - 1."""
    grid = sd["image_encoder.pos_embed"].shape[1]
    sizes = {"image_size": grid * config.patch_size}
    windowed = [i for i in range(config.encoder_depth)
                if i not in config.encoder_global_attn_indexes]
    if windowed:
        length = sd[f"image_encoder.blocks.{windowed[0]}.attn.rel_pos_h"
                    ].shape[0]
        sizes["window_size"] = (length + 1) // 2
    return sizes


def load_state_dict(sam: torch.nn.Module, sd: Dict[str, torch.Tensor]
                    ) -> torch.nn.Module:
    """Load `sd` into `sam` strictly: every key consumed, every parameter
    and buffer given, every shape equal; a ValueError names the keys."""
    sd = {k: v for k, v in sd.items()
          if not k.startswith(INTENTIONALLY_UNUSED_PREFIXES)}
    want = sam.state_dict()
    unused = sorted(set(sd) - set(want))
    if unused:
        raise ValueError("official checkpoint keys not consumed by the "
                         f"model: {unused[:20]}")
    missing = sorted(set(want) - set(sd))
    if missing:
        raise ValueError(f"checkpoint lacks keys: {missing[:20]}")
    shapes = [k for k in want if tuple(want[k].shape) != tuple(sd[k].shape)]
    if shapes:
        raise ValueError("checkpoint shapes differ from the model's: "
                         + ", ".join(f"{k} {tuple(sd[k].shape)} != "
                                     f"{tuple(want[k].shape)}"
                                     for k in shapes[:10]))
    sam.load_state_dict(sd, strict=True)
    return sam
