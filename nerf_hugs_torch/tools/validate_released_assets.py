"""Day-one validation of a released-asset drop, on the card.

Twin of tools/validate_released_assets.py: the one command that turns a
drop of released assets (ASSETS_REQUEST.md) into a comparison table.

    python -m nerf_hugs_torch.tools.validate_released_assets \\
        --assets_dir /path/to/drop [--work_dir DIR] \\
        [--config_map map.json] [--image_type whole|half_right|half_left] \\
        [--skip_render] [--device cuda|cpu]

Expected drop layout (any subset; everything is optional and reported):
  {assets}/lpips*.pth | {assets}/lpips/*.pth      LPIPS AlexNet weights
  {assets}/sam*.pth | {assets}/sam/*.pth          SAM checkpoint (vit_b,
                                                  vit_l or vit_h)
  {assets}/data/{scene}/                          scene data dirs
  {assets}/checkpoints/{experiment}/{scene}/      released checkpoints
      (flax `checkpoint_NNN` files OR torch `*.pth` snapshots)
  {assets}/rendering_results/{experiment}/{scene}/test_preds/*_{gt,color}.png

Per (experiment, scene) it: (1) scores the released renders with the
port's metrics (metrics/score.py), (2) converts the released checkpoint
(tools/convert_reference_checkpoint.py), (3) renders the test split
through the port's eval driver (with the config.yml the converter emits
for a torch snapshot), (4) scores those renders, and (5) scores them
against the released renders, image by image. Results land in
{work_dir}/PAPER_COMPARISON.md and .json, in the JAX tool's format.
--work_dir defaults to asset_validation under the temporary directory
that TMPDIR names (the JAX tool's default is /tmp/asset_validation), so
that two checkouts with their own TMPDIR do not share one report.

Checkpoint -> config mapping: --config_map (JSON {"experiment[/scene]":
"configs/..."}); without it the longest shipped config stem contained in
the experiment name. A failure in one pair is recorded in its row and the
other pairs still run; after the report is written, `python -m` exits 1
when any row has an error (the JAX tool exits 0). It runs on the card
unless --device cpu is given; without a card that is an error.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import traceback

import numpy as np
import torch

from nerf_hugs_torch.utils.device import resolve_device

# The repository's shipped configs, which the name heuristic matches.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _find_one(assets_dir, patterns):
    for pat in patterns:
        hits = sorted(glob.glob(os.path.join(assets_dir, pat)))
        if hits:
            return hits[0]
    return None


def discover(assets_dir):
    return {
        "lpips": _find_one(assets_dir, ["lpips*.pth", "lpips/*.pth",
                                        "lpips*.pt"]),
        "sam": _find_one(assets_dir, ["sam*.pth", "sam/*.pth"]),
        "data": sorted(glob.glob(os.path.join(assets_dir, "data", "*"))),
        "checkpoints": sorted(glob.glob(
            os.path.join(assets_dir, "checkpoints", "*", "*"))),
        "rendering_results": sorted(glob.glob(
            os.path.join(assets_dir, "rendering_results", "*", "*"))),
        "segmentation_results": sorted(glob.glob(
            os.path.join(assets_dir, "segmentation_results", "*"))),
    }


def check_lpips(path, device):
    """Convert the LPIPS weights and smoke-run one distance."""
    from nerf_hugs_torch.metrics import lpips
    params = lpips.convert_torch_state_dict(path)
    model = lpips.LPIPS(params, device)
    img = np.zeros((64, 64, 3), np.float32)
    d_same = float(model(img, img))
    d_diff = float(model(img, np.ones_like(img)))
    ok = np.isfinite(d_same) and d_diff > d_same
    return {"path": path, "converted_params": len(params),
            "d(img,img)": d_same, "d(black,white)": d_diff, "ok": bool(ok)}


def sam_model_type(sd) -> str:
    """The official model (vit_b, vit_l or vit_h) whose encoder width and
    depth the checkpoint's tables have."""
    from nerf_hugs_torch.hugs.sam.modeling import VIT_CONFIGS
    width = sd["image_encoder.pos_embed"].shape[-1]
    depth = len({k.split(".")[2] for k in sd
                 if k.startswith("image_encoder.blocks.")})
    for name, spec in VIT_CONFIGS.items():
        if (spec["encoder_embed_dim"], spec["encoder_depth"]) == (width,
                                                                  depth):
            return name
    raise ValueError(f"no SAM model has an encoder of width {width} and "
                     f"depth {depth}")


def check_sam(path, device):
    """Load the SAM checkpoint into the port's model under the strict key
    schema (hugs/sam/weights.py); no forward run."""
    from nerf_hugs_torch.hugs.sam import modeling, weights
    sd = weights.load_torch_checkpoint(path)
    model_type = sam_model_type(sd)
    config = modeling.make_sam_config(model_type, **weights.checkpoint_sizes(
        sd, modeling.make_sam_config(model_type)))
    with torch.device(device):
        sam = modeling.Sam(config)
    weights.load_state_dict(sam, sd)
    n = sum(v.numel() for v in sam.state_dict().values())
    return {"path": path, "converted_param_count": int(n), "ok": True}


def score_renders(exp_dir, scene, image_type, lpips_weights, device):
    """Score {exp_dir}/{scene}/test_preds pairs with the scoring CLI."""
    from nerf_hugs_torch.metrics import score
    res = score.main(exp_dir, [scene], image_type, False, None,
                     lpips_weights=lpips_weights, device=device)
    return res[scene]["mean"]


def _guess_config(experiment, scene, config_map):
    key_full = f"{experiment}/{scene}"
    if key_full in config_map:
        return config_map[key_full]
    if experiment in config_map:
        return config_map[experiment]
    # Heuristic: longest shipped-config basename contained in the
    # experiment name (e.g. 'mipnerf360_kubric_1024_withmask' matches
    # configs/mipnerf360/kubric_1024_withmask.gin).
    best = None
    for path in sorted(
            glob.glob(os.path.join(_REPO_ROOT, "configs/*/*.gin")) +
            glob.glob(os.path.join(_REPO_ROOT, "configs/*/*.yml"))):
        stem = os.path.splitext(os.path.basename(path))[0]
        if stem in experiment and (best is None
                                   or len(stem) > len(best[0])):
            best = (stem, path)
    return best[1] if best else None


def _latest_checkpoint(ckpt_scene_dir):
    torch_cands = sorted(glob.glob(os.path.join(ckpt_scene_dir, "*.pth")))
    if torch_cands:
        return torch_cands[-1], "torch"
    flax_cands = sorted(
        glob.glob(os.path.join(ckpt_scene_dir, "checkpoint_*")),
        key=lambda p: int(p.rsplit("_", 1)[-1]))
    if flax_cands:
        return flax_cands[-1], "flax"
    return None, None


def _config_flags(config_path):
    return (["--config", config_path]
            if config_path.endswith((".yml", ".yaml"))
            else ["--gin_configs", config_path])


def ours_vs_released(released_pred_dir, our_pred_dir, device):
    """Mean PSNR of our renders against the released ones of the same
    names (the released _color.png taken as the ground truth), or None
    when no name is shared."""
    from nerf_hugs_torch.metrics import image as nh_image
    from nerf_hugs_torch.utils import io as nh_io
    harness = nh_image.MetricHarness(device=device)
    psnrs = []
    for rel_path in sorted(glob.glob(os.path.join(released_pred_dir,
                                                  "*_color.png"))):
        our_path = os.path.join(our_pred_dir, os.path.basename(rel_path))
        if not os.path.exists(our_path):
            continue
        a = nh_io.load_img(rel_path)[..., :3] / 255.0
        b = nh_io.load_img(our_path)[..., :3] / 255.0
        psnrs.append(harness(b.astype(np.float32),
                             a.astype(np.float32))["psnr"])
    return float(np.mean(psnrs)) if psnrs else None


def validate_pair(experiment, scene, assets_dir, work_dir, config_path,
                  lpips_weights, image_type, device, skip_render=False):
    """Full chain for one (experiment, scene): score the released renders,
    convert, render, score ours and ours against the released renders.
    Returns a row dict for the comparison table."""
    from nerf_hugs_torch.eval import main as eval_main
    from nerf_hugs_torch.tools import convert_reference_checkpoint as conv

    row = {"experiment": experiment, "scene": scene, "config": config_path}
    released_dir = os.path.join(assets_dir, "rendering_results", experiment)
    have_released = os.path.isdir(
        os.path.join(released_dir, scene, "test_preds"))
    if have_released:
        row["released_scores"] = score_renders(released_dir, scene,
                                               image_type, lpips_weights,
                                               device)

    ckpt, kind = _latest_checkpoint(os.path.join(assets_dir, "checkpoints",
                                                 experiment, scene))
    if ckpt is None or config_path is None or skip_render:
        row["note"] = ("released renders only" if have_released else
                       "nothing usable found")
        return row

    out_dir = os.path.join(work_dir, experiment, scene)
    os.makedirs(out_dir, exist_ok=True)
    conv.main(["--reference_checkpoint", ckpt, "--output_dir", out_dir,
               "--device", device] + _config_flags(config_path))
    # Torch snapshots need the legacy-compositing config the converter
    # emits (models/nerfacto_import.py).
    emitted = os.path.join(out_dir, "config.yml")
    eval_config = emitted if (kind == "torch"
                              and os.path.exists(emitted)) else config_path
    eval_main(_config_flags(eval_config) + [
        "--data_dir", os.path.join(assets_dir, "data", scene),
        "--save_dir", out_dir, "--eval_data", "test", "--device", device])
    row["our_scores"] = score_renders(os.path.join(work_dir, experiment),
                                      scene, image_type, lpips_weights,
                                      device)
    if have_released:
        psnr = ours_vs_released(os.path.join(released_dir, scene,
                                             "test_preds"),
                                os.path.join(out_dir, "test_preds"), device)
        if psnr is not None:
            row["ours_vs_released_psnr"] = psnr
    return row


def emit_report(rows, extras, work_dir):
    os.makedirs(work_dir, exist_ok=True)
    with open(os.path.join(work_dir, "PAPER_COMPARISON.json"), "w") as f:
        json.dump({"rows": rows, "extras": extras}, f, indent=2)
    lines = ["# Released-asset validation", ""]
    for k, v in extras.items():
        lines.append(f"- **{k}**: {json.dumps(v)}")
    lines += ["", "| experiment | scene | released PSNR/SSIM | ours "
              "PSNR/SSIM | ours vs released PSNR |", "|---|---|---|---|---|"]
    fmt = lambda s: (f"{s.get('psnr', float('nan')):.2f}/"
                     f"{s.get('ssim', float('nan')):.4f}" if s else "—")
    for r in rows:
        vs = r.get("ours_vs_released_psnr")
        lines.append(
            f"| {r['experiment']} | {r['scene']} "
            f"| {fmt(r.get('released_scores', {}))} "
            f"| {fmt(r.get('our_scores', {}))} "
            f"| {'—' if vs is None else f'{vs:.2f}'} |")
    path = os.path.join(work_dir, "PAPER_COMPARISON.md")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def main(argv=None):
    """Validate the drop; returns (rows, extras) as the JAX tool does."""
    parser = argparse.ArgumentParser(
        prog="python -m nerf_hugs_torch.tools.validate_released_assets",
        description="Score, convert and re-render a drop of released "
                    "assets into PAPER_COMPARISON.{md,json}.")
    parser.add_argument("--assets_dir", required=True)
    parser.add_argument("--work_dir", default=os.path.join(
        tempfile.gettempdir(), "asset_validation"))
    parser.add_argument("--config_map", default=None,
                        help="JSON file {experiment[/scene]: config path}")
    parser.add_argument("--image_type", default="whole",
                        choices=["whole", "half_right", "half_left"])
    parser.add_argument("--skip_render", action="store_true",
                        help="only score released renders; no conversion")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    device = str(resolve_device(args.device))

    inv = discover(args.assets_dir)
    print("asset inventory:", json.dumps(
        {k: (v if isinstance(v, (str, type(None))) else len(v))
         for k, v in inv.items()}))

    extras = {}
    if inv["lpips"]:
        extras["lpips"] = check_lpips(inv["lpips"], device)
        print("LPIPS:", extras["lpips"])
    lpips_weights = inv["lpips"] if (
        inv["lpips"] and extras.get("lpips", {}).get("ok")) else None
    if inv["sam"]:
        extras["sam"] = check_sam(inv["sam"], device)
        print("SAM:", extras["sam"])

    config_map = {}
    if args.config_map:
        with open(args.config_map) as f:
            config_map = json.load(f)

    # Union of (experiment, scene) pairs seen in checkpoints/ and
    # rendering_results/.
    pairs = {(os.path.basename(os.path.dirname(d)), os.path.basename(d))
             for d in inv["checkpoints"] + inv["rendering_results"]}
    rows = []
    for experiment, scene in sorted(pairs):
        config_path = _guess_config(experiment, scene, config_map)
        print(f"=== {experiment}/{scene} (config: {config_path}) ===",
              flush=True)
        # Per-pair isolation: one bad checkpoint or scene must not abort
        # the validation of the others; the failure goes into its row.
        try:
            rows.append(validate_pair(
                experiment, scene, args.assets_dir, args.work_dir,
                config_path, lpips_weights, args.image_type, device,
                skip_render=args.skip_render))
        except Exception:
            traceback.print_exc()
            rows.append({"experiment": experiment, "scene": scene,
                         "config": config_path,
                         "error": traceback.format_exc(limit=3)})
        print(json.dumps(rows[-1], default=str), flush=True)

    path = emit_report(rows, extras, args.work_dir)
    print(f"report: {path}")
    return rows, extras


if __name__ == "__main__":
    rows, _ = main()
    sys.exit(1 if any("error" in row for row in rows) else 0)
