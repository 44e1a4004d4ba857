"""SAM's share of HuGS on the card: where the encoder's, the decoder's and
one image's time goes.

    python -m nerf_hugs_torch.tools.bench_sam [--model vit_h]
        [--sam_checkpoint PTH] [--size 256] [--device cuda|cpu]
        [--out JSON]

With random weights from a seeded generator unless a checkpoint is given
(weights change values, not time, but they decide how many masks reach
the host), float32 with TF32 off, as the HuGS stage runs:
  * the encoder: CUDA-event median ms per `SamPredictor.set_image` of a
    size x size frame, its operations (the dense layers, the attention
    products and the relative-position terms, counted from the config)
    and the rate they reach;
  * the decoder: median ms per `predict_compact` batch of 64 and of 256
    point prompts of the mask generator's grid (the IoU 0.8 / stability
    0.9 filters, the bit-packing and the copy to the host included);
  * one image of the static-mask pipeline at configs/hugs/kubric.yml on a
    random size x size frame: wall seconds with the stage split, and the
    device's busy share (the kernels' device time over the wall time).
Each of the three is also traced once with torch.profiler, and its device
time split into matrix products, convolutions, softmax, resizes,
reductions and the rest, with the five longest kernels named. On the CPU
(toy runs: --model vit_t with a checkpoint of a small input) only the
wall times are measured.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import time

# Kernel-name patterns of each category, tried in order.
CATEGORIES = (("matmul", r"gemm|xmma|cutlass|cublas"),
              ("conv", r"conv|cudnn|implicit"),
              ("softmax", r"softmax"),
              ("resize", r"upsample|interp|antialias|_aa_"),
              ("reduce", r"reduce"),
              ("other", r"."))
_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "hugs")


def encoder_flops(config) -> float:
    """Multiply-adds x 2 of one encoder pass: patch embedding, each
    block's qkv, projection and MLP, its attention products (windowed
    blocks over padded windows) and relative-position terms, and the
    neck."""
    g = config.image_size // config.patch_size
    d, tokens = config.encoder_embed_dim, g * g
    head = d // config.encoder_num_heads
    flops = 2 * tokens * 3 * config.patch_size ** 2 * d
    for i in range(config.encoder_depth):
        if i in config.encoder_global_attn_indexes:
            windows, n = 1, tokens
        else:
            w = config.window_size
            windows, n = (-(-g // w)) ** 2, w * w
        side = int(round(n ** 0.5))
        # qkv and the projection over the (padded) windows, the MLP over
        # the tokens.
        flops += 2 * windows * n * d * 4 * d + 2 * tokens * d * 8 * d
        # q k^T and attn v per head, then the two rel-pos einsums.
        flops += windows * config.encoder_num_heads * (
            4 * n * n * head + 2 * 2 * n * side * head)
    c = config.prompt_embed_dim
    return flops + 2 * tokens * (d * c + 9 * c * c)


def categorize(prof) -> dict:
    """{category: device ms} and the five longest kernels of a trace."""
    totals = {name: 0.0 for name, _ in CATEGORIES}
    kernels = []
    for e in prof.key_averages():
        t = e.device_time_total / 1e3
        if t <= 0 or e.device_type.name != "CUDA":
            continue
        kernels.append((t, e.key))
        for name, pattern in CATEGORIES:
            if re.search(pattern, e.key, re.IGNORECASE):
                totals[name] += t
                break
    kernels.sort(reverse=True)
    return {"device_ms": {k: round(v, 4) for k, v in totals.items()},
            "device_total_ms": round(sum(totals.values()), 4),
            "longest": [(k[:90], round(t, 4)) for t, k in kernels[:5]]}


def profiled(torch, fn, on_card: bool):
    """(categorize's split of one call of `fn` under torch.profiler, or
    None on the CPU; the call's wall seconds, the trace's processing
    left out)."""
    if not on_card:
        t0 = time.perf_counter()
        fn()
        return None, time.perf_counter() - t0
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return categorize(prof), wall


def timed_ms(torch, fn, on_card: bool, runs: int = 5) -> float:
    fn()
    times = []
    for _ in range(runs):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if on_card:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(prog="python -m "
                                     "nerf_hugs_torch.tools.bench_sam")
    parser.add_argument("--model", default="vit_h")
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--out", default=None)
    parser.add_argument("--sam_checkpoint", default=None,
                        help="segment-anything .pth; random weights "
                             "without it")
    args = parser.parse_args(argv)

    import numpy as np
    import torch
    import yaml

    from nerf_hugs_torch.hugs import segment
    from nerf_hugs_torch.hugs.sam.amg import build_point_grid
    from nerf_hugs_torch.hugs.sam.predictor import SamPredictor, build_sam
    from nerf_hugs_torch.utils.device import (pin_fp32_precision,
                                              resolve_device)
    device = resolve_device(args.device)
    pin_fp32_precision()
    on_card = device.type == "cuda"
    predictor = SamPredictor(build_sam(args.model, args.sam_checkpoint,
                                       device))
    config = predictor.config
    rs = np.random.RandomState(0)
    hw = (args.size, args.size)
    gt = (rs.rand(*hw, 3) * 255).astype(np.uint8)
    report = {"model": args.model, "size": args.size,
              "device": (torch.cuda.get_device_name(0) if on_card
                         else "cpu")}

    encode = lambda: predictor.set_image(gt)
    enc_ms = timed_ms(torch, encode, on_card)
    flops = encoder_flops(config)
    report["encoder"] = {"ms": round(enc_ms, 4),
                         "gflop": round(flops / 1e9, 1),
                         "tflop_per_s": round(flops / enc_ms / 1e9, 2),
                         "profile": profiled(torch, encode, on_card)[0]}
    print(f"encoder ({args.model}, {args.size}x{args.size} frame): "
          f"{enc_ms:.3f} ms per set_image, {flops / 1e9:.1f} GFLOP, "
          f"{flops / enc_ms / 1e9:.2f} TFLOP/s", flush=True)

    grid = predictor.apply_coords(build_point_grid(64) * args.size, hw)
    report["decoder"] = {}
    for n, budget in ((64, 192), (256, 64)):
        pts, labels = grid[:n, None, :], np.ones((n, 1))
        decode = lambda: predictor.predict_compact(pts, labels, 0.8, 0.9,
                                                   1.0, n, budget)
        ms = timed_ms(torch, decode, on_card)
        report["decoder"][n] = {
            "ms": round(ms, 4), "profile": profiled(torch, decode,
                                                    on_card)[0]}
        print(f"decoder: {ms:.3f} ms per batch of {n} prompts (budget "
              f"{budget})", flush=True)

    with open(os.path.join(_CONFIGS, "kubric.yml")) as f:
        seg_config = segment.SegmentConfig(**yaml.safe_load(f))
    generator = segment.make_generator(predictor, seg_config)
    pred = np.clip(gt / 255.0 + rs.randn(*hw, 3) * 0.05, 0, 1).astype(
        np.float32)
    points = rs.rand(200, 2) * args.size
    stages = {}

    def image():
        segment.generate_masks_for_image(pred, (gt / 255.0).astype(
            np.float32), points, generator, predictor, seg_config, stages)

    image()  # warm
    stages.clear()
    profile, wall = profiled(torch, image, on_card)
    report["image"] = {"s": round(wall, 4),
                       "stages_s": {k: round(v, 4) for k, v in
                                    stages.items()},
                       "profile": profile}
    busy = ("" if profile is None else
            f"; device busy {profile['device_total_ms'] / 1e3 / wall:.3f}"
            " of the wall time (under the profiler)")
    print(f"one image at kubric.yml: {wall:.3f} s, stages "
          + " ".join(f"{k}={v:.3f}" for k, v in stages.items()) + busy,
          flush=True)
    for name, part in (("encoder", report["encoder"]),
                       ("decoder 64", report["decoder"][64]),
                       ("decoder 256", report["decoder"][256]),
                       ("image", report["image"])):
        if part["profile"] is not None:
            print(f"profile {name}: {json.dumps(part['profile'])}",
                  flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
