"""nerf_hugs_torch's HuGS pipeline against the JAX package's: the copied
heuristics, SamPredictor, the automatic mask generator and `python -m
nerf_hugs_torch.hugs` against generate_static_mask.main.

SAM is tiny (vit_t at image_size 64, window_size 2, as tests/test_hugs.py
builds it): for the predictor and the mask generator, random weights in
the official schema (tests/sam_official_schema.py) converted by JAX's
weights.convert_state_dict; for the CLI, JAX's own seeded init, which
generate_static_mask.main builds. Either is carried into the port by
models/from_jax.py::sam_state_dict. Logits and IoU are held at 1e-5 of
their largest entry (float32); masks, keep flags, boxes, counts and the
written PNGs are held equal.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (pins torch's threads)
from nerf_hugs_torch.hugs import heuristics as th
from nerf_hugs_torch.hugs import segment
from nerf_hugs_torch.hugs.sam import amg as tamg
from nerf_hugs_torch.hugs.sam import modeling as tm
from nerf_hugs_torch.hugs.sam import predictor as tpred
from nerf_hugs_torch.hugs.sam import weights as tw
from nerf_hugs_torch.models.from_jax import sam_state_dict
from nerf_hugs_tpu.hugs import heuristics as jh

TOY = dict(image_size=64, window_size=2)
TOL = 1e-5


def _rs(seed):
    return np.random.RandomState(seed)


def _residual_inputs():
    gt = _rs(0).rand(16, 16, 3).astype(np.float32)
    pred = gt.copy()
    pred[:4, :4] += 0.5
    return pred, gt, 0.9


def _regions_inputs():
    h, w = 12, 16
    m1 = np.zeros((h, w)); m1[:6, :8] = 1
    m2 = np.zeros((h, w)); m2[6:, 8:] = 1
    return [m1, m2], h, w


def _fuse_inputs():
    h = w = 16
    regions = jh.complete_sam_regions(
        [np.concatenate([np.ones((h, w // 2)), np.zeros((h, w // 2))], 1)],
        h, w)
    sfm = np.zeros((h, w, 1), np.float32); sfm[:, :w // 2] = 1
    base = _rs(5).rand(h, w, 1).round().astype(np.float32)
    upper = np.ones((h, w, 1), np.float32)
    return sfm, base, upper, regions, 3, 3


def _pinhole():
    mask = np.ones((20, 20, 1), np.float32)
    mask[10, 10] = 0
    return mask, 5


def _square(kernel):
    mask = np.zeros((20, 20, 1), np.float32)
    mask[5:15, 5:15] = 1.0
    return mask, kernel


def _intersect_inputs():
    coarse = np.zeros((10, 10, 1), np.float32); coarse[:5] = 1.0
    fine = np.zeros((2, 10, 10, 1), np.float32)
    fine[0, :6] = 1.0
    fine[1, 5:] = 1.0
    return coarse, fine, 0.5


def _stability_logits():
    logits = np.full((2, 8, 8), 5.0)
    logits[0, :4] = -5.0
    logits[1] = _rs(6).randn(8, 8)
    return logits, 0.0, 1.0


# (heuristic, its arguments) on the inputs of tests/test_hugs.py:16-111.
HEURISTICS = {
    "delete_same_points": ("delete_same_points", lambda: (
        np.array([[0.0, 0], [0.05, 0], [1, 1], [1.04, 1], [3, 3]]), 0.1)),
    "delete_outlier_points": ("delete_outlier_points", lambda: (
        np.concatenate([_rs(0).randn(30, 2), [[100.0, 100.0]]]),)),
    "kmeans_reduce": ("kmeans_reduce", lambda: (np.concatenate(
        [_rs(0).randn(20, 2), _rs(1).randn(20, 2) + 10]), 2)),
    "group_points": ("group_points", lambda: (
        _rs(2).rand(4, 2), _rs(3).rand(12, 2), 3)),
    "filter_sfm_points": ("filter_sfm_points", lambda: (
        _rs(4).rand(9, 2) * 40, np.array([0, 3, 5, 7, 1, 9, 5, 0, 6]), 5,
        (0.5, 0.25), (16.0, 8.0))),
    "fill_gap": ("fill_gap", _pinhole),
    "smooth_union": ("smooth_union", lambda: _square(3)),
    "intersect_masks": ("intersect_masks", _intersect_inputs),
    "erode_mask": ("erode_mask", lambda: _square(5)),
    "residual_masks": ("residual_masks", _residual_inputs),
    "complete_sam_regions": ("complete_sam_regions", _regions_inputs),
    "calculate_stability_score": ("calculate_stability_score",
                                  _stability_logits),
    "fuse_masks": ("fuse_masks", _fuse_inputs),
}


@pytest.mark.parametrize("name", sorted(HEURISTICS))
def test_heuristics_match_jax(name):
    fn, make = HEURISTICS[name]
    got = getattr(th, fn)(*make())
    want = getattr(jh, fn)(*make())
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)


# -- SAM predictor ----------------------------------------------------------


@pytest.fixture(scope="module")
def predictors():
    """(JAX SamPredictor, the port's on the same weights)."""
    from nerf_hugs_tpu.hugs.sam import modeling as jm
    from nerf_hugs_tpu.hugs.sam import weights as jw
    from nerf_hugs_tpu.hugs.sam.predictor import SamPredictor
    from sam_official_schema import make_official_sam_state_dict
    config = jm.make_sam_config("vit_t", **TOY)
    variables = jw.convert_state_dict(
        make_official_sam_state_dict(config, fill="random", seed=2), config)
    return (SamPredictor(jm.Sam(config), variables),
            tpred.SamPredictor(_port_sam(variables)))


def _port_sam(variables):
    sam = tm.Sam(tm.make_sam_config("vit_t", **TOY))
    return tw.load_state_dict(sam, sam_state_dict(
        {"params": _numpy(variables["params"])}))


def _numpy(tree):
    return {k: _numpy(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * max(float(np.abs(want).max()) if want.size else 0,
                            1e-30), err


def _set_image(predictors, hw, seed):
    image = (_rs(seed).rand(*hw, 3) * 255).astype(np.uint8)
    for p in predictors:
        p.set_image(image)
    return image


# Image sizes: 48x60 fills 51x64 of the 64 input square, so the second
# resize shrinks 51x64 -> 48x60 (antialiased); 32x32 shrinks 64 -> 32.
SIZES = [(48, 60), (32, 32)]


@pytest.mark.parametrize("hw", SIZES, ids=["48x60", "32x32"])
def test_predict_batched_matches_jax(predictors, hw):
    jp, tp = predictors
    _set_image(predictors, hw, 0)
    assert tp.input_size == tuple(jp.input_size)
    assert tp.original_size == tuple(jp.original_size)
    pts = jp.apply_coords(np.array([[[30.0, 24.0]], [[10.0, 10.0]],
                                    [[2.0, 40.0]]]), hw)
    labels = np.ones((3, 1))
    want_m, want_i = jp.predict_batched(pts, labels)
    got_m, got_i = tp.predict_batched(pts, labels)
    assert got_m.shape == (3, 3) + hw
    close(got_m, want_m)
    close(got_i, want_i)
    bools, _ = tp.predict_batched(pts, labels, return_logits=False)
    np.testing.assert_array_equal(bools, want_m > 0)


def _prompts(jp, hw, n_valid, batch, seed):
    pts_px = _rs(seed).rand(n_valid, 1, 2) * np.array([hw[1], hw[0]])
    pts = jp.apply_coords(pts_px, hw)
    pts = np.concatenate([pts, np.zeros((batch - n_valid, 1, 2))])
    return pts, np.ones(pts.shape[:2])


def _check_compact(got, want):
    packed, ious, stabs, keep, boxes, n_pass = got
    w_packed, w_ious, w_stabs, w_keep, w_boxes, w_n_pass = want
    assert n_pass == w_n_pass
    np.testing.assert_array_equal(keep, w_keep)
    np.testing.assert_array_equal(packed, w_packed)
    np.testing.assert_array_equal(boxes, w_boxes)
    assert packed.dtype == np.uint8 and boxes.dtype == np.int32
    close(ious, w_ious)
    close(stabs, w_stabs)


@pytest.mark.parametrize("hw", SIZES, ids=["48x60", "32x32"])
@pytest.mark.parametrize("iou_t,stab_t", [(0.0, 0.0), (0.5, 0.6)])
def test_predict_compact_and_count_match_jax(predictors, hw, iou_t, stab_t):
    jp, tp = predictors
    _set_image(predictors, hw, 3)
    n_valid, batch = 5, 8
    pts, labels = _prompts(jp, hw, n_valid, batch, 4)
    args = (pts, labels, iou_t, stab_t, 1.0)
    want = jp.predict_compact(*args, n_valid=n_valid, max_keep=batch * 3)
    got = tp.predict_compact(*args, n_valid=n_valid, max_keep=batch * 3)
    _check_compact(got, want)
    assert not got[3][n_valid * 3:].any()
    for select_best in (True, False):
        want_c = jp.predict_count(*args, n_valid=n_valid,
                                  select_best=select_best)
        got_c = tp.predict_count(*args, n_valid=n_valid,
                                 select_best=select_best)
        assert got_c.dtype == np.float32
        np.testing.assert_array_equal(got_c, want_c)


@pytest.mark.parametrize("hw", SIZES, ids=["48x60", "32x32"])
def test_predict_compact_budget_matches_jax(predictors, hw):
    """Under a budget both keep the same rows: keep-rows first, then the
    highest IoU, ties (the padded prompts) to the lower index."""
    jp, tp = predictors
    _set_image(predictors, hw, 5)
    pts, labels = _prompts(jp, hw, 3, 6, 6)
    for max_keep in (2, 7, 12):
        args = (pts, labels, 0.0, 0.0, 1.0)
        want = jp.predict_compact(*args, n_valid=3, max_keep=max_keep)
        got = tp.predict_compact(*args, n_valid=3, max_keep=max_keep)
        assert len(got[3]) == max_keep
        _check_compact(got, want)


def test_predictor_needs_an_image(predictors):
    _, tp = predictors
    tp.reset_image()
    with pytest.raises(RuntimeError, match="set_image"):
        tp.predict_count(np.zeros((1, 1, 2)), np.ones((1, 1)), 0, 0, 1, 1,
                         True)


# -- automatic mask generator -----------------------------------------------


@pytest.mark.parametrize("crop_layers,hw,min_area,budget",
                         [(0, (48, 48), 0, None), (1, (40, 56), 2, None),
                          (0, (48, 48), 0, 2)],
                         ids=["no-crops", "one-crop-layer", "budget"])
def test_amg_matches_jax(predictors, crop_layers, hw, min_area, budget):
    from nerf_hugs_tpu.hugs.sam.amg import SamAutomaticMaskGenerator
    jp, tp = predictors
    kwargs = dict(points_per_side=4, points_per_batch=16,
                  pred_iou_thresh=0.0, stability_score_thresh=0.0,
                  crop_n_layers=crop_layers,
                  crop_n_points_downscale_factor=2,
                  min_mask_region_area=min_area,
                  max_masks_per_batch=budget)
    image = (_rs(7 + crop_layers).rand(*hw, 3) * 255).astype(np.uint8)
    with pytest.warns(UserWarning, match="budget") if budget else \
            _no_warning():
        want = SamAutomaticMaskGenerator(predictor=jp, **kwargs).generate(
            image)
    with pytest.warns(UserWarning, match="budget") if budget else \
            _no_warning():
        got = tamg.SamAutomaticMaskGenerator(predictor=tp, **kwargs
                                             ).generate(image)
    assert len(want) >= 1 and len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["segmentation"], w["segmentation"])
        assert g["area"] == w["area"] and g["bbox"] == w["bbox"]
        assert abs(g["predicted_iou"] - w["predicted_iou"]) <= TOL * max(
            abs(w["predicted_iou"]), 1.0)
        assert abs(g["stability_score"] - w["stability_score"]) <= TOL


class _no_warning:
    def __enter__(self):
        import warnings
        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.simplefilter("error")

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)


def test_amg_refuses_a_budget_below_one(predictors):
    """JAX reads max_masks_per_batch=0 as "no budget" (amg.py:164); the
    port refuses it, and keeps None as "every candidate"."""
    _, tp = predictors
    for bad in (0, -1):
        with pytest.raises(ValueError, match="max_masks_per_batch"):
            tamg.SamAutomaticMaskGenerator(predictor=tp,
                                           max_masks_per_batch=bad)
    tamg.SamAutomaticMaskGenerator(predictor=tp, max_masks_per_batch=None)
    with pytest.raises(ValueError, match="max_masks_per_batch"):
        segment.make_generator(tp, segment.SegmentConfig(
            sam_max_masks_per_batch=0))


def test_amg_helpers_match_jax():
    from nerf_hugs_tpu.hugs.sam import amg as jamg
    for n in (1, 4, 64):
        np.testing.assert_array_equal(tamg.build_point_grid(n),
                                      jamg.build_point_grid(n))
    for size, layers in (((768, 1024), 1), ((40, 56), 2), ((256, 256), 1)):
        assert tamg.generate_crop_boxes(size, layers) == \
            jamg.generate_crop_boxes(size, layers)
    mask = np.zeros((9, 7), bool); mask[2:5, 1:3] = True
    np.testing.assert_array_equal(tamg.mask_to_box(mask),
                                  jamg.mask_to_box(mask))
    boxes = _rs(8).rand(20, 4) * 10
    boxes[:, 2:] += boxes[:, :2]
    scores = _rs(9).rand(20)
    assert tamg.box_nms(boxes, scores, 0.3) == jamg.box_nms(boxes, scores,
                                                            0.3)
    seg = _rs(10).rand(20, 20) > 0.6
    np.testing.assert_array_equal(tamg._remove_small_regions(seg, 4),
                                  jamg._remove_small_regions(seg, 4))


# -- the CLI ------------------------------------------------------------------


def _write_scene(tmp_path):
    """tests/test_hugs.py::test_generate_static_mask_pipeline's scene."""
    import generate_static_mask as gsm
    from tests.test_colmap_loaders import write_colmap_model
    rng = np.random.RandomState(0)
    names = write_colmap_model(str(tmp_path / "sparse"), 3, rng)
    img_dir = tmp_path / "preds"
    img_dir.mkdir()
    for name in names:
        stem = Path(name).stem
        gt = rng.rand(16, 16, 3).astype(np.float32)
        pred = np.clip(gt + rng.randn(16, 16, 3) * 0.05, 0, 1)
        gsm.save_image_rgb(gt, img_dir / f"{stem}_gt.png")
        gsm.save_image_rgb(pred, img_dir / f"{stem}_color.png")
    return [Path(n).stem for n in names], img_dir


CLI_CONFIG = dict(
    sam_points_per_side=4, sam_crop_n_layers=0, sam_min_mask_region_area=0,
    sam_pred_iou_thresh=0.0, sam_stability_score_thresh=0.0,
    sfm_point_count_threshold=2, sfm_seg_batch_size=8,
    sfm_pred_iou_thresh=0.0, sfm_stability_score_thresh=0.0,
    smooth_kernel_size=3, erode_kernel_size=0)


def test_cli_static_masks_equal_jax(tmp_path, capsys):
    """generate_static_mask.main and `python -m nerf_hugs_torch.hugs
    --device cpu` on the same scene with the same SAM weights (JAX's seeded
    init, saved as an official-schema .pth for the port) write the same
    static_masks/ PNGs."""
    import cv2
    import yaml

    import generate_static_mask as gsm
    from nerf_hugs_torch.hugs import main as hugs_main
    from nerf_hugs_tpu.hugs.sam.predictor import build_sam
    _, variables = build_sam("vit_t", **TOY)
    names, img_dir = _write_scene(tmp_path)
    gsm.main(str(img_dir), str(tmp_path / "sparse"), "vit_t", None,
             str(tmp_path / "jax"), gsm.SegmentConfig(**CLI_CONFIG),
             sam_overrides=TOY)
    ckpt = tmp_path / "sam_vit_t.pth"
    torch.save(sam_state_dict({"params": _numpy(variables["params"])}),
               ckpt)
    cfg = tmp_path / "hugs.yml"
    cfg.write_text(yaml.safe_dump(CLI_CONFIG))
    records = hugs_main([
        "--images", str(img_dir), "--colmap", str(tmp_path / "sparse"),
        "--sam_model", "vit_t", "--sam_checkpoint", str(ckpt),
        "--output", str(tmp_path / "port"), "--config", str(cfg),
        "--device", "cpu"])
    out = capsys.readouterr().out
    assert [r[0] for r in records] == sorted(names)
    for name, _, stages in records:
        assert f"{name}: static fraction" in out
        assert tuple(stages) == segment.STAGES
    for name in names:
        got = cv2.imread(str(tmp_path / "port" / "static_masks"
                             / f"{name}.png"))
        want = cv2.imread(str(tmp_path / "jax" / "static_masks"
                              / f"{name}.png"))
        assert got.shape == (16, 16, 3)
        assert set(np.unique(got)) <= {0, 255}
        np.testing.assert_array_equal(got, want)
        vis = cv2.imread(str(tmp_path / "port" / "visualizations"
                             / f"{name}.png"))
        assert vis.shape == (32, 128, 3)


def test_cli_defaults_to_the_card(tmp_path, monkeypatch):
    from nerf_hugs_torch.hugs import main as hugs_main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "hugs.yml"
    cfg.write_text("residual_quantile_upper: 0.9\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hugs_main(["--images", str(tmp_path), "--colmap", str(tmp_path),
                   "--output", str(tmp_path / "out"), "--config", str(cfg)])


def test_shipped_hugs_configs_parse():
    repo = Path(__file__).resolve().parents[1]
    import yaml

    from generate_static_mask import SegmentConfig as JaxSegmentConfig
    import dataclasses
    assert [(f.name, f.default) for f in dataclasses.fields(
        segment.SegmentConfig)] == [(f.name, f.default) for f in
                                    dataclasses.fields(JaxSegmentConfig)]
    for path in sorted((repo / "configs" / "hugs").glob("*.yml")):
        raw = yaml.safe_load(path.read_text())
        assert dataclasses.asdict(segment.SegmentConfig(**raw)) == \
            dataclasses.asdict(JaxSegmentConfig(**raw))


def test_hugs_kubric_stages_on_a_written_scene(tmp_path):
    """scripts/hugs_kubric.sh's stages at toy widths on a kubric capture of
    tools/hashgrid_inputs.write_kubric_scene (rgb/1x/ and rgb/2x/, its
    COLMAP model in sparse/0): gen_mask training, eval of the train split
    with --original_name --only_pred_gt, then the port's HuGS and JAX's
    generate_static_mask.main on the same pairs and model write the same
    masks, and a withmask retrain reads them."""
    import cv2
    import yaml

    import generate_static_mask as gsm
    from nerf_hugs_tpu.cameras import colmap as jcolmap
    from nerf_hugs_tpu.hugs.sam.predictor import build_sam
    from nerf_hugs_torch.cameras import camera_utils, colmap
    from nerf_hugs_torch.data import kubric, load_dataset
    from nerf_hugs_torch.eval import main as eval_main
    from nerf_hugs_torch.hugs import main as hugs_main
    from nerf_hugs_torch.tools import hashgrid_inputs
    from nerf_hugs_torch.train import driver
    scene = hashgrid_inputs.write_kubric_scene(
        str(tmp_path / "scene"), num_train=2, num_test=2, size=32,
        factors=(1, 2))
    names = ["00000", "00001"]
    for f, size in ((1, 32), (2, 16)):
        img = cv2.imread(str(Path(scene) / "rgb" / f"{f}x" / "00000.png"))
        assert img.shape == (size, size, 3)

    # The COLMAP model: both readers agree; every train frame is in it; a
    # feature lies on the ray the kubric loader casts through its pixel.
    model = Path(scene) / "sparse" / "0"
    images = colmap.read_images_binary(str(model / "images.bin"))
    points = colmap.read_points3D_binary(str(model / "points3D.bin"))
    j_images = jcolmap.read_images_binary(str(model / "images.bin"))
    assert len(images) == hashgrid_inputs.KUBRIC_SFM_VIEWS == len(j_images)
    by_name = {Path(im.name).stem: im for im in images.values()}
    for name in names:
        im = by_name[name]
        tracks = np.array([len(points[int(p)].image_ids)
                           for p in im.point3D_ids])
        assert (tracks >= 40).sum() > 10
        pixtocam, c2w, dist = kubric._camera_from_json(
            str(Path(scene) / "camera-gt" / f"{name}.json"), 1)
        origins, dirs, _, _ = camera_utils.pixels_to_rays(
            im.xys[:, 0] - 0.5, im.xys[:, 1] - 0.5, pixtocam, c2w, dist)
        xyz = np.stack([points[int(p)].xyz for p in im.point3D_ids])
        d = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        off = (xyz - origins) - ((xyz - origins) * d).sum(-1,
                                                          keepdims=True) * d
        assert np.abs(off).max() < 1e-6

    # Stages 1 and 2 at toy widths.
    gen = yaml.safe_load((Path(__file__).resolve().parents[1] / "configs"
                          / "nerfacto" / "kubric_nerfacto_gen_mask.yml"
                          ).read_text())
    base = {**gen["base"], **{k: v for k, v in torch_port_util.TINY_BASE.items()
                              if k not in ("dataset_type",
                                           "downsample_factor")},
            "early_exit_steps": 2, "eval_render_every": 0,
            "num_img_per_batch": 2}
    cfg = tmp_path / "gen.yml"
    cfg.write_text(yaml.safe_dump({"base": base,
                                   "model": torch_port_util.TINY_MODEL}))
    ckpt = str(tmp_path / "gen")
    dirs_args = ["--config", str(cfg), "--data_dir", scene, "--save_dir",
                 ckpt, "--device", "cpu"]
    driver.main(dirs_args)
    eval_main(dirs_args + ["--eval_data", "train", "--original_name",
                           "--only_pred_gt"])
    preds = Path(ckpt) / "train_preds"
    assert sorted(p.name for p in preds.iterdir()) == sorted(
        f"{n}_{k}.png" for n in names for k in ("color", "gt"))

    # Stage 3 in both packages, the shipped kubric.yml under toy SAM knobs.
    hugs = {**yaml.safe_load((Path(__file__).resolve().parents[1]
                              / "configs" / "hugs" / "kubric.yml"
                              ).read_text()),
            **{k: v for k, v in CLI_CONFIG.items()
               if k != "sfm_point_count_threshold"}}
    assert hugs["sfm_point_count_threshold"] == 40
    gsm.main(str(preds), str(model), "vit_t", None, str(tmp_path / "jax"),
             gsm.SegmentConfig(**hugs), sam_overrides=TOY)
    _, variables = build_sam("vit_t", **TOY)
    pth = tmp_path / "sam.pth"
    torch.save(sam_state_dict({"params": _numpy(variables["params"])}), pth)
    hugs_cfg = tmp_path / "hugs.yml"
    hugs_cfg.write_text(yaml.safe_dump(hugs))
    hugs_main(["--images", str(preds), "--colmap", str(model),
               "--sam_model", "vit_t", "--sam_checkpoint", str(pth),
               "--output", scene, "--config", str(hugs_cfg), "--device",
               "cpu"])
    for name in names:
        got = cv2.imread(str(Path(scene) / "static_masks" / f"{name}.png"))
        want = cv2.imread(str(tmp_path / "jax" / "static_masks"
                              / f"{name}.png"))
        assert got.shape == (32, 32, 3)
        np.testing.assert_array_equal(got, want)

    # Stage 4 reads them at rgb/2x/.
    wm = yaml.safe_load((Path(__file__).resolve().parents[1] / "configs"
                         / "nerfacto" / "kubric_nerfacto_withmask.yml"
                         ).read_text())
    wm_cfg = tmp_path / "withmask.yml"
    wm_cfg.write_text(yaml.safe_dump({
        "base": {**base, "downsample_factor": wm["base"][
            "downsample_factor"]},
        "model": {**torch_port_util.TINY_MODEL, "transient_type":
                  wm["model"]["transient_type"]}}))
    config = driver.load_config(str(wm_cfg), scene, str(tmp_path / "wm"))
    train = load_dataset("train", scene, config, is_training=False)
    from nerf_hugs_torch.data import base as data_base
    for name, m in zip(names, train.static_masks):
        assert m.shape == (16, 16, 1)
        np.testing.assert_array_equal(m, data_base.load_static_mask(
            str(Path(scene) / "static_masks" / f"{name}.png"), 16, 16))
    driver.main(["--config", str(wm_cfg), "--data_dir", scene,
                 "--save_dir", str(tmp_path / "wm"), "--device", "cpu"])
    assert (tmp_path / "wm" / "checkpoint_2.pt").exists()


def test_bench_sam_runs_on_the_cpu_and_defaults_to_the_card(tmp_path,
                                                            monkeypatch):
    """tools/bench_sam at toy size on the CPU (wall times only), its
    encoder operation count at vit_h, and --device cuda by default."""
    import json

    from nerf_hugs_torch.tools import bench_sam
    out, pth = tmp_path / "sam.json", tmp_path / "sam_vit_t_64.pth"
    torch.save(tpred.build_sam("vit_t", **TOY).state_dict(), pth)
    report = bench_sam.main(["--model", "vit_t", "--sam_checkpoint",
                             str(pth), "--size", "24", "--device", "cpu",
                             "--out", str(out)])
    assert json.loads(out.read_text())["encoder"]["ms"] == \
        report["encoder"]["ms"] > 0
    assert set(report["decoder"]) == {64, 256}
    assert tuple(report["image"]["stages_s"]) == segment.STAGES
    assert report["image"]["profile"] is None
    # vit_h: 32 blocks of 1280 over 64 x 64 tokens, 4 of them global.
    flops = bench_sam.encoder_flops(tm.make_sam_config("vit_h"))
    assert 5.9e12 < flops < 6.0e12
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_sam.main(["--model", "vit_t", "--sam_checkpoint", str(pth)])
