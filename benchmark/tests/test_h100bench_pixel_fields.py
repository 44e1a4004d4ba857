"""The pixel fields the reference is handed beside the rays: each ray's
pixel centre, image index and static mask, recast from the capture's files
bit for bit as the program's loader gives them; the faults in them that
data_gap reads; captures with HuGS's static masks; and the room they make
for a configuration whose embeddings and implicit mask read them."""

import json
import os
import types

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from benchmark import check, harness, scene as scene_lib, weights
from benchmark.manifest import Manifest
from benchmark.reference import cameras
from h100bench_util import REPO, TINY_SCENE, add_cell, tiny_checkout

RECORDED = harness.RAY_FIELDS + harness.PIXEL_FIELDS + ("cam_idx",
                                                          "lossmult")
MASKED_SCENE = dict(TINY_SCENE, static_masks=True)
HANERF = os.path.join(REPO, "configs", "nerfacto",
                      "phototourism_nerfacto_hanerf.yml")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_checkout(str(tmp_path_factory.mktemp("checkout")))
    add_cell(root, "tiny_nerfacto.masked", "tiny_nerfacto",
             scene=MASKED_SCENE)
    return root


def entry_of(batch) -> dict:
    """A checked batch as the harness records it."""
    return {"rays": {k: getattr(batch.rays, k) for k in RECORDED},
            "rgb": batch.rgb}


@pytest.fixture(scope="module")
def masked(root, tmp_path_factory):
    """(scene, the program's first 8 batches as one) of a capture with
    masks."""
    run = harness.Run(Manifest(root), "tiny_nerfacto.masked", 2 ** 31 + 5,
                      "cpu", tmp_root=str(tmp_path_factory.mktemp("run")))
    try:
        run.setup()
        batches = [next(run.dataset).to("cpu") for _ in range(8)]
        rays = type(batches[0].rays)(**{
            k: torch.cat([getattr(b.rays, k) for b in batches])
            for k in vars(batches[0].rays)})
        batch = type(batches[0])(rays=rays, rgb=torch.cat(
            [b.rgb for b in batches]))
        yield cameras.KubricScene(run.data_dir, 2), batch
    finally:
        run.close()


@pytest.mark.parametrize("field", harness.PIXEL_FIELDS)
def test_recast_pixel_fields_equal_the_loaders(masked, field):
    scene, batch = masked
    rays, _, gap = check.recast(scene, entry_of(batch), "cpu")
    program = getattr(batch.rays, field)
    assert rays[field].dtype == program.dtype
    assert torch.equal(rays[field], program)
    assert gap == 0
    # The batches meet distractor squares and static pixels both.
    assert set(batch.rays.static_mask.unique().tolist()) == {0.0, 1.0}


def _shift_half_pixel(p, w):
    return p + torch.tensor([0.5 / w, 0.0])


@pytest.mark.parametrize("field,fault,least", [
    ("embed_idx", lambda e, w: e + 1, lambda w: 1.0),
    ("pix_coords", _shift_half_pixel, lambda w: 0.5 / w),
    ("static_mask", lambda m, w: 1 - m, lambda w: 1.0)])
def test_a_fault_in_a_pixel_field_reads_in_data_gap(masked, field, fault,
                                                    least):
    scene, batch = masked
    w = scene.images[0].shape[1]
    entry = entry_of(batch)
    entry["rays"][field] = fault(entry["rays"][field], w)
    assert check.recast(scene, entry, "cpu")[2] >= least(w)


@pytest.mark.parametrize("cell", ["tiny_nerfacto.train", "tiny_mip.train"])
def test_existing_cells_read_no_gap_and_train_on_the_same_keys(
        root, cell, tmp_path):
    run = harness.Run(Manifest(root), cell, 2 ** 31 + 21, "cpu",
                      tmp_root=str(tmp_path))
    try:
        run.setup()
        run.checked_and_warm_steps()
        run.trainee.close()
        run.trainee = run.dataset = None
        scene = cameras.KubricScene(run.data_dir, 2)
        full, ray_only = [], []
        for entry in run.checked:
            rays, rgb, gap = check.recast(scene, entry, "cpu")
            assert gap == 0
            assert set(rays) == set(harness.RAY_FIELDS
                                    + harness.PIXEL_FIELDS)
            full.append((rays, rgb))
            ray_only.append(({k: rays[k] for k in harness.RAY_FIELDS}, rgb))
        readings = [check.train_reference(
            run.reference, run.values,
            weights.draw(run.specs, run.seed, "cpu"), batches, run.seed,
            "cpu") for batches in (full, ray_only)]
        assert readings[0] == readings[1]
    finally:
        run.close()


def sphere_only(root: str, world_scale: float) -> list:
    """[h, w, 3] uint8 colours of each train frame's sphere world without
    its distractor square."""
    scene = cameras.KubricScene(root, TINY_SCENE["factor"])
    size = TINY_SCENE["size"]
    out = []
    for c in range(len(scene.images)):
        x, y = np.meshgrid(np.arange(size, dtype=np.float64),
                           np.arange(size, dtype=np.float64), indexing="xy")
        p2c, lens = scene.pixtocams[c], scene.lenses[c]
        o, d, _, _ = cameras.rays_from_plane(
            scene.c2ws[c], cameras.camera_plane(p2c, lens, x, y),
            cameras.camera_plane(p2c, lens, x + 1, y),
            cameras.camera_plane(p2c, lens, x, y + 1))
        image = scene_lib.sphere_color(o, d, 0.5 * world_scale)
        out.append(np.round(image * 255).astype(np.uint8))
    return out


def write(root: str, seed: int = 77, **kw) -> str:
    s = TINY_SCENE
    return scene_lib.write_kubric_scene(root, seed, s["num_train"],
                                        s["size"], s["factor"],
                                        s["world_scale"], **kw)


def test_each_masks_zeros_are_its_frames_distractor_square(tmp_path):
    root = write(str(tmp_path / "scene"), static_masks=True)
    sz = TINY_SCENE["size"] // 4
    plain = sphere_only(root, TINY_SCENE["world_scale"])
    with open(os.path.join(root, "dataset.json")) as f:
        names = json.load(f)["train_ids"]
    for name, sphere in zip(names, plain):
        mask = np.asarray(Image.open(os.path.join(
            root, cameras.MASK_DIR, f"{name}.png")))
        image = np.asarray(Image.open(os.path.join(root, "rgb", "2x",
                                                   f"{name}.png")))
        assert mask.shape == image.shape[:2]
        assert set(np.unique(mask).tolist()) == {0, 255}
        square = (image != sphere).any(-1)
        assert np.array_equal(mask == 0, square)
        ys, xs = np.nonzero(mask == 0)
        assert (np.ptp(ys) + 1, np.ptp(xs) + 1, len(ys)) == (sz, sz, sz * sz)


def test_the_loader_reads_the_masks_without_a_resize(root, tmp_path,
                                                     monkeypatch):
    from nerf_hugs_torch.data import base
    from nerf_hugs_torch.train import driver

    def no_resize(*args, **kw):
        raise AssertionError("the mask was resized")
    monkeypatch.setattr(base, "resize_bilinear", no_resize)
    scene_root = write(str(tmp_path / "scene"), static_masks=True)
    manifest = Manifest(root)
    config = harness.load_config(
        manifest.config(manifest.cell("tiny_nerfacto.masked")),
        str(tmp_path), scene_root, 3)
    dataset = driver.stage_dataset("train", config)
    scene = cameras.KubricScene(scene_root, 2)
    assert len(dataset.static_masks) == len(scene.masks)
    for program, plain in zip(dataset.static_masks, scene.masks):
        assert program.dtype == np.float32
        assert np.array_equal(program, plain)
        assert (program == 0).sum() == (TINY_SCENE["size"] // 4) ** 2


def test_without_the_key_no_masks_and_the_same_frames(tmp_path):
    plain = write(str(tmp_path / "plain"))
    masked = write(str(tmp_path / "masked"), static_masks=False)
    with_masks = write(str(tmp_path / "with"), static_masks=True)
    assert not os.path.exists(os.path.join(plain, cameras.MASK_DIR))
    assert not os.path.exists(os.path.join(masked, cameras.MASK_DIR))
    for dirpath, _, files in os.walk(plain):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), plain)
            for other in (masked, with_masks):
                with open(os.path.join(plain, rel), "rb") as a, \
                        open(os.path.join(other, rel), "rb") as b:
                    assert a.read() == b.read(), rel
    scene = cameras.KubricScene(plain, 2)
    assert all(np.array_equal(m, np.ones_like(m)) for m in scene.masks)


def stand_in_reference(params: dict, rays: dict) -> dict:
    """What HA-NeRF's model reads of a ray beside the ray itself, taken
    plainly: the appearance and transient rows of its image, and the pixel
    coordinates the implicit mask's 2-D grid encodes."""
    row = rays["embed_idx"][:, 0].long()
    return {"appearance": params["appearance_embedding.weight"][row],
            "transient": params["transient_embedding.weight"][row],
            "mask_coords": rays["pix_coords"]}


def test_hanerf_on_the_benchmarks_capture_hands_the_reference_its_reads(
        tmp_path):
    from nerf_hugs_torch.configs import yaml_loader
    from nerf_hugs_torch.models import nerfacto
    from nerf_hugs_torch.train import driver
    with open(HANERF) as f:
        doc = yaml.safe_load(f)
    doc["base"]["dataset_type"] = "kubric"
    path = str(tmp_path / "hanerf.yml")
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)
    config = yaml_loader.load_yaml_config(path)
    config.data_dir = write(str(tmp_path / "scene"), static_masks=True)
    config.seed = 11
    assert config.transient_type == "hanerf"
    assert config.nerfacto.use_appearance_embedding
    assert config.nerfacto.use_transient_embedding
    assert nerfacto.MASK_GRID.num_dims == 2
    driver.preflight(config)
    dataset = driver.stage_dataset("train", config)
    driver.check_num_embeddings(config, dataset)
    batch = next(dataset).to("cpu")
    assert batch.rgb.shape[0] == config.batch_size

    scene = cameras.KubricScene(config.data_dir, config.factor)
    rays, _, gap = check.recast(scene, entry_of(batch), "cpu")
    assert gap == 0
    gen = torch.Generator().manual_seed(11)
    nc = config.nerfacto
    tables = {f"{k}_embedding.weight": nerfacto._embedding(
        config.model.num_embeddings, dim, gen).weight.detach()
        for k, dim in (("appearance", nc.appearance_embedding_dim),
                       ("transient", nc.transient_embedding_dim))}
    plain = stand_in_reference(tables, rays)
    # The program's model: NerfactoModel._get_embedding on the batch's
    # embed_idx at train time, and the implicit mask on its pix_coords.
    model = types.SimpleNamespace(config=config)
    for k in ("appearance", "transient"):
        embed = torch.nn.Embedding.from_pretrained(
            tables[f"{k}_embedding.weight"])
        program = nerfacto.NerfactoModel._get_embedding(
            model, embed, batch.rays.embed_idx, False, False)[:, 0]
        assert torch.equal(plain[k], program)
    assert torch.equal(plain["mask_coords"], batch.rays.pix_coords)
