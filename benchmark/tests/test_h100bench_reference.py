"""The plain references against the port on the CPU at tiny widths: the
same initial parameters, rays and generator seed give the same loss and
gradients (the port in float32 here, where its configurations compute in
bfloat16 on the card), and the recast rays equal the loader's."""

import copy

import pytest
import torch

from benchmark import check, harness, weights
from benchmark.manifest import Manifest
from benchmark.reference import cameras, common
from h100bench_util import tiny_checkout


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_checkout(str(tmp_path_factory.mktemp("checkout")))


def first_batch_and_program(root, cell, tmp_path, seed=4):
    manifest = Manifest(root)
    run = harness.Run(manifest, cell, seed, "cpu", tmp_root=str(tmp_path))
    run.setup()
    batch = next(run.dataset)
    return run, batch.to("cpu")


@pytest.mark.parametrize("cell", ["tiny_nerfacto.train", "tiny_mip.train"])
def test_reference_loss_and_gradients_match_the_port(root, cell, tmp_path):
    from nerf_hugs_torch.train import step as step_lib
    run, batch = first_batch_and_program(root, cell, tmp_path)
    try:
        config = copy.deepcopy(run.config)
        config.enable_amp = False
        config.model.compute_dtype = "float32"
        model = harness.ProgramTrainee(config, "cpu", weights.draw(
            run.specs, run.seed, "cpu"), run.seed).model
        rng = torch.Generator().manual_seed(run.seed + 1)
        loss, _ = step_lib.compute_loss(model, batch, 0.0, config, rng)
        loss.backward()
        params = {k: p.detach().clone().requires_grad_(True) for k, p in
                  weights.draw(run.specs, run.seed, "cpu").items()}
        rays = {k: getattr(batch.rays, k) for k in harness.RAY_FIELDS}
        ref = run.reference.loss(params, rays, batch.rgb,
                                 0.0, torch.Generator().manual_seed(
                                     run.seed + 1), run.values, "float32")
        ref.backward()
        assert float(ref.detach()) == pytest.approx(float(loss.detach()),
                                                    rel=1e-5)
        for name, p in model.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            r = params[name].grad
            r = r if r is not None else torch.zeros_like(g)
            scale = max(float(r.abs().max()), 1e-12)
            assert float((g - r).abs().max()) <= 1e-4 * scale, name
    finally:
        run.close()


def test_recast_rays_equal_the_loaders(root, tmp_path):
    run, batch = first_batch_and_program(root, "tiny_nerfacto.train",
                                         tmp_path)
    try:
        entry = {"rays": {k: getattr(batch.rays, k) for k in
                          harness.RAY_FIELDS + harness.PIXEL_FIELDS
                          + ("cam_idx", "lossmult")},
                 "rgb": batch.rgb}
        scene = cameras.KubricScene(run.data_dir, 2)
        _, rgb, gap = check.recast(scene, entry, "cpu")
        assert gap <= 1e-6
        entry["rgb"] = entry["rgb"] + 1 / 255
        assert check.recast(scene, entry, "cpu")[2] >= 1 / 256
    finally:
        run.close()


def test_fp8_control_rounds_to_fp8():
    x = torch.linspace(-1, 1, 101)
    w = torch.eye(101)
    y = common.linear(x[None], w, torch.zeros(101), "fp8")
    assert not torch.equal(y[0], x)
    assert float((y[0] - x).abs().max()) < 0.07
    assert torch.equal(common.linear(x[None], w, torch.zeros(101),
                                     "float32")[0], x)


def test_adam_matches_optax_first_step():
    p = {"w": torch.tensor([1.0, -2.0, 0.5])}
    g = {"w": torch.tensor([0.1, -0.3, 0.0])}
    adam = common.Adam(p, 0.9, 0.999, 1e-15)
    adam.step(p, g, 0.01)
    # optax's first step: mu_hat = g, nu_hat = g^2: -lr * sign(g)
    assert torch.allclose(p["w"], torch.tensor([0.99, -1.99, 0.5]))
