"""nerf_hugs_torch/parallel/mesh.py and its seams, in one process.

pad_to_multiple against nerf_hugs_tpu's, the rank split, each rank's
batches against JAX host r's (jax.process_count / process_index and the
port's mesh.process_count / process_index patched to 2 / r) on the
synthetic and the fake kubric scene with and without patches, the errors
a split raises, the launcher checks, and a gloo group of one rank, whose
collectives run and must leave the train step and the render bit for bit
as they are without a group. The two-process runs are in
test_torch_port_multiprocess.py.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_data import make_fake_kubric_scene

import torch_port_util as tu
from nerf_hugs_tpu.data import load_dataset as jax_load_dataset
from nerf_hugs_tpu.models import construct_model as jax_construct_model
from nerf_hugs_tpu.parallel import mesh as jmesh
from nerf_hugs_tpu.utils import structs as jstructs
from nerf_hugs_torch.configs import yaml_loader as tyaml
from nerf_hugs_torch.data import load_dataset
from nerf_hugs_torch.models import construct_model
from nerf_hugs_torch.parallel import mesh
from nerf_hugs_torch.train import checkpoints, driver
from nerf_hugs_torch.train import step as tstep
from nerf_hugs_torch.train.render_image import render_image
from nerf_hugs_torch.utils import structs
from test_torch_port_transient import ROBUST_BASE, ROBUST_MODEL

RAY_FIELDS = [f.name for f in dataclasses.fields(structs.Rays)]
KUBRIC = {"dataset_type": "kubric", "batch_size": 64, "patch_size": 4,
          "num_img_per_batch": 2}


@pytest.mark.parametrize("n, multiple", [(5, 2), (8, 2), (7, 3), (1, 4),
                                         (13, 4)])
def test_pad_to_multiple_matches_jax(n, multiple):
    arrays = tu.ray_arrays(n, n)
    got, pad = mesh.pad_to_multiple(structs.Rays(**arrays), multiple)
    want, want_pad = jmesh.pad_to_multiple(
        jstructs.Rays(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        multiple)
    assert pad == want_pad == (-n) % multiple
    for name in RAY_FIELDS:
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)), name)
    padded, _ = mesh.pad_to_multiple(torch.from_numpy(arrays["origins"]),
                                     multiple)
    np.testing.assert_array_equal(padded.numpy(), got.origins)


@pytest.mark.parametrize("world", [2, 3])
def test_rank_slices_restore_the_chunk(monkeypatch, world):
    rays = structs.Rays(**tu.ray_arrays(11, 0))
    padded, pad = mesh.pad_to_multiple(rays, world)
    monkeypatch.setattr(mesh, "process_count", lambda: world)
    slices = []
    for rank in range(world):
        monkeypatch.setattr(mesh, "process_index", lambda r=rank: r)
        slices.append(mesh.rank_slice(padded))
    for name in RAY_FIELDS:
        whole = np.concatenate([getattr(s, name) for s in slices])
        np.testing.assert_array_equal(whole, getattr(padded, name))
        np.testing.assert_array_equal(whole[:len(whole) - pad],
                                      getattr(rays, name))
    with pytest.raises(ValueError, match="do not split"):
        mesh.rank_slice(rays)


def as_rank(monkeypatch, rank: int, world: int = 2) -> None:
    """Both packages see `world` processes and this one as `rank`."""
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(mesh, "process_count", lambda: world)
    monkeypatch.setattr(mesh, "process_index", lambda: rank)


def assert_batches_equal(got, want):
    np.testing.assert_array_equal(np.asarray(got.rgb), np.asarray(want.rgb))
    for name in RAY_FIELDS:
        np.testing.assert_array_equal(getattr(got.rays, name),
                                      np.asarray(getattr(want.rays, name)),
                                      name)


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("patch", [1, 4])
@pytest.mark.parametrize("scene", ["synthetic", "kubric"])
def test_rank_batches_equal_jax_host_batches(tmp_path, monkeypatch, scene,
                                             patch, rank):
    base = {"patch_size": patch, "num_img_per_batch": 2}
    data_dir = ""
    if scene == "kubric":
        make_fake_kubric_scene(str(tmp_path))
        base = {**KUBRIC, **base}
        data_dir = str(tmp_path)
    config = tu.tiny_config(base=base)
    as_rank(monkeypatch, rank)
    ours = load_dataset("train", data_dir, config, is_training=True)
    theirs = jax_load_dataset("train", data_dir, config, is_training=True)
    assert ours._batch_size == theirs._batch_size == 32
    assert ours._image_num_per_batch == theirs._image_num_per_batch == 1
    assert (ours._native is None) == (theirs._native is None)
    for _ in range(2):
        assert_batches_equal(next(ours), next(theirs))


def test_patches_that_overflow_a_rank_batch_raise_as_jax(monkeypatch):
    # 32 rays over 2 ranks: 16 each, and 2 images of 4x4 patches need 32.
    config = tu.tiny_config(base={"batch_size": 32, "num_img_per_batch": 4})
    as_rank(monkeypatch, 0)
    for loader in (load_dataset, jax_load_dataset):
        with pytest.raises(ValueError, match="exceeds per-process batch"):
            loader("train", "", config, is_training=True)


def test_train_driver_refuses_a_batch_that_does_not_split(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(mesh, "process_count", lambda: 3)
    cfg = tu.write_tiny_yaml(str(tmp_path))
    with pytest.raises(ValueError, match="batch_size 64 must divide evenly "
                                         "by 3 processes"):
        driver.main(["--config", cfg, "--data_dir", str(tmp_path),
                     "--save_dir", str(tmp_path / "ck"), "--device", "cpu"])
    assert not os.path.exists(tmp_path / "ck")


def test_without_a_launcher_there_is_no_group(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert not mesh.maybe_initialize_distributed("cpu")
    assert not mesh.is_distributed()
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    assert mesh.broadcast_ints([3, -1]) == [3, -1]
    x = torch.arange(4.0)
    assert mesh.gather_rows(x) is x and mesh.all_sum(x) is x


def launcher_env(monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")


def test_nccl_on_the_cpu_is_refused(monkeypatch):
    launcher_env(monkeypatch)
    with pytest.raises(ValueError, match="nccl needs --device cuda"):
        mesh.maybe_initialize_distributed("cpu", "nccl")
    with pytest.raises(ValueError, match="dist_backend must be one of"):
        mesh.maybe_initialize_distributed("cpu", "mpi")
    assert not mesh.is_distributed()


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without a card")
def test_cuda_without_a_card_raises_under_a_launcher(monkeypatch):
    launcher_env(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.maybe_initialize_distributed("cuda")
    assert mesh.default_backend("cuda") == "nccl"
    assert mesh.default_backend("cpu") == "gloo"


def test_two_ranks_on_one_card_are_found():
    assert mesh.duplicate_cards(["h/GPU-a", "h/GPU-b", "g/GPU-a"]) == []
    assert mesh.duplicate_cards(["h/GPU-a", "h/GPU-b", "h/GPU-a"]) == [
        "h/GPU-a"]


def test_fold_in_keeps_rank_zero_seed(monkeypatch):
    assert mesh.fold_in(7) == 7
    monkeypatch.setattr(mesh, "process_index", lambda: 1)
    assert mesh.fold_in(7) == 7 + 2 ** 32


def test_the_compat_sidecar_appears_only_whole(tmp_path, monkeypatch):
    """Another rank may read model_compat.json while rank 0 writes it, so
    the file appears under its name only once it is complete."""
    config = tu.tiny_config()
    path = tmp_path / "model_compat.json"
    dump = checkpoints.json.dump

    def watched(obj, f):
        assert not path.exists()
        dump(obj, f)
    monkeypatch.setattr(checkpoints.json, "dump", watched)
    checkpoints.record_model_compat(str(tmp_path), config)
    assert os.listdir(tmp_path) == ["model_compat.json"]
    checkpoints.check_model_compat(str(tmp_path), config)


def test_prefetch_yields_every_batch_in_order():
    config = tu.tiny_config()
    drawn = []

    def batches():
        dataset = load_dataset("train", "", config, is_training=True)
        for i in range(5):
            drawn.append(i)
            yield next(dataset)

    copies = []
    for i, batch in enumerate(mesh.prefetch_to_device(batches(), "cpu")):
        assert len(drawn) <= i + 3  # two ahead of the one consumed
        copies.append(batch)
    assert len(copies) == 5
    again = load_dataset("train", "", config, is_training=True)
    for got in copies:
        want = next(again).to("cpu")
        assert torch.equal(got.rgb, want.rgb)
        for name in RAY_FIELDS:
            assert torch.equal(getattr(got.rays, name),
                               getattr(want.rays, name)), name


def test_reference_hosts_would_start_from_different_weights(tmp_path):
    """train.py:106-107 folds the host index into the key before :125
    splits the init key from it, so JAX hosts 0 and 1 initialise
    different parameters, which jax.device_put does not reconcile. The
    port seeds its model with config.seed alone and broadcasts rank 0's
    (test_torch_port_multiprocess.py checks the broadcast)."""
    from mh_config import tiny_mh_config
    config = tiny_mh_config()
    rng = jax.random.PRNGKey(20200823)
    leaves = []
    for host in (0, 1):
        key, _ = jax.random.split(jax.random.fold_in(rng, host))
        _, variables = jax_construct_model(key, jstructs.dummy_rays(), config)
        leaves.append(jax.tree_util.tree_leaves(variables["params"]))
    assert any(not np.array_equal(a, b) for a, b in zip(*leaves))
    tconfig = tyaml.load_yaml_config(tu.write_tiny_yaml(str(tmp_path)))
    models = [construct_model(tconfig, "cpu",
                              torch.Generator().manual_seed(tconfig.seed))
              for _ in range(2)]
    for (k, a), b in zip(models[0].state_dict().items(),
                         models[1].state_dict().values()):
        assert torch.equal(a, b), k


def train_and_render(config, init_state, steps: int = 2):
    model = construct_model(config, "cpu", torch.Generator().manual_seed(0))
    model.load_state_dict(init_state)
    mesh.replicate(model)
    opt, sched = tstep.create_optimizer(config, model)
    dataset = load_dataset("train", "", config, is_training=True)
    thresholds = tstep.initial_inlier_thresholds(config, "cpu")
    stats = []
    for i in range(steps):
        s = tstep.train_step(model, opt, sched, next(dataset).to("cpu"),
                             0.3 + 0.1 * i, config, None, thresholds)
        if config.transient_type == "robustnerf":
            thresholds = s["robust_inlier_threshold"]
        stats.append(s)
    rays = load_dataset("test", "", config,
                        is_training=False).generate_ray_batch(0).rays
    return model.state_dict(), stats, render_image(model, rays, 1.0, config,
                                                   "cpu")


@pytest.mark.parametrize("robust", [False, True])
def test_a_group_of_one_computes_what_one_process_does(tmp_path, robust):
    cfg = tu.write_tiny_yaml(str(tmp_path), *(
        (ROBUST_BASE, ROBUST_MODEL) if robust else ()))
    config = tyaml.load_yaml_config(cfg)
    config.model.num_embeddings = 8
    config.render_chunk_size = 77
    init = construct_model(config, "cpu",
                           torch.Generator().manual_seed(3)).state_dict()
    alone = train_and_render(config, init)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        assert mesh.is_distributed() and mesh.process_count() == 1
        grouped = train_and_render(config, init)
        assert mesh.broadcast_ints([5]) == [5]
    finally:
        dist.destroy_process_group()
    for k, v in alone[0].items():
        assert torch.equal(v, grouped[0][k]), k
    for a, b in zip(alone[1], grouped[1]):
        assert set(a) == set(b)
        for k in a:
            if k == "losses":
                for t in a[k]:
                    assert torch.equal(a[k][t], b[k][t]), t
            else:
                assert torch.equal(a[k], b[k]), k
    for k, v in alone[2].items():
        if k.startswith("ray_"):
            continue
        np.testing.assert_array_equal(v, grouped[2][k], k)
