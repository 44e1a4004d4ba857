"""One rank of the port's multi-process tests (test_torch_port_multiprocess.py).

    RANK=r WORLD_SIZE=2 LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_port_mp_worker.py steps DIR
    ... python tests/torch_port_mp_worker.py hang TIMEOUT_S

`steps`: for each case that the parent wrote into DIR ({case}.pt: the
port config and the initial weights, converted from JAX's), rank r
perturbs its copy of the weights (rank 1 only), takes rank 0's
(mesh.replicate), draws its own share of each global batch from the port's
dataset, takes three deterministic train steps with RobustNeRF's
thresholds fed back, and renders test image 0 with the initial weights
through the host split; it writes {case}_rank{r}.pt.
`hang`: rank 0 waits at a barrier that rank 1 never reaches (it sleeps
for twice the timeout and leaves); rank 0's collective must fail on the
group's timeout.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from nerf_hugs_torch.data import load_dataset  # noqa: E402
from nerf_hugs_torch.models import construct_model  # noqa: E402
from nerf_hugs_torch.parallel import mesh  # noqa: E402
from nerf_hugs_torch.train import step as step_lib  # noqa: E402
from nerf_hugs_torch.train.render_image import render_image  # noqa: E402

STEPS = 3


def train_frac(i: int) -> float:
    return 0.3 + 0.0001 * i


def run_case(path: str, out: str) -> None:
    saved = torch.load(path, weights_only=False)
    config = saved["config"]
    rank = mesh.process_index()
    model = construct_model(config, "cpu", torch.Generator().manual_seed(0))
    model.load_state_dict(saved["state"])
    if rank == 1:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    mesh.replicate(model)
    replicated = all(torch.equal(v, saved["state"][k])
                     for k, v in model.state_dict().items())
    rendering = render_image(model, load_dataset(
        "test", config.data_dir, config, is_training=False
    ).generate_ray_batch(0).rays, 1.0, config, "cpu")

    dataset = load_dataset("train", config.data_dir, config,
                           is_training=True)
    opt, sched = step_lib.create_optimizer(config, model)
    thresholds = step_lib.initial_inlier_thresholds(config, "cpu")
    record = {"batches": [], "loss": [], "psnr": [], "thresholds": []}
    for i in range(STEPS):
        batch = next(dataset)
        record["batches"].append(batch)
        stats = step_lib.train_step(model, opt, sched, batch.to("cpu"),
                                    train_frac(i), config, None, thresholds)
        if config.transient_type == "robustnerf":
            thresholds = stats["robust_inlier_threshold"]
            record["thresholds"].append(thresholds.clone())
        record["loss"].append(float(stats["loss"]))
        record["psnr"].append(float(stats["psnr"]))
    torch.save({**record, "replicated": replicated,
                "rgb": rendering["rgb"],
                "state": model.state_dict()}, out)


def main() -> None:
    mode = sys.argv[1]
    timeout = float(sys.argv[2]) if mode == "hang" else 120.0
    torch.set_num_threads(2)
    assert mesh.maybe_initialize_distributed("cpu", "gloo", timeout)
    rank = mesh.process_index()
    if mode == "hang":
        if rank == 1:
            time.sleep(2 * timeout)
            os._exit(0)
        t0 = time.time()
        try:
            mesh.barrier()
        except Exception as e:  # the group's timeout
            print(f"TIMED_OUT after {time.time() - t0:.1f}s: "
                  f"{type(e).__name__}", flush=True)
            os._exit(3)
        os._exit(0)
    out_dir = sys.argv[2]
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".pt") and "_rank" not in name:
            case = name[:-3]
            run_case(os.path.join(out_dir, name),
                     os.path.join(out_dir, f"{case}_rank{rank}.pt"))
    mesh.barrier()
    mesh.shutdown(True)
    print("WORKER_DONE", flush=True)


if __name__ == "__main__":
    main()
