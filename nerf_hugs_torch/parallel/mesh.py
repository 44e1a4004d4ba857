"""Multi-process data parallelism: one process (rank) per device.

Counterpart of nerf_hugs_tpu/parallel/mesh.py over torch.distributed. JAX
runs one program over a global ('data',) mesh of every host's devices and
lets XLA insert the collectives; here every rank runs the whole program on
its own device, and the collectives are explicit:

  JAX (nerf_hugs_tpu/parallel/mesh.py)  here
  maybe_initialize_distributed          maybe_initialize_distributed: from
                                        the launcher's environment (RANK,
                                        WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
                                        MASTER_PORT, as torchrun sets them)
  jax.process_index / process_count     process_index / process_count
  make_mesh, data_sharding, replicated  none: one device per rank, and the
                                        parameters stay replicated because
                                        every rank starts from rank 0's
                                        (replicate) and applies the same
                                        mean gradient (mean_over_ranks)
  shard_batch                           shard_batch: each rank moves its
                                        own per-rank batch to its device
  prefetch_to_device                    prefetch_to_device: two batches
                                        ahead through pinned host memory
  replicate                             replicate: rank 0's parameters
                                        and buffers (a resumed optimizer
                                        state is every rank's load of the
                                        one checkpoint rank 0 picked)
  put_global + pad_to_multiple          pad_to_multiple + rank_slice
  the all_gather of the renderings      gather_rows
  (jit's out_shardings, step.py:291)

Every function is the identity (or rank 0, world 1) when no process group
is initialised, so one process started without a launcher computes what it
computed before this module existed. The collectives run only on tensors
that every backend takes on both devices: gloo reduces and broadcasts CUDA
tensors but gathers only CPU ones, so gather_rows all-reduces a
zero-filled [world, n, ...] buffer instead of calling all_gather.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import itertools
import os
import socket
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# A collective that waits longer than this fails instead of hanging.
DEFAULT_TIMEOUT_S = 600.0
BACKENDS = ("nccl", "gloo")


def default_backend(device: str) -> str:
    """The backend of --dist_backend's default: nccl on the card, gloo on
    the CPU."""
    return "nccl" if device == "cuda" else "gloo"


def launched() -> bool:
    """Whether a launcher started this process as one rank of several."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def fold_in(seed: int) -> int:
    """A generator seed of this rank's own (train.py:106-107 folds the host
    index into the step key): rank 0 keeps `seed`."""
    return seed + (process_index() << 32)


def maybe_initialize_distributed(device: str, backend: Optional[str] = None,
                                 timeout_s: float = DEFAULT_TIMEOUT_S
                                 ) -> bool:
    """Join the process group that the launcher's environment describes;
    returns whether this call initialised it. The decision is made from
    the environment alone, before any CUDA call. On the card each rank
    first takes cuda:LOCAL_RANK, and under nccl two ranks on one card
    raise (NCCL refuses them). `backend` defaults to default_backend."""
    if not launched() or is_distributed():
        return False
    backend = backend or default_backend(device)
    if backend not in BACKENDS:
        raise ValueError(f"dist_backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda requested but no CUDA device "
                               "is available")
        if local_rank() >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local_rank()} has no card: "
                f"{torch.cuda.device_count()} visible")
        torch.cuda.set_device(local_rank())
    elif backend == "nccl":
        raise ValueError("dist_backend nccl needs --device cuda")
    dist.init_process_group(
        backend, init_method="env://",
        timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
        _check_one_rank_per_card()
    return True


def shutdown(initialized: bool) -> None:
    """Leave the process group that maybe_initialize_distributed joined."""
    if initialized and is_distributed():
        dist.destroy_process_group()


def duplicate_cards(cards: Sequence[str]) -> List[str]:
    """The cards (host/uuid) that more than one rank holds."""
    counts = collections.Counter(cards)
    return sorted(c for c, n in counts.items() if n > 1)


def _check_one_rank_per_card() -> None:
    """Compare the ranks' cards over a gloo group, which does not touch
    NCCL, and raise on every rank if two ranks share one."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    card = f"{socket.gethostname()}/{props.uuid}"
    group = dist.new_group(backend="gloo")
    cards: List[Optional[str]] = [None] * process_count()
    dist.all_gather_object(cards, card, group=group)
    dist.destroy_process_group(group)
    shared = duplicate_cards(cards)
    if shared:
        raise RuntimeError(
            f"dist_backend nccl takes one rank per card, and ranks share "
            f"{shared} (set LOCAL_RANK or CUDA_VISIBLE_DEVICES per rank, or "
            f"pass --dist_backend gloo)")


def _collective_device() -> torch.device:
    """Where a small collective's tensor lives: nccl reduces CUDA tensors
    only."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if is_distributed():
        dist.all_reduce(torch.zeros(1, device=_collective_device()))


def broadcast_ints(values: Sequence[int]) -> List[int]:
    """Rank 0's `values` on every rank."""
    if not is_distributed():
        return list(values)
    t = torch.tensor(list(values), dtype=torch.int64,
                     device=_collective_device())
    dist.broadcast(t, src=0)
    return t.tolist()


def shard_batch(batch, device):
    """This rank's batch (already per-rank: data/base.py divides the batch
    by the world size) on its device; on the card through pinned host
    memory, so that the copy does not wait for the host."""
    device = torch.device(device)
    return batch.to(device, pin=device.type == "cuda")


def prefetch_to_device(iterator, device, size: int = 2) -> Iterator:
    """The batches of `iterator` on `device`, each copy started `size`
    batches before it is consumed."""
    queue = collections.deque()

    def enqueue(n):
        for batch in itertools.islice(iterator, n):
            queue.append(shard_batch(batch, device))

    enqueue(size)
    while queue:
        yield queue.popleft()
        enqueue(1)


@torch.no_grad()
def replicate(module: torch.nn.Module) -> None:
    """Overwrite every rank's parameters and buffers with rank 0's."""
    if not is_distributed():
        return
    for t in module.state_dict().values():
        dist.broadcast(t, src=0)


def _fields(tree) -> list:
    if dataclasses.is_dataclass(tree):
        return [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    return [tree]


def _map(fn, tree):
    return tree.map(fn) if dataclasses.is_dataclass(tree) else fn(tree)


def pad_to_multiple(tree, multiple: int):
    """Edge-pad every field's leading axis to a multiple of `multiple`;
    returns (tree, pad). `tree` is an array, a tensor or a structs
    container of either."""
    n = _fields(tree)[0].shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return tree, 0

    def _pad(x):
        if torch.is_tensor(x):
            return torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])])
        widths = [(0, pad)] + [(0, 0)] * (np.ndim(x) - 1)
        return np.pad(x, widths, mode="edge")
    return _map(_pad, tree), pad


def rank_slice(tree):
    """This rank's contiguous share of a leading axis that divides by the
    world size (pad_to_multiple): rows [r n / W, (r + 1) n / W), as
    put_global hands them to the devices of host r."""
    n = _fields(tree)[0].shape[0]
    world, rank = process_count(), process_index()
    if n % world:
        raise ValueError(f"{n} rows do not split over {world} ranks")
    per = n // world
    return _map(lambda x: x[rank * per:(rank + 1) * per], tree)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's `x` ([n, ...], the same n on each), concatenated in
    rank order, on every rank: one all-reduce of a zero-filled
    [world, n, ...] buffer, which both backends take on either device and
    which adds nothing but zeros to each rank's rows."""
    if not is_distributed():
        return x
    buf = x.new_zeros((process_count(),) + tuple(x.shape))
    buf[process_index()] = x
    dist.all_reduce(buf)
    return buf.reshape((-1,) + tuple(x.shape[1:]))


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the ranks (a new tensor)."""
    if not is_distributed():
        return x
    x = x.clone()
    dist.all_reduce(x)
    return x


def mean_over_ranks(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor's mean over the ranks, in one all-reduce per dtype."""
    tensors = list(tensors)
    if not is_distributed() or not tensors:
        return tensors
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = collections.defaultdict(list)
    for i, t in enumerate(tensors):
        by_dtype[t.dtype].append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat)
        flat /= process_count()
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out
