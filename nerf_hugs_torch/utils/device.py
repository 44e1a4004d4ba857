"""Device selection and float32 precision pinning."""

from __future__ import annotations

import torch

from nerf_hugs_torch.parallel import mesh


def pin_fp32_precision() -> None:
    """Run float32 matmuls and convolutions in full float32, not TF32.

    The JAX package pins `precision=HIGHEST` (nerf_hugs_tpu/core/math.py:21);
    TF32 keeps about three decimal digits, so both switches go off here."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(name: str) -> torch.device:
    """`cpu` or `cuda`; asking for `cuda` on a machine without a GPU raises
    rather than falling back to the CPU. Under a process group `cuda` is
    the rank's own card, cuda:LOCAL_RANK (mesh.maybe_initialize_distributed
    has checked it)."""
    if name not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but no CUDA device is "
                           "available")
    if name == "cuda" and mesh.is_distributed():
        return torch.device("cuda", mesh.local_rank())
    return torch.device(name)
