"""The least time the hash-grid kernels could take at a step's inputs:
the larger of the bytes over the memory rate and the float32 operations
over the FMA peak (the grid's arithmetic runs outside the tensor cores).

Each kernel reads the positions and writes the [n, L * F] features
(forward) or reads the output gradient (table gradient) once; the forward
reads the table rows these positions touch, the table gradient writes the
whole table. Per sample and level the work is (d - 1) products for each of
the 2^d corner weights and 4 operations per corner of the weighted sums.
"""

from __future__ import annotations

from benchmark import peaks
from benchmark.reference.hashgrid import Grid, rows_touched


def grid_of(spec) -> Grid:
    """The yardstick's grid of a module's spec (xor hashing only)."""
    if getattr(spec, "hash_impl", "xor") != "xor":
        raise ValueError("the bounds count the xor hash")
    return Grid(spec.num_levels, spec.features_per_level,
                spec.log2_hashmap_size, spec.base_res, spec.max_res,
                spec.num_dims)


def bounds_ms(spec, positions) -> dict:
    """{"fwd": (ms, set by), "bwd": (ms, set by)} of one launch each."""
    grid = grid_of(spec)
    d, f = grid.num_dims, grid.features_per_level
    n = positions.numel() // d
    flops = (d - 1 + 4) * 2 ** d * n * grid.num_levels
    io = positions.numel() * 4 + n * grid.output_dim * 4
    nbytes = {"fwd": io + rows_touched(grid, positions) * f * 4,
              "bwd": io + grid.num_rows * f * 4}
    out = {}
    for k, b in nbytes.items():
        t_bytes = b / peaks.HBM_BYTES_PER_S * 1e3
        t_ops = flops / peaks.FLOPS["float32"] * 1e3
        out[k] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")
    return out


def capture_hashgrid_inputs(run) -> None:
    """Keep the positions each hash-grid encoder of the program's model
    was last called with (run.captures["hashgrid"]: {module: (spec,
    positions)}); an encoder is a module with a grid `spec` and a
    `table`."""
    captures = run.__dict__.setdefault("captures", {})
    if "hashgrid" in captures:
        return
    store = captures["hashgrid"] = {}
    for name, module in run.trainee.model.named_modules():
        spec = getattr(module, "spec", None)
        if spec is None or not hasattr(module, "table") \
                or not hasattr(spec, "num_levels"):
            continue

        def hook(mod, inputs, output, name=name):
            store[name] = (mod.spec, inputs[0].detach())
        module.register_forward_hook(hook)


def step_bound_ms(run, kind: str):
    """The sum of one step's launches' bounds of `kind` (fwd or bwd), and
    what sets the largest; None without captures."""
    store = getattr(run, "captures", {}).get("hashgrid")
    if not store:
        return None
    parts = [bounds_ms(spec, p)[kind] for spec, p in store.values()]
    return sum(ms for ms, _ in parts), max(parts)[1]
