"""The gin side of the port's config tree: so far the `config.gin`
snapshot a training run writes into its checkpoint directory, a copy of
`config_str` of nerf_hugs_tpu/configs/gin_parser.py. The parser of the
gin dialect itself (`--gin_configs` / `--gin_bindings`) is not ported yet
(ROADMAP.md Queue 1 item 14a).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from nerf_hugs_torch.configs.config import Config


def config_str(config: Config) -> str:
    """Serialize the config back to gin-ish text (config.gin snapshot parity
    with configs.py:200-203)."""
    lines = []

    def emit(section: str, obj: Any) -> None:
        for f in dataclasses.fields(obj):
            if f.name in ("model", "nerf_mlp", "prop_mlp", "nerfacto"):
                continue
            lines.append(f"{section}.{f.name} = {getattr(obj, f.name)!r}")

    emit("Config", config)
    emit("Model", config.model)
    emit("NerfMLP", config.nerf_mlp)
    emit("PropMLP", config.prop_mlp)
    emit("Nerfacto", config.nerfacto)
    return "\n".join(lines) + "\n"
