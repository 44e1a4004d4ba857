"""The gin dialect of the port's config tree: a copy of
nerf_hugs_tpu/configs/gin_parser.py (jax-free there too), so that
`python -m nerf_hugs_torch.{train,eval} --gin_configs ... --gin_bindings
...` parse the shipped configs/mipnerf360/*.gin into the same Config the
JAX drivers build.

The shipped .gin files use only the subset
  Section.field = <python literal> | @module.symbol | %gin.REQUIRED
with sections Config / Model / NerfMLP / PropMLP / MLP, # comments and the
`include '...'` line of the *_tpu_bf16 overlays. Callables are kept as
names (`@jnp.reciprocal` -> 'reciprocal'), which configs.config resolves
to torch functions at model construction.

No gin config scopes: a `scope/Section.field` binding is refused loudly,
as in JAX; no shipped config uses one. `config_str` writes the
checkpoint directory's config.gin snapshot.
"""

from __future__ import annotations

import ast
import os
import dataclasses
import re
from typing import Any, Iterable, List, Optional

from nerf_hugs_torch.configs.config import Config

# @references that appear in the shipped gin files (configs.py:29-42 exposes
# these to gin) -> our string names resolved at model construction.
_REF_NAMES = {
    "jnp.reciprocal": "reciprocal",
    "jnp.log": "log",
    "jnp.log1p": "log1p",
    "jnp.exp": "exp",
    "jnp.sqrt": "sqrt",
    "jnp.square": "square",
    "jax.nn.relu": "relu",
    "jax.nn.softplus": "softplus",
    "jax.nn.silu": "silu",
    "coord.contract": "contract",
    "math.safe_exp": "safe_exp",
}

_SECTION_ATTR = {
    "Config": None,          # top-level
    "Model": "model",
    "NerfMLP": "nerf_mlp",
    "PropMLP": "prop_mlp",
    "MLP": "_both_mlps",     # gin would bind the shared base; apply to both
}


class GinParseError(ValueError):
    pass


def _parse_value(text: str) -> Any:
    text = text.strip()
    if text.startswith("@"):
        ref = text[1:].strip()
        if ref in _REF_NAMES:
            return _REF_NAMES[ref]
        # Fall back to the last path component ('foo.bar.baz' -> 'baz').
        return ref.split(".")[-1]
    if text.startswith("%"):
        raise GinParseError(f"unsupported gin macro {text!r} (set it explicitly)")
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError) as e:
        raise GinParseError(f"cannot parse gin value {text!r}") from e


def _logical_lines(raw: str) -> Iterable[str]:
    """Strip comments and join bracket/paren continuations into single lines."""
    buf = ""
    depth = 0
    for line in raw.splitlines():
        line = re.sub(r"#.*$", "", line).rstrip()
        if not line.strip() and depth == 0:
            continue
        buf += (" " if buf else "") + line.strip()
        depth = (buf.count("(") - buf.count(")")
                 + buf.count("[") - buf.count("]")
                 + buf.count("{") - buf.count("}"))
        if depth == 0 and buf:
            yield buf
            buf = ""
    if buf:
        yield buf


def apply_binding(config: Config, binding: str) -> None:
    """Apply one 'Section.field = value' binding to the config in place."""
    m = re.match(r"^([A-Za-z_][\w]*)\.([\w]+)\s*=\s*(.+)$", binding.strip())
    if not m:
        if re.match(r"^[\w]+/[\w]", binding.strip()):
            raise GinParseError(
                f"gin config scopes are not supported: {binding!r} — no "
                "shipped config uses scoped bindings (see module docstring); "
                "use an explicit Config field instead")
        raise GinParseError(f"unparseable gin binding: {binding!r}")
    section, field, raw_value = m.groups()
    if section not in _SECTION_ATTR:
        raise GinParseError(f"unknown gin section {section!r} in {binding!r}")
    value = _parse_value(raw_value)

    targets = []
    attr = _SECTION_ATTR[section]
    if attr is None:
        targets = [config]
    elif attr == "_both_mlps":
        targets = [config.nerf_mlp, config.prop_mlp]
    else:
        targets = [getattr(config, attr)]
    for target in targets:
        if not hasattr(target, field):
            raise GinParseError(
                f"{section}.{field} does not exist on {type(target).__name__}")
        current = getattr(target, field)
        # Coerce list literals onto tuple-typed fields.
        if isinstance(current, tuple) and isinstance(value, list):
            value = tuple(value)
        setattr(target, field, value)


def parse_gin_configs(config_files: List[str],
                      bindings: Optional[List[str]] = None,
                      config: Optional[Config] = None) -> Config:
    """Parse gin files (in order) + extra bindings into a Config."""
    config = config if config is not None else Config()
    # The finetune_* aliases default to the *final* value of their base field
    # (batch_size etc.); un-resolve them so overrides propagate, then
    # __post_init__ re-resolves whatever the user didn't set explicitly.
    for name in ("finetune_batch_size", "finetune_patch_size",
                 "finetune_patch_dilation", "finetune_image_num_per_batch"):
        setattr(config, name, None)
    def apply_file(path: str) -> None:
        with open(path, "r") as f:
            for line in _logical_lines(f.read()):
                if line.startswith("include"):
                    # gin-style include: quoted path, relative to the
                    # including file (used by the *_tpu_bf16 overlays).
                    inc = line.split(None, 1)[1].strip().strip("'\"")
                    apply_file(os.path.join(os.path.dirname(path), inc))
                    continue
                apply_binding(config, line)

    for path in config_files or []:
        apply_file(path)
    for binding in bindings or []:
        apply_binding(config, binding)
    config.__post_init__()  # re-resolve finetune_* aliases after overrides
    return config


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
