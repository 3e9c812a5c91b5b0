"""Config system: named hyperparameter sets in config.json + overrides.

Port of ``rnet/config.py``: the same frozen ``ModelConfig`` fields, the same
``config.json`` (read as a data file from the repository root) and the same
override rules, so a config name or flag means the same model in both
packages.

``rl_impl`` keeps the reference's values so configs and flags carry across:
  * ``naive``  — literal pair concatenation (test oracle);
  * ``xla``    — the decomposed plain-torch path (u/v/s factoring);
  * ``pallas`` — the hand-written CUDA kernel (``rnet_torch/csrc``);
  * ``pallas_int8`` — inference only: the int8 CUDA kernel
    (``rnet_torch/csrc/pairwise_fwd_int8.cu``) in eval mode, ``pallas`` in
    train mode (with a warning);
  * ``auto``   — the kernel on CUDA in bf16 for large uniform shapes, else xla.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CONFIG_PATH = os.path.join(_REPO_ROOT, "config.json")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Hyperparameters for one named RN variant (fields as in rnet/config.py)."""

    name: str = "original-fp"
    state_description: bool = False

    # --- from-pixels path ---
    image_size: int = 128
    conv_channels: Tuple[int, ...] = (24, 24, 24, 24)
    conv_kernel: int = 3
    conv_stride: int = 2

    # --- state-description path ---
    max_objects: int = 12
    object_dim: int = 18  # 3 coords + 8 color + 3 shape + 2 material + 2 size
    object_mask: bool = False

    # --- question encoder ---
    lstm_word_emb: int = 32
    lstm_hidden: int = 128
    question_max_len: int = 48
    # True: pad steps carry the LSTM state through unchanged. False: the
    # recurrence also runs over pad steps (the reference's behaviour).
    lstm_mask_pads: bool = True

    # --- relational core ---
    g_layers: Tuple[int, ...] = (256, 256, 256, 256)
    question_injection_position: int = 0
    f_layers: Tuple[int, ...] = (256, 256)
    dropout: float = 0.5
    pair_dropout: float = 0.0
    pair_pool: str = "sum"  # 'sum' | 'mean' (pooled / n^2)

    # --- runtime ---
    n_answers: int = 28
    device_augment: bool = False
    rl_impl: str = "auto"  # 'auto' | 'naive' | 'xla' | 'pallas' | 'pallas_int8'
    augment_impl: str = "auto"
    compute_dtype: str = "bfloat16"  # 'bfloat16' | 'float32'; params stay fp32

    @property
    def grid(self) -> int:
        """Side of the conv feature grid (from-pixels)."""
        g = self.image_size
        for _ in self.conv_channels:
            g = (g + 2 * (self.conv_kernel // 2) - self.conv_kernel) // self.conv_stride + 1
        return g

    @property
    def n_objects(self) -> int:
        return self.max_objects if self.state_description else self.grid * self.grid

    @property
    def obj_feat_dim(self) -> int:
        """Per-object feature dim entering the relational core."""
        if self.state_description:
            return self.object_dim
        return self.conv_channels[-1] + 2  # conv features + 2-D coordinate tag

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_TUPLE_FIELDS = {"conv_channels", "g_layers", "f_layers"}


def _coerce(d: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    valid = {f.name for f in dataclasses.fields(ModelConfig)}
    for k, v in d.items():
        if k not in valid:
            continue
        if k in _TUPLE_FIELDS and isinstance(v, list):
            v = tuple(v)
        out[k] = v
    return out


def load_config(
    model: str = "original-fp",
    config_path: Optional[str] = None,
    overrides: Optional[Dict[str, Any]] = None,
) -> ModelConfig:
    """Load a named model config, applying CLI-style overrides (None = keep)."""
    path = config_path or DEFAULT_CONFIG_PATH
    with open(path) as f:
        all_cfg = json.load(f)
    if model not in all_cfg:
        raise KeyError(
            f"model {model!r} not in {path}; available: {sorted(all_cfg)}"
        )
    d = _coerce(all_cfg[model])
    d["name"] = model
    if overrides:
        d.update(_coerce({k: v for k, v in overrides.items() if v is not None}))
    cfg = ModelConfig(**d)
    if cfg.pair_pool not in ("sum", "mean"):
        raise ValueError(
            f"pair_pool must be 'sum' or 'mean', got {cfg.pair_pool!r}"
        )
    if cfg.object_mask and not cfg.state_description:
        raise ValueError(
            f"--object-mask requires a state-description model; "
            f"{model!r} is from-pixels (every grid cell is a real object)"
        )
    return cfg


def list_models(config_path: Optional[str] = None) -> List[str]:
    path = config_path or DEFAULT_CONFIG_PATH
    with open(path) as f:
        return sorted(json.load(f))
