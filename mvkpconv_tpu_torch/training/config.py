"""Configuration for KPConv-family models, PyTorch port.

Counterpart of ``mvkpconv_tpu/training/config.py``: the same frozen
dataclass with every field and default, the same ``parameters.txt`` text
round trip (a file written by either package loads in the other), and the
same derived helpers (``num_layers``, ``pyramid_spec``, ``replace``,
``validate``). ``compute_dtype`` is a ``torch.dtype`` here and is written as
its bare name (``'float32'`` / ``'bfloat16'``), exactly as the JAX package
writes ``jnp.dtype(...).name``.

Several fields name TPU strategies for one function (neighbor selection
method, pixel selection method, KPConv contraction form, the fused KPConv
kernel, influence cache policy, gather VJP). They are accepted so that
configurations load unchanged; :meth:`KPConfig.port_option` maps each to
the port's path for it and warns once per (field, value) where that path
is another strategy. The gather VJP keeps three native modes (``scatter``,
``banded``, ``banded_bf16``; see ``ops/gather.py``), and ``use_pallas_kpconv``
selects the port's own fused KPConv kernel.
"""

from __future__ import annotations

import ast
import dataclasses
import warnings
from pathlib import Path
from typing import Any, Optional, Tuple

import torch

ARCHITECTURE_DEEPER = (
    "simple",
    "resnetb",
    "resnetb_strided",
    "resnetb",
    "resnetb",
    "resnetb_strided",
    "resnetb",
    "resnetb",
    "resnetb_strided",
    "resnetb",
    "resnetb",
    "resnetb_strided",
    "resnetb",
    "resnetb",
    "nearest_upsample",
    "unary",
    "nearest_upsample",
    "unary",
    "nearest_upsample",
    "unary",
    "nearest_upsample",
    "unary",
)

# field -> {accepted value: the port's path for it}. Values missing from a
# field's map are rejected by ``port_option``.
_PORT_PATHS = {
    # one exact selection kernel (ops/kernels/radius_topk.py)
    "neighbor_method": {"binmin": "binmin", "approx": "binmin", "exact": "binmin"},
    # one exact pixel selection kernel (ops/kernels/pixel_select.py)
    "pixel_select": {
        "pallas": "pallas", "minext": "pallas", "approx": "pallas",
        "exact": "pallas",
    },
    "kpconv_tail": {
        "auto": "einsum", "einsum": "einsum", "vpu": "einsum",
        "gform_dot": "einsum", "gform_vpu": "einsum",
    },
    # the fused KPConv kernel (ops/kernels/kpconv.py); it runs only in blocks
    # that get no precomputed influence (influence_cache='none', or a cache
    # over influence_cache_budget_mb), as in the JAX package
    "use_pallas_kpconv": {False: False, True: True},
    "influence_cache": {"prebuilt": "prebuilt", "none": "none", "lazy": "prebuilt"},
    # the group_points VJP (ops/gather.py): 'sorted' and 'window' are the
    # same exact segment sum under other TPU strategies, so kernel K3
    "gather_transpose": {
        "scatter": "scatter", "sorted": "banded", "window": "banded",
        "banded": "banded", "banded_bf16": "banded_bf16",
    },
}
# values that name the port's path without a change of strategy
_NATIVE = {
    "neighbor_method": ("binmin",),
    "pixel_select": ("pallas",),
    "kpconv_tail": ("auto", "einsum"),
    "use_pallas_kpconv": (False, True),
    "influence_cache": ("prebuilt", "none"),
    "gather_transpose": ("scatter", "banded", "banded_bf16"),
}
_WARNED = set()


def dtype_name(dtype) -> str:
    """'float32' / 'bfloat16' for a torch dtype (or a name)."""
    if isinstance(dtype, str):
        return dtype
    return str(dtype).replace("torch.", "")


def as_torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", dtype)  # numpy / jnp dtypes carry .name
    out = getattr(torch, str(name), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown compute dtype {dtype!r}")
    return out


@dataclasses.dataclass(frozen=True)
class KPConfig:
    """Static model + training configuration (field-for-field the JAX one)."""

    # ----- dataset / task -----
    num_classes: int = 20
    ignore_label: int = -1

    # ----- model topology -----
    architecture: Tuple[str, ...] = ARCHITECTURE_DEEPER
    num_kernel_points: int = 15
    in_radius: float = 1.2
    first_subsampling_dl: float = 0.04
    conv_radius: float = 2.5
    deform_radius: float = 6.0
    kp_extent: float = 1.2
    kp_influence: str = "linear"  # constant | linear | gaussian
    aggregation_mode: str = "sum"  # sum | closest
    first_features_dim: int = 128
    in_features_dim: int = 66
    modulated: bool = False
    use_batch_norm: bool = True
    batch_norm_momentum: float = 0.02

    # ----- fusion -----
    fusion: str = "none"  # none | early | middle | late
    num_views: int = 5
    image_height: int = 120
    image_width: int = 160
    feature_2d_dim: int = 64
    use_point_color: bool = True
    pixel_knn: int = 3
    pixel_assoc: str = "projective"
    pixel_window: int = 7
    pixel_select: str = "pallas"
    pixel_patch_dtype: str = "bfloat16"

    # ----- deformable regularizer -----
    deform_fitting_power: float = 1.0
    repulse_extent: float = 1.2
    deform_lr_factor: float = 0.1

    # ----- training -----
    max_epoch: int = 500
    epoch_steps: int = 500
    validation_size: int = 50
    checkpoint_gap: int = 50
    learning_rate: float = 1e-2
    momentum: float = 0.98
    lr_decay: float = 0.1 ** (1 / 150)
    grad_clip_value: float = 100.0
    batch_num: int = 5
    class_weights: Optional[Tuple[float, ...]] = None
    segloss_balance: str = "none"
    label_smoothing: float = 0.0

    # ----- augmentation -----
    augment_scale_anisotropic: bool = True
    augment_symmetries: Tuple[bool, bool, bool] = (True, False, False)
    augment_rotation: str = "vertical"
    augment_scale_min: float = 0.9
    augment_scale_max: float = 1.1
    augment_noise: float = 0.001
    augment_color: float = 1.0

    # ----- static budgets -----
    num_points: Tuple[int, ...] = (16384, 4096, 1024, 256, 128)
    conv_neighbors: Tuple[int, ...] = (34, 34, 34, 34, 34)
    pool_neighbors: Tuple[int, ...] = (34, 34, 34, 34)
    deform_conv_neighbors: Tuple[int, ...] = ()
    deform_pool_neighbors: Tuple[int, ...] = ()
    neighbor_method: str = "binmin"
    use_pallas_kpconv: bool = False
    kpconv_tail: str = "auto"
    remat: str = "none"
    influence_cache_budget_mb: float = 1024.0
    influence_cache: str = "prebuilt"
    gather_transpose: str = "banded_bf16"
    compute_dtype: Any = torch.float32
    mesh_shape: Tuple[int, ...] = (1,)

    def __post_init__(self):
        object.__setattr__(self, "compute_dtype", as_torch_dtype(self.compute_dtype))

    # ------------------------------------------------------------------
    @property
    def num_layers(self) -> int:
        from mvkpconv_tpu_torch.ops.pyramid import num_layers_from_architecture

        return num_layers_from_architecture(self.architecture)

    def pyramid_spec(self):
        from mvkpconv_tpu_torch.ops.pyramid import (
            PyramidSpec,
            deform_flags_from_architecture,
        )

        self.port_option("neighbor_method")
        levels = self.num_layers
        conv_flags, pool_flags = deform_flags_from_architecture(self.architecture)
        return PyramidSpec(
            num_points=tuple(self.num_points[:levels]),
            first_subsampling_dl=self.first_subsampling_dl,
            conv_radius=self.conv_radius,
            deform_radius=self.deform_radius,
            conv_neighbors=tuple(self.conv_neighbors[:levels]),
            pool_neighbors=tuple(self.pool_neighbors[: levels - 1]),
            deform_conv_levels=conv_flags,
            deform_pool_levels=pool_flags,
            deform_conv_neighbors=(
                tuple(self.deform_conv_neighbors[:levels])
                if self.deform_conv_neighbors
                else None
            ),
            deform_pool_neighbors=(
                tuple(self.deform_pool_neighbors[: levels - 1])
                if self.deform_pool_neighbors
                else None
            ),
            neighbor_method=self.neighbor_method,
        )

    def replace(self, **kwargs) -> "KPConfig":
        return dataclasses.replace(self, **kwargs)

    @property
    def base_feature_dim(self) -> int:
        """Width of the non-lifted 3D feature columns."""
        return self.in_features_dim - (
            self.feature_2d_dim if self.fusion != "none" else 0
        )

    def validate(self) -> "KPConfig":
        """Fail fast on inconsistent fusion/feature settings."""
        supported = (1, 2, 4, 5, 7)
        if self.base_feature_dim not in supported:
            raise ValueError(
                f"in_features_dim={self.in_features_dim} with fusion="
                f"{self.fusion!r} implies base feature dim "
                f"{self.base_feature_dim}; supported base dims are "
                f"{supported} (e.g. fusion='early' wants 64+base, "
                f"fusion='none' wants base alone)"
            )
        if self.fusion not in ("none", "early", "middle", "late"):
            raise ValueError(f"unknown fusion {self.fusion!r}")
        if self.kpconv_tail not in (
            "auto", "einsum", "vpu", "gform_dot", "gform_vpu"
        ):
            raise ValueError(f"unknown kpconv_tail {self.kpconv_tail!r}")
        if self.influence_cache not in ("prebuilt", "lazy", "none"):
            raise ValueError(
                f"unknown influence_cache {self.influence_cache!r}"
            )
        return self

    def port_option(self, field: str) -> str:
        """The port's path for a strategy field, warning once where the
        configured value names a TPU-only strategy."""
        value = getattr(self, field)
        paths = _PORT_PATHS[field]
        if value not in paths:
            raise ValueError(f"unknown {field} {value!r}")
        if value not in _NATIVE[field] and (field, value) not in _WARNED:
            _WARNED.add((field, value))
            warnings.warn(
                f"{field}={value!r} is a TPU strategy; the PyTorch port runs "
                f"its {paths[value]!r} path instead",
                stacklevel=2,
            )
        return paths[value]

    # ----- parameters.txt-style round trip -----
    def save(self, path) -> None:
        lines = ["# mvkpconv_tpu parameters"]
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "compute_dtype":
                v = dtype_name(v)
            lines.append(f"{f.name} = {v!r}")
        Path(path).write_text("\n".join(lines) + "\n")

    @classmethod
    def load(cls, path) -> "KPConfig":
        kwargs = {}
        names = {f.name for f in dataclasses.fields(cls)}
        for line in Path(path).read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, val = line.split("=", 1)
            key = key.strip()
            if key not in names:
                continue
            val = val.strip()
            if key == "compute_dtype":
                kwargs[key] = as_torch_dtype(ast.literal_eval(val))
            else:
                kwargs[key] = ast.literal_eval(val)
        return cls(**kwargs)
