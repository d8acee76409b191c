"""Serving export (``mvkpconv_tpu/eval/export.py``): a trained model frozen
into one self-contained artifact.

Where the JAX package serializes one XLA program with ``jax.export``, the
port writes one ``torch.export`` program (``torch.export.save``): the whole
inference step (the pyramid, the UNet over the views, the 2D→3D lift, the
KPConv trunk, the softmax) with the weights inside it. The hand-written
kernels stay in it as the ``torch.library`` operators
``mvkpconv::radius_topk`` (K1), ``mvkpconv::pixel_topk`` (K2),
``mvkpconv::kpconv_fused_fwd`` (K4's forward),
``mvkpconv::farthest_point_sample`` (P1, MVPNet's and PointNet++'s FPS: the
loop stays one operator instead of one copy a centroid) and
``mvkpconv::unet_conv`` (K5, one a site of the frozen float32 UNet), so the artifact
launches the kernels on the card and runs their plain versions on the CPU.
The loader, :class:`ServingModel`, imports those operators' modules and no
model code.

Shapes are static, as in the JAX export: the batch contract of the data
pipelines (shadow-padded spheres) is baked in. The program runs on the
device it was exported on; ``ServingModel.load(path, device=...)`` moves it.

Whole-scene serving (:func:`export_whole_scene`): the JAX package scans
the sphere sweep inside its program with ``lax.scan``. ``torch.export``
would unroll a Python loop into one copy of the trunk a chunk of centers,
so the artifact holds the program of one chunk (extract the spheres, run
the model, accumulate the core probabilities) and :class:`ServingModel`
runs the sweep over the chunks (:func:`sweep`).
"""

from __future__ import annotations

import io
import json
from pathlib import Path
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

# the operators an exported program calls; importing registers them
from mvkpconv_tpu_torch.ops.kernels import fps as _p1  # noqa: F401
from mvkpconv_tpu_torch.ops.kernels import kpconv as _k4  # noqa: F401
from mvkpconv_tpu_torch.ops.kernels import pixel_select as _k2  # noqa: F401
from mvkpconv_tpu_torch.ops.kernels import radius_topk as _k1  # noqa: F401
from mvkpconv_tpu_torch.ops.kernels import unet_conv as _k5  # noqa: F401

META_FILE = "mvkpconv_serving.json"
SHADOW_COORD = 1.0e6  # ops/common.py


class TensorSpec(NamedTuple):
    """Shape and type of one input (``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype


def batch_spec_for(cfg, kind: str, batch_num: Optional[int] = None) -> Dict[str, TensorSpec]:
    """The inference batch contract of ``cfg``: ``kpfcnn`` takes points,
    mask and features; ``mvkpconv`` also the views' images, depth,
    intrinsics and poses; ``mvpnet`` the points and the views."""
    b = batch_num or cfg.batch_num
    n0 = cfg.num_points[0]
    f32 = torch.float32
    v, h, w = cfg.num_views, cfg.image_height, cfg.image_width
    geom = {
        "images": TensorSpec((b, v, h, w, 3), f32),
        "depth": TensorSpec((b, v, h, w), f32),
        "intrinsics": TensorSpec((b, v, 3, 3), f32),
        "poses": TensorSpec((b, v, 4, 4), f32),
    }
    if kind == "mvpnet":
        return {"points": TensorSpec((b, n0, 3), f32), **geom}
    spec = {
        "points": TensorSpec((b, n0, 3), f32),
        "mask": TensorSpec((b, n0), torch.bool),
        "features": TensorSpec((b, n0, cfg.in_features_dim - cfg.feature_2d_dim), f32),
    }
    if kind == "mvkpconv":
        spec.update(geom)
    elif kind != "kpfcnn":
        raise ValueError(f"no default batch spec for kind {kind!r}; pass batch_spec")
    return spec


def infer_kind(cfg) -> str:
    """Model family from the configuration (as the tools build it)."""
    return "kpfcnn" if cfg.fusion == "none" else "mvkpconv"


def _examples(spec: Dict[str, TensorSpec], device) -> Dict[str, torch.Tensor]:
    """Zeros of the spec's shapes: ``torch.export`` traces with fake tensors
    of their shapes and never reads the values."""
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device) for k, s in spec.items()}


def _spec_json(spec: Dict[str, TensorSpec]) -> dict:
    return {k: [list(s.shape), str(s.dtype).replace("torch.", "")] for k, s in spec.items()}


def _export(module: nn.Module, model: nn.Module, args: tuple, meta: dict) -> bytes:
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(module, args, strict=False)
    finally:
        model.train(was_training)
    program.example_inputs = None  # else the artifact keeps the zeros traced with
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={META_FILE: json.dumps(meta)})
    return buf.getvalue()


class _Inference(nn.Module):
    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        from mvkpconv_tpu_torch.infer import apply_model, model_pyramid

        return torch.softmax(apply_model(self.model, batch, model_pyramid(self.model, batch)), dim=-1)


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def export_inference(model: nn.Module, cfg, kind: Optional[str] = None,
                     batch_spec: Optional[Dict[str, TensorSpec]] = None) -> bytes:
    """The inference step (batch → per-point class probabilities) of
    ``model`` (its weights inside the artifact) as ``torch.export.save``
    bytes, traced on the model's device. ``kind`` defaults to
    :func:`infer_kind`; ``batch_spec`` to :func:`batch_spec_for`."""
    kind = kind or infer_kind(cfg)
    spec = batch_spec or batch_spec_for(cfg, kind)
    meta = {"program": "batch", "kind": kind, "spec": _spec_json(spec)}
    return _export(_Inference(model), model, (_examples(spec, _device(model)),), meta)


def save_exported(data: bytes, path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)
    return path


def sweep(chunk_fn, scene: Dict[str, torch.Tensor], batch_num: int, num_classes: int):
    """The whole-scene sweep: ``chunk_fn`` (a :class:`SceneChunk`, or the
    exported program of one) over the centers in chunks of ``batch_num``,
    accumulating core probabilities; returns ``{"probs", "votes"}``."""
    centers = scene["centers"]
    if centers.shape[0] % batch_num:
        raise ValueError(f"{centers.shape[0]} centers are not chunks of batch_num={batch_num}")
    nmax = scene["points"].shape[0]
    psum = torch.zeros((nmax, num_classes), dtype=torch.float32, device=centers.device)
    cnt = torch.zeros((nmax,), dtype=torch.float32, device=centers.device)
    rest = {k: v for k, v in scene.items() if k != "centers"}
    for chunk in centers.split(batch_num):
        psum, cnt = chunk_fn(rest, chunk, psum, cnt)
    return {"probs": psum / cnt.clamp(min=1.0)[:, None], "votes": cnt}


class ServingModel:
    """A loaded serving artifact: ``probs = ServingModel.load(p)(batch)``.

    Runs without the port's model code (this loader and the kernels'
    operators only). ``input_spec`` is the baked batch contract, checked on
    every call; ``device`` the device the program's weights lie on.
    """

    def __init__(self, program, meta: dict):
        self.program = program
        self.meta = meta
        self._module = program.module()

    @classmethod
    def from_bytes(cls, data: bytes, device=None) -> "ServingModel":
        extra = {META_FILE: ""}
        program = torch.export.load(io.BytesIO(data), extra_files=extra)
        meta = json.loads(extra[META_FILE])
        if device is not None:
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, torch.device(device))
        return cls(program, meta)

    @classmethod
    def load(cls, path, device=None) -> "ServingModel":
        return cls.from_bytes(Path(path).read_bytes(), device)

    @property
    def kind(self) -> str:
        return self.meta["kind"]

    @property
    def input_spec(self) -> Dict[str, TensorSpec]:
        return {k: TensorSpec(tuple(shape), getattr(torch, dtype))
                for k, (shape, dtype) in self.meta["spec"].items()}

    @property
    def device(self) -> torch.device:
        for t in self.program.state_dict.values():
            return t.device
        return torch.device("cpu")

    def _check(self, batch: Dict[str, torch.Tensor]):
        spec = self.input_spec
        if set(batch) != set(spec):
            raise ValueError(f"batch keys {sorted(batch)} != the artifact's {sorted(spec)}")
        for k, s in spec.items():
            t = batch[k]
            if tuple(t.shape) != s.shape or t.dtype != s.dtype:
                raise ValueError(f"{k}: {tuple(t.shape)} {t.dtype}, the artifact takes {s.shape} {s.dtype}")

    def __call__(self, batch: Dict[str, torch.Tensor]):
        self._check(batch)
        with torch.no_grad():
            if self.meta["program"] == "batch":
                return self._module(batch)
            return sweep(self._module, batch, self.meta["batch_num"], self.meta["num_classes"])


# ---------------------------------------------------------------------------
# Whole-scene export: the reference's test workload (voting over full
# clouds) served from one artifact.
# ---------------------------------------------------------------------------


def cover_centers(points, in_radius: float, core_ratio: float = 0.7):
    """Deterministic sphere centers whose core regions cover the cloud:
    occupied cells of pitch ``2·core_radius/√3``, centers at the per-cell
    point centroids. (S, 3) float32, numpy."""
    core_r = core_ratio * in_radius
    pitch = 2.0 * core_r / np.sqrt(3.0)
    cells = np.floor(points / pitch).astype(np.int64)
    _, inverse, counts = np.unique(cells, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((len(counts), 3), np.float64)
    np.add.at(sums, inverse.reshape(-1), points)
    return (sums / counts[:, None]).astype(np.float32)


def pad_centers(centers, num_centers: int):
    """Pad a :func:`cover_centers` result to the artifact's static count by
    repeating centers (a repeated sphere adds equal probabilities and counts,
    so the mean is unchanged); raises where there are more."""
    if len(centers) > num_centers:
        raise ValueError(
            f"{len(centers)} cover centers exceed the artifact's static budget "
            f"{num_centers}; re-export with a larger num_centers"
        )
    if len(centers) == num_centers:
        return centers
    reps = -(-num_centers // len(centers))
    return np.tile(centers, (reps, 1))[:num_centers]


def scene_spec_for(cfg, max_points: int, num_centers: int) -> Dict[str, TensorSpec]:
    """The whole-scene serving contract."""
    f32 = torch.float32
    spec = {
        "points": TensorSpec((max_points, 3), f32),
        "mask": TensorSpec((max_points,), torch.bool),
        "features": TensorSpec((max_points, cfg.in_features_dim - cfg.feature_2d_dim), f32),
        "centers": TensorSpec((num_centers, 3), f32),
    }
    if cfg.fusion != "none":
        spec["feature_2d3d"] = TensorSpec((max_points, cfg.feature_2d_dim), f32)
    return spec


class SceneChunk(nn.Module):
    """One chunk of the sweep: for each of its ``batch_num`` centers the
    ``num_points[0]`` nearest valid points (those within ``in_radius`` valid,
    the rest shadow rows), the model on those spheres, and the probabilities
    of the points within ``core_ratio · in_radius`` of their center added to
    ``psum`` and counted in ``cnt``."""

    def __init__(self, model: nn.Module, cfg, core_ratio: float = 0.7):
        super().__init__()
        self.model = model
        self.n0 = cfg.num_points[0]
        self.r2 = float(cfg.in_radius) ** 2
        self.core2 = (core_ratio * float(cfg.in_radius)) ** 2
        self.with_2d = cfg.fusion != "none"

    def forward(self, scene: Dict[str, torch.Tensor], centers, psum, cnt):
        from mvkpconv_tpu_torch.infer import apply_model, model_pyramid

        pts, msk = scene["points"], scene["mask"]
        nmax, c = psum.shape
        d2 = ((pts[None] - centers[:, None]) ** 2).sum(-1)  # (B, Nmax)
        d2 = torch.where(msk[None], d2, torch.full_like(d2, float("inf")))
        neg, idx = torch.topk(-d2, self.n0, dim=-1)
        d2s = -neg
        valid = d2s < self.r2
        sphere = torch.where(valid[..., None], pts[idx] - centers[:, None],
                             torch.full_like(pts[idx], SHADOW_COORD))
        batch = {"points": sphere, "mask": valid, "features": scene["features"][idx]}
        if self.with_2d:
            batch["feature_2d3d"] = scene["feature_2d3d"][idx]
        logits = apply_model(self.model, batch, model_pyramid(self.model, batch))
        probs = torch.softmax(logits.float(), dim=-1)
        core = (valid & (d2s < self.core2)).float()
        rows = (probs * core[..., None]).reshape(-1, c)
        flat = torch.where(valid, idx, torch.full_like(idx, nmax)).reshape(-1)  # invalid → dropped
        psum = torch.cat([psum, psum.new_zeros(1, c)]).index_add(0, flat, rows)[:nmax]
        cnt = torch.cat([cnt, cnt.new_zeros(1)]).index_add(0, flat, core.reshape(-1))[:nmax]
        return psum, cnt


def export_whole_scene(model: nn.Module, cfg, kind: Optional[str], max_points: int,
                       num_centers: int, core_ratio: float = 0.7) -> bytes:
    """The full-cloud inference (scene → per-point probabilities) as
    ``torch.export.save`` bytes: the program of one chunk of
    ``cfg.batch_num`` centers (:class:`SceneChunk`), which the loader sweeps
    over the scene's ``num_centers`` centers.

    Input contract (:func:`scene_spec_for`): points (Nmax, 3) shadow-padded
    subsampled cloud, mask (Nmax,), features (Nmax, base_dim), centers
    (S, 3) from :func:`cover_centers` / :func:`pad_centers`, and for the
    fusion configurations feature_2d3d (Nmax, 64), the lifted 2D features
    precomputed over the scene (``eval/precompute.py``). The loaded artifact
    returns ``{"probs": (Nmax, C), "votes": (Nmax,)}``; ``votes`` counts the
    core predictions of each point (0: no center reached it).
    """
    kind = kind or infer_kind(cfg)
    if kind not in ("kpfcnn", "mvkpconv"):
        raise NotImplementedError(f"whole-scene export of kind {kind!r}")
    bsz = cfg.batch_num
    if num_centers % bsz:
        raise ValueError(
            f"num_centers={num_centers} must be a multiple of batch_num={bsz} "
            f"(centers sweep in batch-size chunks)"
        )
    spec = scene_spec_for(cfg, max_points, num_centers)
    dev = _device(model)
    ex = _examples(spec, dev)
    centers = ex.pop("centers")[:bsz]
    psum = torch.zeros((max_points, cfg.num_classes), dtype=torch.float32, device=dev)
    cnt = torch.zeros((max_points,), dtype=torch.float32, device=dev)
    meta = {"program": "whole_scene", "kind": kind, "spec": _spec_json(spec),
            "batch_num": bsz, "num_classes": cfg.num_classes}
    return _export(SceneChunk(model, cfg, core_ratio), model, (ex, centers, psum, cnt), meta)
