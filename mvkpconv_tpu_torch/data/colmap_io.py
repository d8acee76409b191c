"""COLMAP reconstruction IO + custom laser-scan dataset assembly: a copy of
``mvkpconv_tpu/data/colmap_io.py`` (``tests/test_torch_io.py`` pins it to
the original and holds every array equal).

Replaces the parts of the reference's vendored COLMAP tooling that are on
the import path of the main code (SURVEY.md §2.4):
  * colmap/python/read_write_model.py — ``read_cameras_binary``,
    ``read_images_binary``, ``qvec2rotmat`` (binary format is the public
    COLMAP spec);
  * colmap/python/read_write_dense.py — ``read_array`` for
    ``*.geometric.bin`` depth maps;
  * KPConv-PyTorch/datasets/Colmap_sphere_color.py:325-440 — assembling a
    scene dict from a laser scan + COLMAP cameras/poses/depths + the
    alignment matrix (``matrix_for_images.txt``).

The assembled scene dict plugs straight into SphereDataset, so MV-KPConv
inference on custom data is the same voting path as ScanNet
(tools/test_colmap.py ↔ reference test_models_colmap.py).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

# model_id → (name, num_params) from the COLMAP camera model spec
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    def intrinsic_matrix(self) -> np.ndarray:
        """(3,3) K for pinhole-like models (distortion ignored, like the
        reference which only reads fx/fy/cx/cy, Colmap_sphere_color.py:352)."""
        p = self.params
        if self.model == "SIMPLE_PINHOLE" or self.model in (
            "SIMPLE_RADIAL", "RADIAL", "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE",
        ):
            fx = fy = p[0]
            cx, cy = p[1], p[2]
        else:  # PINHOLE / OPENCV family: fx fy cx cy ...
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str

    def world_to_cam(self) -> np.ndarray:
        R = qvec2rotmat(self.qvec)
        M = np.eye(4, dtype=np.float32)
        M[:3, :3] = R
        M[:3, 3] = self.tvec
        return M

    def cam_to_world(self) -> np.ndarray:
        M = self.world_to_cam()
        out = np.eye(4, dtype=np.float32)
        out[:3, :3] = M[:3, :3].T
        out[:3, 3] = -M[:3, :3].T @ M[:3, 3]
        return out


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    """Quaternion (w,x,y,z) → rotation matrix (read_write_model.py)."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * w * x],
            [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x**2 - 2 * y**2],
        ],
        np.float32,
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → quaternion (w,x,y,z)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array(
        [
            [Rxx - Ryy - Rzz, 0, 0, 0],
            [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
            [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
            [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
        ]
    ) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def read_cameras_binary(path) -> Dict[int, Camera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cam_id, model_id = struct.unpack("<ii", f.read(8))
            width, height = struct.unpack("<QQ", f.read(16))
            name, num_params = CAMERA_MODELS[model_id]
            params = np.frombuffer(f.read(8 * num_params), "<f8")
            out[cam_id] = Camera(cam_id, name, width, height, params)
    return out


def read_images_binary(path) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            (image_id,) = struct.unpack("<i", f.read(4))
            qvec = np.frombuffer(f.read(32), "<f8").copy()
            tvec = np.frombuffer(f.read(24), "<f8").copy()
            (camera_id,) = struct.unpack("<i", f.read(4))
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_pts,) = struct.unpack("<Q", f.read(8))
            f.read(24 * num_pts)  # skip 2D points (x f8, y f8, id i8)
            out[image_id] = ColmapImage(
                image_id, qvec, tvec, camera_id, name.decode("utf-8")
            )
    return out


def write_cameras_binary(cameras: Dict[int, Camera], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        inv = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
        for cam in cameras.values():
            f.write(struct.pack("<ii", cam.id, inv[cam.model]))
            f.write(struct.pack("<QQ", cam.width, cam.height))
            f.write(np.asarray(cam.params, "<f8").tobytes())


def write_images_binary(images: Dict[int, ColmapImage], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(np.asarray(im.qvec, "<f8").tobytes())
            f.write(np.asarray(im.tvec, "<f8").tobytes())
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))


def read_array(path) -> np.ndarray:
    """Read a COLMAP dense map (``*.geometric.bin``): text header
    ``width&height&channels&`` then little-endian float32, column-major in
    (width, height, channels) order (read_write_dense.py)."""
    data = Path(path).read_bytes()
    pos, dims = 0, []
    for _ in range(3):
        amp = data.index(b"&", pos)
        dims.append(int(data[pos:amp]))
        pos = amp + 1
    width, height, channels = dims
    arr = np.frombuffer(data, "<f4", offset=pos, count=width * height * channels)
    arr = arr.reshape((width, height, channels), order="F")
    return np.transpose(arr, (1, 0, 2)).squeeze()


def write_array(arr: np.ndarray, path) -> None:
    arr = np.asarray(arr, "<f4")
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    col_major = np.transpose(arr, (1, 0, 2))  # (w, h, c)
    with open(path, "wb") as f:
        f.write(f"{w}&{h}&{c}&".encode("ascii"))
        f.write(np.asfortranarray(col_major).tobytes(order="F"))


def load_colmap_scene(
    sparse_dir,
    depth_dir,
    laser_ply,
    alignment_txt: Optional[str] = None,
    resize_hw: Optional[Tuple[int, int]] = (120, 160),
    image_dir: Optional[str] = None,
    max_frames: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Assemble a SphereDataset-compatible scene from a COLMAP workspace.

    Mirrors Colmap_sphere_color.py:325-440: intrinsics from cameras.bin,
    cam-to-world poses from images.bin (qvec2rotmat + tvec), depth from
    ``{name}.geometric.bin``, laser points from the scan ply, and an
    optional 4×4 alignment matrix mapping camera space into laser space.
    """
    from mvkpconv_tpu_torch.utils.ply import read_ply

    sparse_dir = Path(sparse_dir)
    cameras = read_cameras_binary(sparse_dir / "cameras.bin")
    images = read_images_binary(sparse_dir / "images.bin")
    align = (
        np.loadtxt(alignment_txt).astype(np.float32)
        if alignment_txt
        else np.eye(4, dtype=np.float32)
    )

    mesh = read_ply(laser_ply)
    points = np.stack([mesh["x"], mesh["y"], mesh["z"]], 1).astype(np.float32)
    colors = (
        np.stack([mesh["red"], mesh["green"], mesh["blue"]], 1).astype(np.float32) / 255.0
        if "red" in mesh
        else np.zeros_like(points)
    )
    scene = {
        "points": points,
        "colors": colors,
        "labels": np.full(len(points), -1, np.int32),
    }

    depth_dir = Path(depth_dir)
    rgbs, depths, poses, Ks = [], [], [], []
    for im in list(images.values())[: max_frames or None]:
        dpath = depth_dir / f"{im.name}.geometric.bin"
        if not dpath.exists():
            continue
        depth = read_array(dpath)
        cam = cameras[im.camera_id]
        K = cam.intrinsic_matrix().copy()
        if resize_hw is not None:
            h, w = resize_hw
            sy, sx = h / depth.shape[0], w / depth.shape[1]
            idx_y = (np.arange(h) / sy).astype(int).clip(0, depth.shape[0] - 1)
            idx_x = (np.arange(w) / sx).astype(int).clip(0, depth.shape[1] - 1)
            depth = depth[idx_y][:, idx_x]
            K[0] *= sx
            K[1] *= sy
        pose = align @ im.cam_to_world()
        if image_dir is not None:
            try:
                from PIL import Image
            except ImportError as err:
                raise ImportError("image_dir: reading the images needs PIL (Pillow)") from err

            img = Image.open(Path(image_dir) / im.name)
            if resize_hw is not None:
                img = img.resize((resize_hw[1], resize_hw[0]), Image.BILINEAR)
            rgbs.append(np.asarray(img, np.float32)[..., :3] / 255.0)
        else:
            rgbs.append(np.zeros((*depth.shape, 3), np.float32))
        depths.append(depth.astype(np.float32))
        poses.append(pose)
        Ks.append(K.astype(np.float32))
    if depths:
        scene.update(
            rgb=np.stack(rgbs),
            depth=np.stack(depths),
            poses=np.stack(poses),
            intrinsics=np.stack(Ks),
        )
    return scene
