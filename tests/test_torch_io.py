"""PyTorch port: the data IO of custom-dataset inference and preprocessing
against the JAX package's numpy originals, on the JAX tests' fabricated
files (``tests/test_io.py``, ``tests/test_colmap.py``).

  * PLY (``utils/ply.py``): ``read_ply`` of binary and ASCII files, equal
    arrays; the module a copy of the original's;
  * COLMAP (``data/colmap_io.py``): files written by one package read by
    the other, the writers' bytes equal, ``qvec2rotmat`` / ``rotmat2qvec``
    equal, ``load_colmap_scene`` on a fabricated workspace (20k points, 3
    views of 24×32 at 48×64, so that the nearest-index resize runs) with and
    without a non-identity alignment, with ``max_frames`` and with images
    read through PIL: every array equal, dtypes included;
  * ScanNet (``data/scannet_io.py``): the label LUTs, ``load_scene``,
    ``preprocess_split``'s pickle, ``compute_label_weights``, ``SensReader``
    on a fabricated v4 ``.sens``, ``load_frames`` with a TSV, with excluded
    frames and with corrupt frames skipped: equal.

Equality is exact throughout: both packages run the same numpy.
"""

import pickle
import struct
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")

from mvkpconv_tpu.data import colmap_io as jax_cio  # noqa: E402
from mvkpconv_tpu.data import scannet_io as jax_sio  # noqa: E402
from mvkpconv_tpu.data import synthetic as jax_synthetic  # noqa: E402
from mvkpconv_tpu.utils import ply as jax_ply  # noqa: E402
from mvkpconv_tpu_torch.data import colmap_io as cio  # noqa: E402
from mvkpconv_tpu_torch.data import scannet_io as sio  # noqa: E402
from mvkpconv_tpu_torch.utils import ply  # noqa: E402
from test_torch_data import assert_same  # noqa: E402

PIL = pytest.importorskip("PIL.Image")


def same_module_body(port_module, jax_module):
    """The port's copy equals the original below the module docstring, with
    the package's name in its imports."""
    def body(mod):
        src = open(mod.__file__).read()
        return src[src.index('"""', 3) + 3:]
    return body(port_module) == body(jax_module).replace("mvkpconv_tpu.", "mvkpconv_tpu_torch.")


# ---------------------------------------------------------------- PLY

def test_read_ply_binary_and_ascii_match_jax(tmp_path, rng):
    assert same_module_body(ply, jax_ply)
    pts = rng.rand(100, 3).astype(np.float32)
    cols = (rng.rand(100, 3) * 255).astype(np.uint8)
    labels = rng.randint(0, 40, 100).astype(np.int32)
    p = tmp_path / "cloud.ply"
    ply.write_ply(p, [pts, cols, labels], ["x", "y", "z", "red", "green", "blue", "label"])
    jax_ply.write_ply(tmp_path / "jax.ply", [pts, cols, labels], ["x", "y", "z", "red", "green", "blue", "label"])
    assert p.read_bytes() == (tmp_path / "jax.ply").read_bytes()
    assert_same(ply.read_ply(p), jax_ply.read_ply(p), "binary")
    a = tmp_path / "ascii.ply"
    a.write_text("ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\nproperty uchar red\n"
                 "property int label\nend_header\n0.5 1 2\n3 4 -5\n")
    got = ply.read_ply(a)
    assert_same(got, jax_ply.read_ply(a), "ascii")
    assert got["label"].tolist() == [2, -5] and got["red"].dtype == np.uint8


# ---------------------------------------------------------------- COLMAP

def test_colmap_binaries_cross_read_and_writers_match(tmp_path, rng):
    q = np.array([0.9, 0.1, 0.2, 0.3])
    q /= np.linalg.norm(q)
    for pkg, jpkg, side in ((cio, jax_cio, "port"), (jax_cio, cio, "jax")):
        d = tmp_path / side
        d.mkdir()
        cams = {1: pkg.Camera(1, "PINHOLE", 640, 480, np.array([500.0, 510.0, 320.0, 240.0])),
                2: pkg.Camera(2, "SIMPLE_RADIAL", 320, 240, np.array([250.0, 160.0, 120.0, 0.01]))}
        ims = {7: pkg.ColmapImage(7, q, np.array([1.0, 2.0, 3.0]), 1, "frame_0001.jpg"),
               9: pkg.ColmapImage(9, -q[[1, 0, 3, 2]], np.array([-1.0, 0.5, 2.0]), 2, "b.png")}
        pkg.write_cameras_binary(cams, d / "cameras.bin")
        pkg.write_images_binary(ims, d / "images.bin")
        depth = rng.rand(48, 64, 2).astype(np.float32)
        pkg.write_array(depth, d / "d.geometric.bin")
        # the other package reads what this one wrote
        got_c, got_i = jpkg.read_cameras_binary(d / "cameras.bin"), jpkg.read_images_binary(d / "images.bin")
        for k, cam in cams.items():
            assert (got_c[k].model, got_c[k].width, got_c[k].height) == (cam.model, cam.width, cam.height)
            np.testing.assert_array_equal(got_c[k].params, cam.params)
            assert_same(got_c[k].intrinsic_matrix(), cam.intrinsic_matrix(), f"K {k}")
        for k, im in ims.items():
            assert (got_i[k].name, got_i[k].camera_id) == (im.name, im.camera_id)
            assert_same(got_i[k].world_to_cam(), im.world_to_cam(), f"w2c {k}")
            assert_same(got_i[k].cam_to_world(), im.cam_to_world(), f"c2w {k}")
        assert_same(jpkg.read_array(d / "d.geometric.bin"), depth, "dense map")
    # the same inputs give the same bytes (the dense maps are random each)
    for name in ("cameras.bin", "images.bin"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


def test_quaternion_conversions_match_jax(rng):
    for _ in range(8):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        R = cio.qvec2rotmat(q)
        assert R.dtype == np.float32
        assert_same(R, jax_cio.qvec2rotmat(q), "qvec2rotmat")
        assert_same(cio.rotmat2qvec(R), jax_cio.rotmat2qvec(R), "rotmat2qvec")


def make_workspace(root, pkg=jax_cio, rng=None, num_points=20000, views=3, render_hw=(48, 64)):
    """A COLMAP workspace from a synthetic room (``tests/test_colmap.py``'s,
    with depth maps rendered at ``render_hw``): ``sparse/cameras.bin``
    (PINHOLE), ``sparse/images.bin`` (world-to-camera quaternions), the
    depth maps as ``*.geometric.bin``, ``laser.ply`` and, with ``rng``, a
    PNG per image. Returns (sparse, depths, laser, images, views)."""
    scene = jax_synthetic.make_scene(seed=7, num_points=num_points)
    rendered = jax_synthetic.render_views(scene, num_views=views, h=render_hw[0], w=render_hw[1], seed=7)
    sparse, depths, images = root / "sparse", root / "depths", root / "images"
    for d in (sparse, depths, images):
        d.mkdir(parents=True, exist_ok=True)
    K = rendered["intrinsics"][0]
    cams = {1: pkg.Camera(1, "PINHOLE", render_hw[1], render_hw[0],
                          np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float64))}
    pkg.write_cameras_binary(cams, sparse / "cameras.bin")
    ims = {}
    for v in range(views):
        c2w = rendered["poses"][v]
        w2c_R = c2w[:3, :3].T
        ims[v + 1] = pkg.ColmapImage(v + 1, pkg.rotmat2qvec(w2c_R), -w2c_R @ c2w[:3, 3], 1, f"img_{v}.png")
        pkg.write_array(rendered["depth"][v], depths / f"img_{v}.png.geometric.bin")
        if rng is not None:
            PIL.fromarray((rng.rand(*render_hw, 3) * 255).astype(np.uint8)).save(images / f"img_{v}.png")
    pkg.write_images_binary(ims, sparse / "images.bin")
    laser = root / "laser.ply"
    jax_ply.write_ply(laser, [scene["points"], (scene["colors"] * 255).astype(np.uint8)],
                      ["x", "y", "z", "red", "green", "blue"])
    return sparse, depths, laser, images, rendered


def test_load_colmap_scene_matches_jax(tmp_path, rng):
    sparse, depths, laser, images, rendered = make_workspace(tmp_path, rng=rng)
    align = tmp_path / "matrix_for_images.txt"
    M = np.eye(4)
    c, s = np.cos(0.3), np.sin(0.3)
    M[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    M[:3, 3] = [0.5, -1.25, 0.1]
    np.savetxt(align, M)
    cases = {
        "identity": dict(resize_hw=(24, 32)),
        "aligned": dict(alignment_txt=str(align), resize_hw=(24, 32)),
        "max_frames": dict(alignment_txt=str(align), resize_hw=(24, 32), max_frames=2),
        "images": dict(resize_hw=(24, 32), image_dir=str(images)),
        "no_resize": dict(resize_hw=None),
    }
    for name, kw in cases.items():
        got = cio.load_colmap_scene(sparse, depths, laser, **kw)
        want = jax_cio.load_colmap_scene(sparse, depths, laser, **kw)
        assert_same(got, want, name)
        assert (got["labels"] == -1).all() and len(got["points"]) == len(ply.read_ply(laser)["x"])
    assert got["depth"].shape == (3, 48, 64)
    aligned = cio.load_colmap_scene(sparse, depths, laser, alignment_txt=str(align), resize_hw=(24, 32))
    assert aligned["poses"].dtype == np.float32 and aligned["depth"].shape == (3, 24, 32)
    # the pose is align @ cam_to_world in float32; the intrinsics scaled by
    # the resize, with no half-pixel offset
    np.testing.assert_allclose(aligned["poses"][0], M.astype(np.float32) @ rendered["poses"][0], atol=1e-4)
    np.testing.assert_allclose(aligned["intrinsics"][0][:2], rendered["intrinsics"][0][:2] / 2, rtol=1e-6)
    assert len(cio.load_colmap_scene(sparse, depths, laser, max_frames=2)["depth"]) == 2


# ---------------------------------------------------------------- ScanNet

def write_scan(root, rng, scan_id="scene0000_00", n=50):
    scan = root / scan_id
    scan.mkdir(parents=True)
    pts = rng.rand(n, 3).astype(np.float32)
    cols = (rng.rand(n, 3) * 255).astype(np.uint8)
    ply.write_ply(scan / f"{scan_id}_vh_clean_2.ply", [pts, cols], ["x", "y", "z", "red", "green", "blue"])
    nyu = rng.choice([1, 2, 5, 39, 40, 0, 41], n).astype(np.uint16)  # 40/0 unmapped, 41 a bad id
    ply.write_ply(scan / f"{scan_id}_vh_clean_2.labels.ply", [pts, nyu], ["x", "y", "z", "label"])
    return scan


def test_label_luts_scenes_split_and_weights_match_jax(tmp_path, rng):
    assert_same(sio.nyu40_to_train_ids(), jax_sio.nyu40_to_train_ids(), "nyu40 lut")
    tsv = tmp_path / "labels.tsv"
    tsv.write_text("id\traw_category\tcategory\tnyu40id\n1\twall\twall\t1\n22\tlamp\tlamp\t35\n"
                   "7\tchair\tchair\t5\n1163\tobject\tobject\t40\n50\tx\tx\t77\nbad\tx\tx\ty\n")
    mapping = sio.parse_label_mapping_tsv(tsv)
    assert mapping == jax_sio.parse_label_mapping_tsv(tsv) == {1: 1, 22: 35, 7: 5, 1163: 40, 50: 77}
    assert_same(sio.compose_raw_to_train_lut(mapping), jax_sio.compose_raw_to_train_lut(mapping), "raw lut")
    write_scan(tmp_path, rng)
    write_scan(tmp_path, rng, "scene0001_00", 70)
    (tmp_path / "scene0002_00").mkdir()
    ply.write_ply(tmp_path / "scene0002_00" / "scene0002_00_vh_clean_2.ply",
                  [rng.rand(9, 3).astype(np.float32), np.zeros((9, 3), np.uint8)],
                  ["x", "y", "z", "red", "green", "blue"])  # no labels file
    ids = ["scene0000_00", "scene0001_00", "scene0002_00"]
    for sid in ids:
        assert_same(sio.load_scene(tmp_path / sid, sid), jax_sio.load_scene(tmp_path / sid, sid), sid)
    lut = sio.compose_raw_to_train_lut(mapping)
    assert_same(sio.load_scene(tmp_path / ids[0], ids[0], lut), jax_sio.load_scene(tmp_path / ids[0], ids[0], lut))
    got = sio.preprocess_split(tmp_path, ids, tmp_path / "port.pkl")
    want = jax_sio.preprocess_split(tmp_path, ids, tmp_path / "jax.pkl")
    assert_same(got, want, "split")
    assert_same(sio.load_split(tmp_path / "port.pkl"), pickle.loads((tmp_path / "jax.pkl").read_bytes()), "pickle")
    assert_same(sio.compute_label_weights(got), jax_sio.compute_label_weights(want), "weights")
    small = [{"labels": np.array([0, 0, 0, 1, -1])}]
    assert_same(sio.compute_label_weights(small, num_classes=3), jax_sio.compute_label_weights(small, num_classes=3))


def test_sens_reader_matches_jax(tmp_path, rng):
    """``tests/test_io.py``'s v4 ``.sens`` stream, with two frames."""
    depths = [(rng.rand(8, 10) * 3000).astype("<u2") for _ in range(2)]
    poses = [np.eye(4, dtype="<f4"), rng.rand(4, 4).astype("<f4")]
    colors = [b"\xff\xd8fakejpeg", b"\xff\xd8other"]
    buf = struct.pack("<I", 4) + struct.pack("<Q", 15) + b"StructureSensor"
    for _ in range(4):
        buf += rng.rand(4, 4).astype("<f4").tobytes()
    buf += struct.pack("<i", 2) + struct.pack("<i", 1) + struct.pack("<IIII", 320, 240, 10, 8)
    buf += struct.pack("<f", 1000.0) + struct.pack("<Q", 2)
    for d, p, c in zip(depths, poses, colors):
        comp = zlib.compress(d.tobytes())
        buf += p.tobytes() + struct.pack("<QQ", 0, 0) + struct.pack("<QQ", len(c), len(comp)) + c + comp
    path = tmp_path / "scan.sens"
    path.write_bytes(buf)
    got, want = sio.SensReader(path), jax_sio.SensReader(path)
    for attr in ("version", "sensor_name", "color_compression", "depth_compression", "color_width",
                 "color_height", "depth_width", "depth_height", "depth_shift", "num_frames"):
        assert getattr(got, attr) == getattr(want, attr), attr
    for attr in ("intrinsic_color", "extrinsic_color", "intrinsic_depth", "extrinsic_depth"):
        assert_same(getattr(got, attr), getattr(want, attr), attr)
    frames, jframes = list(got.frames()), list(want.frames())
    got.close(), want.close()
    assert len(frames) == 2
    for (p, c, d), (jp, jc, jd) in zip(frames, jframes):
        assert c == jc
        assert_same(p, jp, "pose"), assert_same(d, jd, "depth")
    assert frames[1][1] == colors[1]


def write_frames(root, fids, h=8, w=10, bad=()):
    for sub in ("color", "depth", "pose", "intrinsic"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    np.savetxt(root / "intrinsic" / "intrinsic_depth.txt", np.diag([20.0, 22.0, 1.0, 1.0]))
    for i, fid in enumerate(fids):
        rgb = (np.arange(h * w * 3).reshape(h, w, 3) * (i + 1) % 255).astype(np.uint8)
        if ("color", fid) in bad:
            (root / "color" / f"{fid}.jpg").write_bytes(b"\xff\xd8broken")
        else:
            PIL.fromarray(rgb).save(root / "color" / f"{fid}.jpg")
        depth = np.full((h, w), 1000 + 10 * i, np.uint16)
        depth[0, : i + 1] = 2500
        if ("depth", fid) in bad:
            depth[:] = 0
        PIL.fromarray(depth).save(root / "depth" / f"{fid}.png")
        pose = np.eye(4)
        pose[:3, 3] = [i, 0.5, -i]
        if ("pose", fid) in bad:
            pose[0, 0] = np.inf
        np.savetxt(root / "pose" / f"{fid}.txt", pose)


def test_load_frames_matches_jax(tmp_path):
    """Resized with a raw-id label TSV; excluded frames (by list and by the
    built-in blacklist); corrupt frames skipped; nothing left raises in
    both."""
    frames = tmp_path / "frames"
    fids = [0, 1, 2, 3, 4, 1175]
    write_frames(frames, fids, bad={("color", 1), ("depth", 2), ("pose", 3)})
    labels = tmp_path / "label"
    labels.mkdir()
    for fid in fids:
        raw = np.zeros((8, 10), np.uint16)
        raw[0], raw[1], raw[2] = 1, 1163, 7
        PIL.fromarray(raw).save(labels / f"{fid}.png")
    tsv = tmp_path / "labels.tsv"
    tsv.write_text("id\traw_category\tcategory\tnyu40id\n1\twall\twall\t1\n7\tchair\tchair\t5\n"
                   "1163\tobject\tobject\t40\n")
    cases = {
        "tsv_resized": dict(frame_ids=[0, 4], resize_hw=(4, 5), label_dir=labels, label_mapping_tsv=tsv),
        "tsv": dict(frame_ids=[0, 4], resize_hw=None, label_dir=labels, label_mapping_tsv=tsv),
        "excluded": dict(frame_ids=fids, resize_hw=(4, 6), exclude=[4]),
        "blacklist": dict(frame_ids=[0, 4, 1175], resize_hw=None, scan_id="scene0243_00"),
    }
    for name, kw in cases.items():
        got = sio.load_frames(frames, **kw)
        assert_same(got, jax_sio.load_frames(frames, **kw), name)
    assert got["frame_ids"].tolist() == [0, 4]
    assert sio.load_frames(frames, **cases["excluded"])["frame_ids"].tolist() == [0, 1175]
    for pkg in (sio, jax_sio):
        with pytest.raises(ValueError, match="no usable frames"):
            pkg.load_frames(frames, [1, 2, 3], resize_hw=None)
        with pytest.raises(ValueError, match="raw"):  # raw ids without the TSV
            pkg.load_frames(frames, [0], resize_hw=None, label_dir=labels)
