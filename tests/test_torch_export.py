"""PyTorch port: the serving export (``mvkpconv_tpu_torch/eval/export.py``,
``tools/export_model.py``) and the kernels' ``torch.library`` operators.

  * The exported program (``torch.export``, saved and loaded back) gives the
    eager model's probabilities within 1e-6 of the largest, on a batch with
    padded rows, for the KPFCNN and MV-KPConv early, middle and late fusion
    (late fusion's head takes the decoder's output ⊕ the lifted features,
    which the program carries past the trunk); the program calls
    K1 and K2 as the operators ``mvkpconv::radius_topk`` (one a selection of
    the pyramid) and ``mvkpconv::pixel_topk``, and on the fused path K4's
    forward as ``mvkpconv::kpconv_fused_fwd`` (one a conv block):
    nothing of them is decomposed into the plain versions' ops.
  * Against the JAX package's export of the same weights
    (``tests/test_export.py:80``, whose ``export_inference`` takes any
    fusion: the KPFCNN, MV-KPConv middle and late fusion, and early fusion in
    the slow tier, as it exports the UNet a second time on each side), both
    on the default path, the port's program the one held to the eager model
    above: the logits contract of ROADMAP queue 3 in f32 (max |Δ logit| ≤
    1e-4·max |logit| on valid points), read on the log probabilities, which
    differ by at most twice the logits' difference.
  * Each operator's fake kernel gives the shape and dtype of its real one.
  * The whole-scene program, swept by the loader, equals the port's eager
    sweep; ``cover_centers`` and ``pad_centers`` equal the JAX package's.
  * Against the JAX package's whole-scene export of the same weights
    (``lax.scan`` over the chunks; ``tests/test_export.py:151``), on one
    shadow-padded scene and one set of padded centers: the same votes, and
    on the voted points the log of the mean probabilities within twice the
    logits contract (each sphere's log softmax moves by at most twice its
    logits' difference, and so does the log of their mean).
  * The contract surface: the input spec, a wrong input raising, the
    whole-scene export of an MVPNet raising (the sweep is KPConv-only, as in
    the JAX package; ``test_torch_fps_export.py`` holds the MVPNet batch
    export); the CLI with ``--selftest``.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from mvkpconv_tpu.eval import export as jax_export  # noqa: E402
from mvkpconv_tpu.models import KPFCNN as JaxKPFCNN  # noqa: E402
from mvkpconv_tpu.models import MVKPConv as JaxMVKPConv  # noqa: E402
from mvkpconv_tpu.ops.pyramid import build_pyramid as jax_build_pyramid  # noqa: E402
from mvkpconv_tpu.training.config import KPConfig as JaxConfig  # noqa: E402
from mvkpconv_tpu_torch.convert import load_jax_variables  # noqa: E402
from mvkpconv_tpu_torch.eval import export as E  # noqa: E402
from mvkpconv_tpu_torch.infer import FUSED_OPTIONS, infer, make_model  # noqa: E402
from mvkpconv_tpu_torch.models.kpfcnn import KPFCNN  # noqa: E402
from mvkpconv_tpu_torch.models.mvkpconv import MVKPConv  # noqa: E402
from mvkpconv_tpu_torch.ops.kernels import kpconv as k4  # noqa: E402
from mvkpconv_tpu_torch.ops.kernels import pixel_select as k2  # noqa: E402
from mvkpconv_tpu_torch.ops.kernels import radius_topk as k1  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402
from test_torch_slice import random_variables  # noqa: E402

PROB_REL = 1e-6
LOGIT_REL = 1e-4
# tests/test_export.py's configuration
TINY = dict(
    architecture=("simple", "resnetb", "resnetb_strided", "resnetb", "nearest_upsample", "unary"),
    num_classes=5, first_features_dim=16, first_subsampling_dl=0.1, num_points=(128, 32),
    conv_neighbors=(12, 12), pool_neighbors=(12,), num_views=2, image_height=24,
    image_width=32, batch_num=1,
)
FUSION = {"none": dict(fusion="none", in_features_dim=2, feature_2d_dim=0),
          **{f: dict(fusion=f, in_features_dim=66, feature_2d_dim=64, pixel_patch_dtype="float32")
             for f in ("early", "middle", "late")}}


def make_inputs(cfg, kind, seed=0):
    """tests/test_export.py's ``_batch``: numpy, the last 10 rows padded."""
    rng = np.random.RandomState(seed)
    batch = {}
    for k, s in E.batch_spec_for(cfg, kind).items():
        if k == "mask":
            batch[k] = np.ones(s.shape, bool)
            batch[k][:, -10:] = False
        elif k == "poses":
            batch[k] = np.tile(np.eye(4, dtype=np.float32), s.shape[:2] + (1, 1))
        elif k == "intrinsics":
            K = np.zeros(s.shape, np.float32)
            K[..., 0, 0] = K[..., 1, 1] = 20.0
            K[..., 0, 2], K[..., 1, 2], K[..., 2, 2] = cfg.image_width / 2, cfg.image_height / 2, 1.0
            batch[k] = K
        else:
            batch[k] = rng.rand(*s.shape).astype(np.float32)
    batch["points"] = np.where(batch["mask"][..., None], batch["points"], np.float32(1e6))
    return batch


def targets(program):
    return [str(n.target) for n in program.graph.nodes if n.op == "call_function"]


@functools.lru_cache(maxsize=None)
def jax_weights(fusion, **over):
    """(JAX config, JAX model, random variables) of the tiny model."""
    jcfg = JaxConfig(**{**TINY, **over}, **FUSION[fusion])
    jmodel = JaxKPFCNN(jcfg) if fusion == "none" else JaxMVKPConv(jcfg)
    jb = {k: jnp.asarray(v) for k, v in make_inputs(jcfg, E.infer_kind(jcfg)).items()}

    def init():
        pyr = jax_build_pyramid(jb["points"], jb["mask"], jcfg.pyramid_spec())
        return jmodel.init(jax.random.PRNGKey(0), jb["features"] if fusion == "none" else jb, pyr)

    return jcfg, jmodel, random_variables(jax.eval_shape(init))


def port_model(cfg, fusion, **over):
    """The port's model of ``cfg`` holding :func:`jax_weights`' variables."""
    variables = jax.tree.map(np.asarray, jax_weights(fusion, **over)[2])
    return load_jax_variables((KPFCNN if fusion == "none" else MVKPConv)(cfg), variables).eval()


@functools.lru_cache(maxsize=None)
def exported(fusion, fused):
    """(config, model, artifact bytes) of the tiny model, exported once."""
    cfg = KPConfig(**TINY, **FUSION[fusion], **(FUSED_OPTIONS if fused else {}))
    model = port_model(cfg, fusion)
    return cfg, model, E.export_inference(model, cfg)


# the default paths: test_export_meets_the_logits_contract_against_the_jax_export
@pytest.mark.parametrize("fusion, fused", [("none", False), ("early", True), ("middle", False), ("late", False)])
def test_exported_program_equals_the_eager_model(fusion, fused, tmp_path):
    cfg, model, data = exported(fusion, fused)
    kind = E.infer_kind(cfg)
    batch = {k: torch.from_numpy(v) for k, v in make_inputs(cfg, kind).items()}
    served = E.ServingModel.load(E.save_exported(data, tmp_path / "model.pt2"))
    assert served.kind == kind and served.device == torch.device("cpu")
    assert served.input_spec == E.batch_spec_for(cfg, kind)
    got = served(batch)
    want = torch.softmax(infer(model, batch), dim=-1)
    assert got.shape == (1, 128, 5)
    assert float((got - want).abs().max()) <= PROB_REL * float(want.abs().max())
    calls = targets(served.program)
    assert calls.count("mvkpconv.radius_topk.default") == 3 * cfg.num_layers - 2
    assert calls.count("mvkpconv.pixel_topk.default") == (kind == "mvkpconv")
    n_conv = sum(b.startswith(("simple", "resnetb")) for b in cfg.architecture)
    assert calls.count("mvkpconv.kpconv_fused_fwd.default") == (n_conv if fused else 0)
    assert not any("topk" in c and "mvkpconv" not in c for c in calls)  # no plain K1/K2 inside


# early fusion exports the UNet a second time on each side (its artifact
# above is the fused path's); middle and late reuse theirs
@pytest.mark.parametrize("fusion", ["none", pytest.param("early", marks=pytest.mark.slow), "middle", "late"])
def test_export_meets_the_logits_contract_against_the_jax_export(fusion):
    cfg, model, data = exported(fusion, False)
    jcfg, jmodel, variables = jax_weights(fusion)
    kind = E.infer_kind(cfg)
    inputs = make_inputs(cfg, kind)
    jb = {k: jnp.asarray(v) for k, v in inputs.items()}
    want = np.asarray(jax_export.ServingModel.from_bytes(
        jax_export.export_inference(jmodel, jcfg, kind, variables))(jb))
    batch = {k: torch.from_numpy(v) for k, v in inputs.items()}
    served = E.ServingModel.from_bytes(data)
    assert [c for c in targets(served.program) if c.startswith("mvkpconv")] == [
        "mvkpconv.radius_topk.default"] * 4 + ["mvkpconv.pixel_topk.default"] * (kind == "mvkpconv")
    got = served(batch).numpy()
    logits = infer(model, batch).numpy()
    eager = torch.softmax(torch.from_numpy(logits), dim=-1).numpy()
    assert np.abs(got - eager).max() <= PROB_REL * eager.max()
    valid = inputs["mask"]
    gap = np.abs(np.log(got[valid]) - np.log(want[valid])).max()
    assert gap <= 2 * LOGIT_REL * np.abs(logits[valid]).max(), gap


def _fake_vs_real(op, *args):
    real = op(*args)
    with FakeTensorMode(allow_non_fake_inputs=False) as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    assert (tuple(fake.shape), fake.dtype) == (tuple(real.shape), real.dtype)


@pytest.mark.parametrize("op", ["radius_topk", "pixel_topk", "kpconv_fused_fwd"])
def test_fake_kernels_give_the_real_shapes_and_types(op):
    g = torch.Generator().manual_seed(0)
    if op == "radius_topk":
        q, s = torch.rand(2, 40, 3, generator=g), torch.rand(2, 60, 3, generator=g)
        _fake_vs_real(k1.radius_topk_op, q, s, 0.3, 7)
    elif op == "pixel_topk":
        img = torch.rand(2, 3, 8, 9, 3, generator=g)
        iu = torch.randint(0, 6, (2, 3, 20), generator=g, dtype=torch.int32)
        iv = torch.randint(0, 5, (2, 3, 20), generator=g, dtype=torch.int32)
        for dt in (torch.float32, torch.bfloat16):
            _fake_vs_real(k2.pixel_topk_op, torch.rand(2, 20, 3, generator=g), img.to(dt), iu, iv, 3, 4)
    else:
        rel, kp = torch.randn(2, 10, 6, 3, generator=g), torch.randn(15, 3, generator=g)
        w = torch.randn(15 * 8, 16, generator=g)
        for dt in (torch.float32, torch.bfloat16):
            nx = torch.randn(2, 10, 6, 8, generator=g).to(dt)
            _fake_vs_real(k4.kpconv_fused_fwd_op, rel, nx, kp, w, 0.5)


SCENE = dict(batch_num=2, in_radius=1.0)


@functools.lru_cache(maxsize=None)
def whole_scene():
    """(config, model, numpy scene of 700 points shadow-padded to 800 with
    18 cover centers padded to 20, the loaded whole-scene artifact)."""
    cfg = KPConfig(**{**TINY, **SCENE}, **FUSION["none"])
    rng = np.random.RandomState(2)
    pts = (rng.rand(700, 3) * [2.0, 2.0, 1.0]).astype(np.float32)
    cover = E.cover_centers(pts, cfg.in_radius)
    np.testing.assert_array_equal(cover, jax_export.cover_centers(pts, cfg.in_radius))
    assert len(cover) == 18  # two centers repeated
    scene = {"points": np.concatenate([pts, np.full((100, 3), 1e6, np.float32)]),
             "mask": np.arange(800) < 700,
             "features": rng.rand(800, 2).astype(np.float32),
             "centers": E.pad_centers(cover, 20)}
    model = port_model(cfg, "none", **SCENE)
    served = E.ServingModel.from_bytes(E.export_whole_scene(model, cfg, None, 800, 20))
    return cfg, model, scene, served


def test_whole_scene_program_equals_the_eager_sweep():
    cfg, model, scene, served = whole_scene()
    assert served.input_spec == E.scene_spec_for(cfg, 800, 20)
    tscene = {k: torch.from_numpy(v) for k, v in scene.items()}
    got = served(tscene)
    with torch.no_grad():
        want = E.sweep(E.SceneChunk(model, cfg), tscene, cfg.batch_num, cfg.num_classes)
    assert torch.equal(got["votes"], want["votes"]) and torch.equal(got["probs"], want["probs"])
    voted = got["votes"] > 0
    assert float(voted[:700].float().mean()) > 0.99 and not bool(voted[700:].any())
    np.testing.assert_allclose(got["probs"][voted].sum(-1).numpy(), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="multiple"):
        E.export_whole_scene(model, cfg, None, 800, 19)


def test_whole_scene_program_meets_the_logits_contract_against_the_jax_export():
    cfg, model, scene, served = whole_scene()
    jcfg, jmodel, variables = jax_weights("none", **SCENE)
    want = jax_export.ServingModel.from_bytes(jax_export.export_whole_scene(
        jmodel, jcfg, "kpfcnn", variables, 800, 20))({k: jnp.asarray(v) for k, v in scene.items()})
    tscene = {k: torch.from_numpy(v) for k, v in scene.items()}
    got = served(tscene)
    top = []
    hook = model.register_forward_hook(lambda m, a, out: top.append(float(out.abs().max())))
    with torch.no_grad():
        E.sweep(E.SceneChunk(model, cfg), tscene, cfg.batch_num, cfg.num_classes)
    hook.remove()
    votes = got["votes"].numpy()
    np.testing.assert_array_equal(votes, np.asarray(want["votes"]))
    voted = votes > 0
    gap = np.abs(np.log(got["probs"].numpy()[voted]) - np.log(np.asarray(want["probs"])[voted])).max()
    assert gap <= 2 * LOGIT_REL * max(top), (gap, max(top))


def test_pad_centers_matches_jax():
    centers = np.random.RandomState(1).rand(5, 3).astype(np.float32)
    for n in (5, 6, 10, 13):
        got = E.pad_centers(centers, n)
        np.testing.assert_array_equal(got, jax_export.pad_centers(centers, n))
        assert len(got) == n and set(map(tuple, got)) == set(map(tuple, centers))
    for fn in (E.pad_centers, jax_export.pad_centers):
        with pytest.raises(ValueError, match="budget"):
            fn(centers, 4)


def test_contract_surface():
    cfg, _model, data = exported("none", False)
    with pytest.raises(ValueError, match="no default batch spec"):
        E.batch_spec_for(cfg, "pn2")
    # the whole-scene sweep stays KPConv-only, as the JAX package's
    with pytest.raises(NotImplementedError, match="whole-scene export of kind 'mvpnet'"):
        E.export_whole_scene(torch.nn.Linear(1, 1), cfg, "mvpnet", 128, 1)
    served = E.ServingModel.from_bytes(data)
    batch = {k: torch.from_numpy(v) for k, v in make_inputs(cfg, "kpfcnn").items()}
    with pytest.raises(ValueError, match="points"):
        served({**batch, "points": batch["points"][:, :64]})
    with pytest.raises(ValueError, match="keys"):
        served({k: v for k, v in batch.items() if k != "features"})


def test_export_model_cli(tmp_path, capsys):
    from mvkpconv_tpu_torch.tools import export_model

    KPConfig(**TINY, **FUSION["none"]).save(tmp_path / "parameters.txt")
    path, seconds, size = export_model.main([
        "--config", str(tmp_path / "parameters.txt"), "--artifact", str(tmp_path / "m.pt2"),
        "--selftest", "--device", "cpu"])
    assert path.stat().st_size == size > 0 and seconds > 0
    assert "selftest OK" in capsys.readouterr().out
