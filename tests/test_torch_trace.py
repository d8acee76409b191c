"""PyTorch port: the program's tracer (``mvkpconv_tpu_torch/tracing.py``).

On a tiny early and a tiny middle fusion configuration, on the CPU:

  * off, the eval step records nothing and its probabilities are bit-equal
    to those of a step with the tracer on;
  * on, the span tree of ``batch_to_device`` → ``make_eval_step``'s step has
    the names and parents of the module's table, one step id a call, each
    child's host interval inside its parent's; the K1 row counters equal
    the pyramid masks' sums; the launch counters' deltas add up, span by
    span, to the counters' totals; the train step has its own spans;
  * under a profiler with the tracer off, the spans are ``mvkp.*`` ranges
    and nothing is recorded;
  * ``split_profile`` on a fixed list of profiler events: each idle
    interval to the innermost range open on the host, the parts adding up
    to the window's idle; launches and kernel time to the launching range;
    and the benchmark's ``portbench.trace.profile_summary`` reads the same
    events the same with or without the program's ranges among them;
  * the serving export's graph is the same with the tracer on or off.
"""

import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mvkpconv_tpu_torch import tracing
from mvkpconv_tpu_torch.data.synthetic_batch import make_batch
from mvkpconv_tpu_torch.infer import batch_to_device, make_model
from mvkpconv_tpu_torch.ops import _build, neighbors
from mvkpconv_tpu_torch.ops.pyramid import build_pyramid
from mvkpconv_tpu_torch.training.config import KPConfig
from mvkpconv_tpu_torch.training.steps import make_eval_step
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

# tests/test_torch_export.py's configuration, two spheres
TINY = dict(
    architecture=("simple", "resnetb", "resnetb_strided", "resnetb", "nearest_upsample", "unary"),
    num_classes=5, first_features_dim=16, first_subsampling_dl=0.1, num_points=(128, 32),
    conv_neighbors=(12, 12), pool_neighbors=(12,), num_views=2, image_height=24,
    image_width=32, batch_num=2, in_features_dim=66, feature_2d_dim=64, pixel_patch_dtype="float32",
)
FUSIONS = ("early", "middle")
ENCODERS = {"early": ("encoder",), "middle": ("encoder_3d", "encoder_2d")}


def tiny(fusion):
    cfg = KPConfig(**TINY, fusion=fusion)
    raw = make_batch(cfg, cfg.batch_num, np.random.RandomState(3))
    raw["mask"][0, 100:] = False  # padded rows, as the spheres have them
    raw["points"][0, 100:] = 1e6
    return cfg, make_model(cfg, "cpu", seed=0), raw


@pytest.fixture(autouse=True)
def tracer_off():
    """Each test starts and ends with the tracer off and no records."""
    tracing.disable()
    tracing.export()
    yield
    tracing.disable()
    tracing.export()


def traced_calls(cfg, model, raw, calls=1):
    step = make_eval_step(model, cfg)
    tracing.enable()
    outs = [step(batch_to_device(raw, "cpu")) for _ in range(calls)]
    tracing.disable()
    return outs, tracing.export()


def children(records, i):
    return [r["name"] for r in records if r["parent"] == i]


@pytest.mark.parametrize("fusion", FUSIONS)
def test_off_records_nothing_and_on_changes_no_bit(fusion):
    cfg, model, raw = tiny(fusion)
    off = make_eval_step(model, cfg)(batch_to_device(raw, "cpu"))
    assert tracing.export() == []
    (on,), records = traced_calls(cfg, model, raw)
    assert records and torch.equal(off, on)


@pytest.mark.parametrize("fusion", FUSIONS)
def test_span_tree_names_parents_steps_and_host_nesting(fusion):
    cfg, model, raw = tiny(fusion)
    _, records = traced_calls(cfg, model, raw, calls=2)
    roots = [i for i, r in enumerate(records) if r["parent"] is None]
    assert [records[i]["name"] for i in roots] == ["handoff", "step"] * 2
    assert len({records[i]["step"] for i in roots}) == 4
    for i, r in enumerate(records):
        if r["parent"] is not None:
            p = records[r["parent"]]
            assert r["step"] == p["step"] and r["depth"] == p["depth"] + 1
            assert p["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] <= p["t1_ns"], (p["name"], r["name"])
    step = roots[1]
    assert children(records, step) == ["pyramid", "model", "softmax"]
    names = {r["name"]: i for i, r in enumerate(records) if r["step"] == records[step]["step"]}
    pyramid = children(records, names["pyramid"])
    assert pyramid == ["pyramid.neighbors", "pyramid.subsample", "pyramid.neighbors", "pyramid.neighbors",
                       "pyramid.neighbors"]
    assert children(records, names["pyramid.subsample"]) == ["sync.subsample"]
    assert children(records, names["model"]) == ["lift", "influence", *ENCODERS[fusion], "decoder", "head"]
    assert children(records, names["lift"]) == ["lift.unproject", "lift.pixel_select", "lift.unet", "lift.gather",
                                                "lift.aggregate"]
    assert set(children(records, names["influence"])) == {"sync.kernel_points"}
    levels = [r["level"] for r in records if r["name"] == "pyramid.neighbors" and r["step"] == records[step]["step"]]
    assert levels == [0, 1, 0, 1]  # conv 0, pool into 1, upsample 0, conv 1: the query level
    assert all(r["device_ms"] is None for r in records)  # no CUDA device here


@pytest.mark.parametrize("fusion", FUSIONS)
def test_k1_row_counters_equal_the_pyramid_masks(fusion):
    cfg, model, raw = tiny(fusion)
    _, records = traced_calls(cfg, model, raw)
    batch = batch_to_device(raw, "cpu")
    masks = build_pyramid(batch["points"], batch["mask"], cfg.pyramid_spec()).masks
    want = []
    for level in range(len(masks)):
        want.append((masks[level].numel(), int(masks[level].sum())))
        if level + 1 < len(masks):
            want += [(masks[level + 1].numel(), int(masks[level + 1].sum())),
                     (masks[level].numel(), int(masks[level].sum()))]
    got = [(r["rows"], r["real_rows"]) for r in records if r["name"] == "pyramid.neighbors"]
    assert got == want
    assert got[0] == (2 * 128, 128 + 100)


def test_every_kernel_launch_is_an_operator_with_a_counter():
    """Each kernel launch of ``ops/_build.py``'s ``SIGNATURES`` (the
    package's one list of kernels) is made by the CUDA kernel of an
    operator ``mvkpconv::<its first counter>``, which also has a CPU kernel
    (the plain version) and a fake kernel; its counters are keys of
    ``tracing.launch_counts()``, whose names the benchmark reads."""
    import importlib
    import pkgutil

    from mvkpconv_tpu_torch.ops import kernels

    for mod in pkgutil.iter_modules(kernels.__path__):
        importlib.import_module(f"{kernels.__name__}.{mod.name}")
    launches = {symbol: counters for symbol, (counters, _) in _build.SIGNATURES.items() if counters}
    for symbol, counters in launches.items():
        name = f"mvkpconv::{next(iter(counters))}"
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(name, key), (symbol, name, key)
    counts = tracing.launch_counts()
    assert set(counts) == {name for counters in launches.values() for name in counters} == {
        "radius_topk", "radius_topk_device", "pixel_topk", "segsum", "segsum_plan", "kpconv_fused_fwd",
        "kpconv_fused_bwd_x", "kpconv_wf", "farthest_point_sample", "ball_query", "three_nn", "unet_conv"}


@pytest.mark.parametrize("fusion", FUSIONS)
def test_launch_deltas_add_up_to_the_counters(fusion, monkeypatch):
    """K1's wrapper counts launches only on the card: here a stand-in counts
    each call as the card's wrapper does (a call, two device launches)."""
    cfg, model, raw = tiny(fusion)
    select = neighbors.radius_topk

    def counted(*args):
        _build.LAUNCHES["radius_topk"] += 1
        _build.LAUNCHES["radius_topk_device"] += 2
        return select(*args)

    monkeypatch.setattr(neighbors, "radius_topk", counted)
    for name in ("radius_topk", "radius_topk_device"):
        monkeypatch.setitem(_build.LAUNCHES, name, _build.LAUNCHES[name])
    before = tracing.launch_counts()
    _, records = traced_calls(cfg, model, raw)
    after = tracing.launch_counts()
    total = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert total == {"radius_topk": 4, "radius_topk_device": 8}
    step = next(r for r in records if r["name"] == "step")
    assert step["launches"] == total
    for i, r in enumerate(records):
        kids = [c for c in records if c["parent"] == i]
        for name in set().union(*(c["launches"] for c in kids)):
            assert sum(c["launches"].get(name, 0) for c in kids) <= r["launches"][name]
    calls = [r["launches"] for r in records if r["name"] == "pyramid.neighbors"]
    assert calls == [{"radius_topk": 1, "radius_topk_device": 2}] * 4
    assert next(r for r in records if r["name"] == "pyramid")["launches"] == total


def test_train_step_spans():
    from mvkpconv_tpu_torch.train import make_trainer

    cfg = KPConfig(**{**TINY, "fusion": "none", "in_features_dim": 2, "feature_2d_dim": 0})
    setup = make_trainer(cfg, "cpu", seed=0)
    batch = batch_to_device(make_batch(cfg, cfg.batch_num, np.random.RandomState(0)), "cpu")
    tracing.enable()
    setup.step(batch)
    tracing.disable()
    records = tracing.export()
    step = next(i for i, r in enumerate(records) if r["name"] == "step")
    assert children(records, step) == ["pyramid", "model", "backward", "optimizer"]
    model = next(i for i, r in enumerate(records) if r["name"] == "model")
    assert children(records, model) == ["influence", "encoder", "decoder", "head"]


def test_profiler_ranges_with_the_tracer_off():
    cfg, model, raw = tiny("early")
    step = make_eval_step(model, cfg)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(batch_to_device(raw, "cpu"))
    assert tracing.export() == []
    names = {e.name for e in prof.events()}
    want = {"handoff", "step", "pyramid", "pyramid.neighbors", "model", "lift", "lift.unet", "softmax"}
    assert {tracing.PREFIX + n for n in want} <= names
    # no device: the whole window is idle, and its parts add up to it
    split = tracing.split_profile(prof.events())
    assert split["steps"] == 1 and split["busy_ms"] == 0.0
    assert sum(split["idle_ms"]["self"].values()) == pytest.approx(split["window_ms"])
    assert split["idle_ms"]["total"]["step"] <= split["window_ms"]


CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def event(name, start, end, device=CPU, annotation=False, id=0):
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation, id=id,
                           time_range=SimpleNamespace(start=float(start), end=float(end)))


# a profiled step (µs): the benchmark's window and step ranges, the
# program's ranges on the host, six launch calls and what answered them
BASE = [
    event("portbench.window", 0, 100, annotation=True), event("portbench.step", 5, 95, annotation=True),
    event("cudaMemcpyAsync", 2, 2.5, id=106), event("Memcpy HtoD (Pageable -> Device)", 3, 4, CUDA, id=106),
    event("cudaLaunchKernel", 8, 9, id=101), event("pyramid_kernel", 10, 20, CUDA, id=101),
    event("cudaLaunchKernel", 33, 33.5, id=102), event("cuLaunchKernel", 33.1, 33.4, id=102),
    event("conv_a", 34, 44, CUDA, id=102),
    event("cudaLaunchKernel", 40, 40.5, id=103), event("conv_b", 46, 56, CUDA, id=103),
    event("cudaLaunchKernelExC", 60, 61, id=104), event("trunk_kernel", 62, 80, CUDA, id=104),
    event("cudaLaunchKernel", 96, 96.5, id=105), event("fill", 97, 99, CUDA, id=105),
    event("cudaStreamSynchronize", 90, 91, id=107),
    event("portbench.step", 5, 95, CUDA, annotation=True),
]
PROGRAM = [
    event("mvkp.step", 6, 94, annotation=True), event("mvkp.pyramid", 7, 30, annotation=True),
    event("mvkp.model", 31, 90, annotation=True), event("mvkp.lift.unet", 32, 50, annotation=True),
    event("mvkp.pyramid", 10, 20, CUDA, annotation=True), event("mvkp.lift.unet", 34, 56, CUDA, annotation=True),
    event("mvkp.model", 62, 80, CUDA, annotation=True),
]


def test_split_profile_puts_idle_launches_and_kernels_down_to_the_innermost_range():
    split = tracing.split_profile(BASE + PROGRAM, 0, 100)
    assert split["window_ms"] == 0.1 and split["busy_ms"] == pytest.approx(0.051) and split["steps"] == 1
    idle = {k: round(v * 1e3, 6) for k, v in split["idle_ms"]["self"].items()}
    assert idle == {"outside": 9, "step": 6, "pyramid": 13, "model": 17, "lift.unet": 4}
    assert sum(idle.values()) == 100 - 51
    assert split["idle_ms"]["total"]["step"] * 1e3 == pytest.approx(40)
    assert split["idle_ms"]["total"]["model"] * 1e3 == pytest.approx(21)
    assert split["launches"]["self"] == {"outside": 2, "pyramid": 1, "lift.unet": 2, "model": 1}
    assert split["launches"]["total"] == {"step": 4, "pyramid": 1, "model": 3, "lift.unet": 2}
    kernel = {k: round(v * 1e3, 6) for k, v in split["kernel_ms"]["self"].items()}
    assert kernel == {"outside": 3, "pyramid": 10, "lift.unet": 20, "model": 18}


def test_the_benchmarks_profile_summary_reads_the_same_with_the_programs_ranges():
    from portbench.trace import profile_summary

    def summary(events):
        return profile_summary(SimpleNamespace(events=lambda: events))

    without, with_ = summary(BASE), summary(BASE + PROGRAM)
    assert with_ == without
    assert without["busy_s"] == pytest.approx(51e-6) and without["window_s"] == pytest.approx(100e-6)
    assert [name for name, _ in without["device_ops"]] == ["trunk_kernel", "pyramid_kernel", "conv_a", "conv_b",
                                                          "fill", "Memcpy HtoD (Pageable -> Device)"]


def test_export_graph_is_the_same_with_the_tracer_on():
    from mvkpconv_tpu_torch.eval.export import export_inference

    cfg, model, _ = tiny("early")

    def graph():
        return str(torch.export.load(io.BytesIO(export_inference(model, cfg))).graph)

    off = graph()
    tracing.enable()
    on = graph()
    tracing.disable()
    assert on == off
    assert tracing.export() == []
