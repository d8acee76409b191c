"""A configuration's reference, found by its ``reference`` key: the cells'
weights, calibration, counts and check through ``portbench.reference`` equal
the direct calls bit for bit; a toy reference (``toy_reference.py``) is
reached through a configuration dict alone, with nothing patched; a
reference outside ``portbench.`` is refused. And the traced run's pass over
the pool with the program's own tracer, which is off again after it."""

import math
import time

import numpy as np
import pytest
import torch

from portbench import check, counting, harness, readers
from portbench.reference.model import Reference, float32_exact, tensors
from portbench.tests import toy_reference
from portbench.tests.tiny import tiny_cell
from portbench.traffic.generator import Pool, make_pool
from portbench.weights import _scale, calibrate, draw

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
TF32_OFF = {"matmul": False, "cudnn": False}
TOY = {"name": "toy", "reference": "portbench.tests.toy_reference",
       "model": {"in_dim": 5, "hidden": 8, "num_classes": 3}}


def direct_draw(model, seed):
    """The draw written against the MV-KPConv reference's ``tensors``."""
    entries = tensors(model)
    sizes = [math.prod(shape) for _, shape, _ in entries]
    gen = torch.Generator()
    gen.manual_seed(seed)
    out = {}
    for (name, shape, kind), part in zip(entries, torch.split(torch.randn(sum(sizes), generator=gen), sizes)):
        out[name] = {"running_mean": torch.zeros(shape), "running_var": torch.ones(shape),
                     "bn_weight": 1.0 + 0.1 * part.reshape(shape)}.get(kind, _scale(shape, kind) * part.reshape(shape))
    return out


def probabilities(batches, classes, seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return [torch.softmax(torch.randn(*b["mask"].shape, classes, generator=gen), -1) for b in batches]


def equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name", CELLS)
def test_the_cells_reach_the_mvkpconv_reference_unchanged(name):
    cell = tiny_cell(name)
    model, raw = cell.model, cell.conf["model"]
    pool = make_pool(model, cell.mix, 7)
    batches = [harness.to_device(b, "cpu") for b in pool.batches[:2]]
    got, want = draw(model, 2**31 + 5, "cpu"), direct_draw(raw, 2**31 + 5)
    assert equal(got, want)
    calibrate(model, got, batches[0])
    with torch.no_grad(), float32_exact():
        Reference(raw, want, "calibrate")(batches[0])
    assert equal(got, want)
    order = [0, 1, 2, 1]
    with harness.precision(TF32_OFF):
        counted = harness._counts(model, pool, order, False, "cpu")["peak_seconds"]
    assert counted == float(sum(counting.step_seconds_at_peak(
        raw, counting.pyramid_stats(harness.to_device(pool.batches[j], "cpu"), raw), False, TF32_OFF) for j in order))
    outputs = probabilities(batches, raw["num_classes"], 1)
    worst = 0.0
    for batch, probs in zip(batches, outputs):
        with torch.no_grad(), float32_exact():
            logits, _, lengths = Reference(raw, want, "eval")(batch)
        ref = check.centred_log(torch.softmax(logits, dim=-1))
        port = check.centred_log(torch.cat([probs[i, :n] for i, n in enumerate(lengths)]))
        worst = max(worst, float((port - ref).norm() / ref.norm()))
    assert check.compare_infer(model, got, batches, outputs) == {"logits_err": worst}


def toy_pool(seed):
    rng = np.random.RandomState(seed)
    batches = []
    for _ in range(3):
        mask = np.arange(16)[None, :] < rng.randint(4, 17, size=(2, 1))
        batches.append({"features": rng.randn(2, 16, 5).astype(np.float32), "mask": mask})
    return Pool(batches, [int(b["mask"].sum()) for b in batches])


def test_a_configuration_reaches_its_own_reference():
    cell = harness.Cell("toy.infer", TOY, {})
    assert cell.reference is toy_reference
    model, pool = cell.model, toy_pool(0)
    batches = [harness.to_device(b, "cpu") for b in pool.batches]
    weights = draw(model, 3, "cpu")
    assert [(k, tuple(v.shape)) for k, v in weights.items()] == [(n, s) for n, s, _ in toy_reference.tensors(model)]
    calibrate(model, weights, batches[0])
    h, _ = toy_reference.hidden(weights, batches[0])
    assert torch.equal(weights["bn.running_mean"], h.mean(0)) and weights["bn.running_var"].min() > 0
    with harness.precision(TF32_OFF):
        counted = harness._counts(model, pool, [0, 2, 2], True, "cpu")["peak_seconds"]
    assert counted == sum(toy_reference.peak_seconds(model, batches[j], True, TF32_OFF) for j in [0, 2, 2]) > 0
    # the toy's own answers, padded as a program hands them over, read 0; one altered does not
    outputs = []
    for b in batches:
        logits, lengths = toy_reference.logits(model, weights, b)
        probs = torch.full((*b["mask"].shape, 3), 1.0 / 3)
        for i, part in enumerate(torch.split(torch.softmax(logits, -1), lengths)):
            probs[i, :len(part)] = part
        outputs.append(probs)
    assert check.compare_infer(model, weights, batches, outputs)["logits_err"] < 1e-6
    outputs[1][0] = torch.roll(outputs[1][0], 1, dims=-1)
    assert check.compare_infer(model, weights, batches, outputs)["logits_err"] > 0.1


@pytest.mark.parametrize("name", ["numpy", "os.path", "portbenchx.reference", None])
def test_a_reference_outside_portbench_is_refused(name):
    with pytest.raises(ValueError, match="'reference'"):
        harness.Cell("toy.infer", dict(TOY, reference=name), {})


def test_a_reference_without_the_contracts_functions_is_refused():
    with pytest.raises(AttributeError, match="'reference'.*calibrate"):
        harness.Cell("toy.infer", dict(TOY, reference="portbench.counting"), {})


def tracer_on():
    from mvkpconv_tpu_torch import tracing

    with tracing.span("probe"):
        pass
    return any(r["name"] == "probe" for r in tracing.export())


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_gains_the_programs_spans(name):
    cell = tiny_cell(name)
    rec = harness.run_cell(cell, 2**31 + 7, 0.5, True, "cpu", time.perf_counter())
    old = {"kind", "fill", "setup_s", "setup_parts", "order", "window_s", "latencies_s", "failed", "spans",
           "profile", "steps", "points", "checks", "counts"}
    assert set(rec) == old | {"program"}
    prog, n = rec["program"], cell.mix["pool_batches"]
    for span in ("step", "pyramid", "model", "lift.unet"):
        assert len(prog["host_ms"][span]) == len(prog["launches"][span]) == n
        assert all(v > 0 for v in prog["host_ms"][span])
    rows = prog["counters"]["pyramid.neighbors"]
    assert len(rows["rows"]) == n and all(0 < r <= q for r, q in zip(rows["real_rows"], rows["rows"]))
    assert bool(prog["span_ms"]) == torch.cuda.is_available()  # the tracer's CUDA events need a card
    assert not tracer_on()


def test_the_readers_of_the_programs_spans():
    run = {"kind": "infer", "program": {"span_ms": {"lift.unet": [10.0, 11.0]},
                                        "launches": {"lift.unet": [{"unet_conv": 52}, {"unet_conv": 52, "x": 1}]}}}
    assert readers.program_span_ms(run, "lift.unet", "infer") == 10.5
    assert readers.program_launches(run, "lift.unet", "infer") == {"unet_conv": 52.0, "x": 0.5}
    for span, kind in (("lift", "infer"), ("lift.unet", "train")):
        assert readers.program_span_ms(run, span, kind) is None and readers.program_launches(run, span, kind) is None
    assert readers.program_span_ms({"kind": "infer"}, "lift.unet", "infer") is None


class Stub(harness.Program):
    """A program whose call is one ``step`` span, and raises on call
    ``fail_at``."""

    def __init__(self, fail_at=None):
        super().__init__("cpu")
        self.calls, self.fail_at = 0, fail_at

    def call(self, host):
        from mvkpconv_tpu_torch import tracing

        with tracing.span("step"):
            self.calls += 1
            if self.calls == self.fail_at:
                raise RuntimeError("planted")


def test_the_tracer_is_off_after_the_stretch_even_where_a_call_raises():
    pool = Pool([{}] * 3, [1] * 3)
    out = harness.program_spans(Stub(), pool, [0, 1, 2], "cpu")
    assert len(out["host_ms"]["step"]) == 3 and out["launches"]["step"] == [{}] * 3
    assert not tracer_on()
    with pytest.raises(RuntimeError, match="planted"):
        harness.program_spans(Stub(fail_at=2), pool, [0, 1, 2], "cpu")
    assert not tracer_on()
