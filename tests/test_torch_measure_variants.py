"""PyTorch port: the variant-accuracy matrix (``mvkpconv_tpu_torch/tools/
measure_variants.py``) at ``--tiny`` on ``--device cpu``, as
``tests/test_tools.py::test_measure_variants_two_stage_tiny`` runs the JAX
tool: a KPFCNN row and an early-fusion row.

  * ``results.json`` holds the rows in the order ``--only`` gives, each with
    the JAX tool's keys (``mvkpconv_tpu/tools/measure_variants.py``:
    miou, oa, final_loss, steps, minutes, protocol);
  * the two-stage protocol: the 2D net pretrained once and saved as a 2D
    run, the fusion row ``two_stage_frozen_2d`` and its ``net_2d`` (saved
    with ``--save-checkpoints``) equal to the pretrained UNet, bit for bit,
    the KPFCNN row ``3d_only``;
  * rerunning into the same ``--out`` skips the finished rows and reuses the
    saved 2D net: the same results, and nothing trained.
The accuracies are not compared (the tool's tiny size means nothing).
"""

import json

import torch

from mvkpconv_tpu_torch.tools import measure_variants

KEYS = {"miou", "oa", "final_loss", "steps", "minutes", "protocol"}
ARGS = ["--tiny", "--steps", "2", "--steps-2d", "2", "--train-scenes", "1", "--val-scenes", "1",
        "--device", "cpu"]


def test_measure_variants_two_stage_tiny(tmp_path, capsys):
    rows = "kpconv_baseline,mvkpconv_early"
    res = measure_variants.main([*ARGS, "--only", rows, "--out", str(tmp_path), "--save-checkpoints"])
    assert json.loads((tmp_path / "results.json").read_text()) == res
    assert list(res) == ["kpconv_baseline", "mvkpconv_early"]
    assert all(set(r) == KEYS and r["steps"] == 2 for r in res.values())
    assert res["kpconv_baseline"]["protocol"] == "3d_only"
    assert res["mvkpconv_early"]["protocol"] == "two_stage_frozen_2d"
    unet = torch.load(tmp_path / "net_2d" / "checkpoints" / "model_best.pt", weights_only=True)["model"]
    row = torch.load(tmp_path / "mvkpconv_early" / "checkpoints" / "ckpt_00000002.pt",
                     weights_only=True)["model"]
    for k, v in unet.items():
        assert torch.equal(row[f"net_2d.{k}"], v), k
    assert (tmp_path / "kpconv_baseline" / "parameters.txt").exists()
    capsys.readouterr()

    again = measure_variants.main([*ARGS, "--only", rows, "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert again == res
    assert "2D net: reusing" in out and out.count("already in") == 2
    assert "step 0" not in out  # nothing trained
