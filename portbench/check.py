"""The comparisons that decide ``correct``: what the timed path produced,
against the reference that the model dict names (``references.of``; for
MV-KPConv ``portbench/reference``) run after the window in float32 with
TF32 off, on the same weights and batches, at the same sizes.

Inference (the loop ``closed_infer``): a sample of the window's batches
drawn from the seed (and the fullest it finished) — every real point's probabilities as they reached
the host, as centred log-probabilities (the logits up to a constant a
point) of the probabilities floored at 1e-12, ``logits_err`` = the largest
over the sample of ‖port − ref‖ / ‖ref‖. The floor: a point whose logits
lie far apart has probabilities that underflow float32 on one side and not
on the other, and the log of an underflow is no answer of the model.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import torch

from portbench.references import of

LIMITS = Path(__file__).resolve().parent / "limits"


def limits(workload: str) -> Dict[str, float]:
    """``{number: limit}`` of a cell (``limits/<workload>.json``)."""
    path = LIMITS / f"{workload}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no limits for cell {workload!r} ({path})")
    return {k: float(v["limit"]) for k, v in json.loads(path.read_text()).items()}


PROB_FLOOR = 1e-12


def centred_log(p: torch.Tensor) -> torch.Tensor:
    lp = torch.log(p.double().clamp(min=PROB_FLOOR))
    return lp - lp.mean(dim=-1, keepdim=True)


def compare_infer(model: Dict, weights, batches: List[Dict[str, torch.Tensor]],
                  outputs: List[torch.Tensor]) -> Dict[str, float]:
    """``outputs[i]``: the program's (B, N0, C) probabilities of
    ``batches[i]`` (device tensors)."""
    reference, worst = of(model), 0.0
    for batch, probs in zip(batches, outputs):
        logits, lengths = reference.logits(model, weights, batch)
        ref = centred_log(torch.softmax(logits, dim=-1))
        got = centred_log(torch.cat([probs[i, :n].to(ref.device) for i, n in enumerate(lengths)]))
        worst = max(worst, float((got - ref).norm() / ref.norm()))
    return {"logits_err": worst}

