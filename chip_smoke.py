"""Chip smoke test of the PyTorch / CUDA port (``mvkpconv_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  1. device: the card (``nvidia-smi`` name and power limit), torch's CUDA
     version and the ``nvcc`` version; exits non-zero without a card;
  2. build: compiles ``mvkpconv_tpu_torch/csrc/*.cu`` with nvcc (sm_90a), one
     ``nvcc -c`` per source in parallel, and lists ``ptxas``' registers and
     spills per kernel;
  3. k1_*: the radius top-k kernel against its plain PyTorch version at each
     of the 13 shapes one forward of the bench configuration launches (5
     conv, 4 pool, 4 upsample) and at k=100: indices equal, or differing only
     where the selected d² tie within 2⁻²⁰ relative; kernel and plain times
     (CUDA events, after a warm-up), their sum over the 13 calls
     (``k1_forward_sum``), and the time of the kernel this one replaced
     (``earlier_ms``); k1_adv_*, untimed, on inputs made to break a skip of
     supports by their boxes: shuffled points, supports at and around
     rounded d² = r² of a query in another group, a padded tail, Ns = 1000
     and Ns < k;
  4. k2_*: the pixel top-k kernel against its plain version at bench shapes
     (B=4, N=16384, V=5, 120×160, window 7, k=3), bf16 and f32 candidates,
     timed, with the replaced kernel's time (``earlier_ms``); k2_adv_*,
     untimed, on inputs made to break its tie rule and its lane groups:
     exact d² ties inside a window and across views (coordinates on a
     quarter grid, every view a copy of the first), windows at the four
     image borders, k = 1, 3 and 32: indices equal, or d² tied within 2⁻²⁰;
  5. parity: the whole slice on the card (kernels) against the CPU (plain
     versions) at a small ARCHITECTURE_DEEPER configuration with the same
     weights, in f32 with TF32 off: max |Δ logit| ≤ 1e-4 · max |logit| on
     valid points, the card's K1, K2 and K4 launches from the plan;
  6. full: the slice at the bench configuration (B=4, N0=16384, 5 levels,
     K=30, 5 views of 120×160, width 128, bf16) with seeded random weights:
     finite logits of shape (4, 16384, 20), 13 radius top-k calls (26 device
     launches: each call a box pre-pass and the search) and 1 pixel top-k
     launch per forward, ms per forward and points/s;
  7. k3_*: the gather-VJP segment sum against its plain version at the
     bench configuration's level-0 gather sites (the pyramid's voxel-sorted
     indices, seeded normal rows) and at the fused path's widths there
     (3 + Cin: 35 and 69), each with f32 rows, bf16 rows, and f32 rows with
     ``round_bf16`` as the default path (``banded_bf16``) hands them, held
     against ``segsum_plain(rows, round_bf16=True)``: each element within
     2⁻¹⁸ · Σ|rows into its target| (the kernel adds in another order than
     ``index_add_``), the shadow row on its own, and the same bits again on
     the same plan and on a new one; kernel, plan, plain and
     ``index_add_`` times, the replaced kernel's time (``earlier_ms``) and,
     for the rounded rows, the cast the path ran before (``earlier_cast_ms``);
     k3_adv_*, untimed: every row on one target, every row on the shadow
     row, widths 1, 5, 35, 69 and 300, rows that start off a 16-byte
     boundary, K = 1; k1_*_deform and k3_*_deform, untimed: K1 at each
     selection ``infer.deform_config()`` widens to ``deform_radius`` (level
     3's conv, pool and upsample, level 4's conv: over-full balls at the
     same k) and K3 at its deformed convs' gathers on those neighbor
     tensors (3 + Cin: 259 and 515 wide);
  8. train_parity: 3 train steps on the card (kernels, gather VJP
     'banded') against the CPU (plain versions) from the same weights,
     f32, TF32 off, a batch without padded rows: each step's loss within
     1e-5 relative, every parameter after each step within rtol 1e-3, atol
     1e-5·(the largest |param| of the model); at the configuration of
     phase 5 each step starts from the CPU's state, at a 2-level one the
     two run free (see ``check_train_parity``);
  9. train_full: the train step at the bench configuration (bf16, gather
     VJP 'banded_bf16'): a warm-up step, then 5 timed steps; loss finite,
     parameters outside ``net_2d`` changed and ``net_2d`` unchanged bit for
     bit, one K3 launch per trunk gather whose features need a gradient
     (counted from the plan), each handed f32 rows with ``round_bf16`` (no
     cast pass) and its neighbor tensor's plans, at most one plan a
     neighbor tensor, ms per step, points/s and peak memory;
 10. k4_*: the fused KPConv kernels (forward, cotangent of the gathered
     features, weighted sums and the weight gradient built on them) against
     their plain versions at four conv sites of the bench pyramid (level-0
     ``simple`` 66→64 and ``resnetb`` 32→32, the first ``resnetb_strided``,
     the deepest ``resnetb`` 512→512), f32 and bf16 features: each element
     within 2⁻¹⁸ · Σ|terms| of the plain version, both judged against a
     float64 evaluation; with bf16 features the cotangent also as the main
     path takes it, written in bf16 by the kernel (the same allowance plus
     half a bf16 ulp); every kernel run twice and equal bit for bit; kernel,
     plain and einsum-chain times, each kernel's beside the time of the one
     it replaced (``earlier_ms``); the same checks without the times at one
     ``resnetb`` site of every level between; k4_shape_*: the three kernels,
     untimed, at shapes off the bench's (K up to 128, M up to 32, widths of 1,
     5, 31, 33, 40, 66, 70 channels, feature rows at 2-, 4- and 16-byte
     alignment);
 11. parity_fused: the forward on the card (K4) against the CPU (plain) with
     ``use_pallas_kpconv=True, influence_cache='none'`` at the configuration
     of phase 5, for early, middle and late fusion; train_parity_fused: the
     3 train steps of phase 8 with those flags;
 12. full_fused, train_full_fused: phases 6 and 9 on the fused path, with the
     K4 launch counts and the gather VJPs' row widths (3 + Cin at the conv
     gathers) from the plan, beside the default path's figures;
 13. the deformable MV-KPConv and the 3D-only baselines: parity_deform and
     train_parity_deform, phases 5 and 8 with deformable KPConv in the last
     two of 3 levels, with and without modulations (the regularizer of
     each forward and step also within 1e-5 relative, every parameter held,
     ``offset_conv`` and ``offset_bias`` among them, each step from the
     CPU's state; the modulated train steps on the 3D-only trunk, where no
     ReLU of the lift flips at rounding); parity_baseline and train_parity_baseline, the
     same for the KPFCNN (``fusion='none'``) on the default and the fused
     path, the forward at the configuration of phase 5, the train steps at 3
     levels (at 5 a leaky-ReLU input that flips at rounding moves the third
     step by more than the allowance); parity_kpcnn, phase 5 for the KPCNN
     classifier; train_full_deform, phase 9 at ``infer.deform_config()`` (the
     regularizer finite and > 0, the offset parameters' first update at
     ``deform_lr_factor`` times the learning rate, K3 launches from the
     plan: two gathers a deformable block); full_baseline and
     train_full_baseline, phases 6 and 9 at ``infer.baseline_config()``
     (no K2 launch);
 14. train_full_remat, train_full_fused_remat: phase 9 on the default and
     the fused path with ``remat='blocks'``: K3 still once a trunk gather a
     step (the backward runs the first forward's graph, and its plans), K4's
     forward twice a fused block (the recompute), ``wf`` and ``bwd_x`` once;
     from the same weights, two steps with remat and two without, both
     under deterministic algorithms (the pyramid's atomic sums part any two
     runs otherwise; the timed runs' gap is printed): the second step's
     loss, which the first backward decides, within 1e-5 relative, and
     every parameter and statistic after the two steps within the train
     step's allowance (rtol 1e-3, atol 1e-5 of the largest); and a lower
     peak memory;
 15. the training entry point, as a user runs it (PyTorch's TF32 defaults):
     train_scannet_full runs ``tools/train_scannet.main`` at the CLI's
     default configuration (MV-KPConv early fusion, width 128, B=5,
     N0=16384, K=34, 5 views of 120x160, f32, the UNet trained) with
     ``epoch_steps=2, validation_size=10`` for 4 steps on synthetic scenes:
     ms and data ms of each step (the Trainer's meters, host clock), device
     busy per step (``torch.profiler``, 3 more steps), peak memory, losses,
     validation mIoU, points per sphere before padding, the host's sampling
     time a batch by stage, K1/K2/K3 launches split between the train steps
     and the validations and held to the plan, the checkpoint files;
     train_scannet_resume runs the same command to step 6 and holds the
     restored model and optimizer state to the step-4 checkpoint bit for
     bit; train_scannet_frozen runs 2 steps from a seeded UNet checkpoint
     (``--path-2d``) on the fused path (K4 launches held to the plan): the
     UNet's parameters and statistics unchanged bit for bit, everything else
     moved; test_models runs the voting test of the run at 0.5 votes
     (subsampled and full-resolution mIoU finite, K1/K2 per forward, no K3);
 16. trainer_parity: 2 ``Trainer`` steps card against CPU at phase 5's
     configuration with the UNet trained, real sphere batches from one
     dataset seed, f32, TF32 off: each loss within 1e-5 relative, every
     parameter and statistic within phase 8's allowance.

 17. the MVPNet path's kernels and index ops (run after phase 7):
     k2_mvpnet_float32, K2 at ``MVPNet3D``'s selection (4
     chunks of 8192 points from ``ChunkDataset``, 3 views of 120x160,
     window 9, k = 3, f32 candidates) against its plain version, timed;
     k2_precompute_first, k2_precompute_padded_tail: K2 at
     ``precompute_2d``'s inputs (one scene's 24 frames of 120x160, window
     7, a 4,096-point chunk timed, and the last chunk, padded with points
     at the origin);
     pn2_index_ops, the FPS, ball query and 3-NN of one PN2SSG forward on
     those points, each call timed (the FPS is an eager host loop);
     k3_pn2_sa0, k3_pn2_fp3, k3_pn2_padded: K3 held like phase 7 at the
     SA0 feature gather, the FP3 interpolation gather and a ball query
     whose rows mostly repeat their centroid, f32, bf16 and rounded rows,
     the call that builds its plan (as every PN2 gather VJP does) beside
     the sum given one;
 18. the mvpnet fork's workflow, as a user runs it (PyTorch's TF32
     defaults): train_2d_full (``tools/train_2d.main`` at its defaults,
     UNet-ResNet34, B=8 frames of 120x160, lr 5e-3, f32: 3 steps, the
     full-frame validation sweep, checkpoints), then ``tools/test_2d`` on
     the run reproducing its last ``val_miou`` within 1e-6;
     train_mvpnet_full (``tools/train_mvpnet.main`` at its defaults: B=4
     chunks of 8192 points, 3 views of 120x160, PN2SSG at the published
     widths, the UNet frozen, f32: 3 steps, the 4-batch validation, a
     checkpoint; ms and data ms a step, device busy a step, peak memory,
     the index ops' ms; K2 once and K3 8 sums with 8 plans a step; the
     frozen ``net_2d`` bit-equal to its seeded weights, every other tensor
     moved); test_mvpnet (sliding chunks at stride 0.5 over one scene:
     chunks, seconds, coverage; K2 once a forward); train_pn2_full
     (``--no-images``: K3 7 sums a step, no K2); precompute_2d (one scene
     from the 2D run, 4,096-point chunks: K2 once a chunk, finite features
     of shape (N, 64); K2 launched at exactly the shapes phase 17 held);
 19. parity_mvpnet, parity_pn2, train_parity_mvpnet, train_parity_pn2:
     MVPNet3D and PN2SSG on the card against the CPU, f32, TF32 off, 2
     chunks of 1024 points, 3 views of 24x32, PN2SSG's centroids cut to
     (256, 64, 16, 4), dropout 0: the eval logits within 1e-4·max|logit|,
     3 train steps ('banded') each from the CPU's state: the loss within
     1e-5, the BN statistics within phase 8's allowance, the frozen net_2d
     bit-equal, each trained tensor's update within 0.25 of the CPU's norm
     of it (a max over neighbors flips at rounding: see
     ``check_mvpnet_parity``), the launches held to the plan; then two
     planted faults on the card's step 1 (the smallest tensor's gradient
     zeroed, the backward's first K3 sum zeroed) must fail that check;
 20. native_host_ops: the port's C++ host ops (``data/native.py``) built
     with g++ and loaded (a run on the numpy fallbacks fails), on a
     synthetic scan of 1,000,000 points: the voxel subsample at the CLI's
     0.04 m equal to the numpy fallback's as a set (barycentres and colours
     within 1e-5, majority labels equal), the 1-NN of 256 jittered points
     equal to numpy's brute force, host ms of each;
 21. test_colmap_full: a COLMAP workspace of that scan (24 images, PINHOLE,
     480x640 depth maps, a rotation and a translation into the scan's frame
     in ``matrix_for_images.txt``), a run directory of seeded weights at the
     training CLI's default configuration, ``tools/test_colmap.main`` on the
     card at 1 vote (PyTorch's TF32 defaults): the poses back in the scan's
     frame, K1 13 calls (26 launches) and K2 once a forward, no K3 or K4,
     the prediction PLY re-read (a label in [0, C) per point of the
     subsampled scan); host seconds of the scene's assembly and of the
     dataset, forwards, ms and device busy a forward, peak memory, the
     spheres' fill of N0, and the frame overlap's 1-NN at the JAX
     package's 0.1 m cell against the library's own and numpy;
 22. test_colmap_parity: the same workspace at a small configuration (3
     levels, width 32, N0=1024, B=2, 3 views of 120x160), card against
     ``--device cpu``, f32, TF32 off: the same spheres, the accumulated
     probabilities within 1e-4 of their largest, labels equal except at
     near-ties (counted).

 23. resume_jax_run: a run directory in the JAX package's layout (the flax
     ``TrainState`` msgpack that ``training/jax_checkpoint.py`` writes, of 2
     CPU steps at phase 5's configuration, the UNet frozen, 'banded', the
     learning rate halved at step 2) resumed by ``Trainer.maybe_resume`` on
     the card and on the CPU, then one step each, f32, TF32 off: the
     momentum restored bit for bit, the loss within 1e-5 relative, every
     parameter and momentum buffer within phase 8's allowance, the decayed
     learning rate and the schedule's count equal, K1 13, K2 1 and K3 once
     a trunk gather;
 24. inspect_deform_full: ``eval/deform_inspect.inspect_deformable`` at
     ``infer.deform_config()`` on the bench batch: 5 deformable layers,
     finite statistics, a PLY and a viewer each, K1 13 calls (26 launches)
     and K2 1 in its forward; its seconds beside the forward's ms;
 25. export_full, export_full_fused: ``eval/export.export_inference`` at the
     bench configuration on both paths, saved and loaded back by
     ``ServingModel``, 5 calls: K1 13 (26), K2 1 and on the fused path K4's
     forward 14 a call, through the ``mvkpconv::`` operators; the
     probabilities equal the eager model's within 1e-6 of the largest, both
     under ``torch.use_deterministic_algorithms`` (the spread without it is
     printed); export and load seconds, artifact bytes, ms a call beside
     the eager forward's, timed right after it, and phase 6's and 12's;
 26. measure_variants_tiny: ``tools/measure_variants --tiny`` on the card,
     the KPFCNN row, then the early-fusion row (its 2D net pretrained and
     frozen): the report's keys and protocols, each row's K1, K2 and K3
     launches (K2 on the fusion row only).

 27. fps_sa0..fps_sa3 (inside phase 17, after pn2_index_ops, whose FPS
     times are now P1's): the farthest-point-sampling kernel P1 (a cloud a
     thread-block cluster, its plan from ``fps.plan(N)``) against its
     plain version (the eager loop) at PN2SSG's four levels on the MVPNet
     batch (B=4, N=8192 → 2048, 512, 128, 32): indices equal; the plan,
     kernel and plain ms (CUDA events), µs a step, the kernel's device ms
     (``torch.profiler``), the bound (max of the bytes at 3.35 TB/s and
     9·B·N·S operations at 67 TFLOP/s) and the dependent steps (S − 1, the
     serial chain); fps_forward_sum, their sum; fps_plans_sa0..3, each
     level under every plan a built instance takes (``fps.INSTANCES``
     laid out by ``fps.layout``: 1 CTA with 1, 2, 4 or 8 points a thread,
     2, 4 or 8 CTAs with 8), indices equal, the kernel's device ms and µs
     a step of each, and which one ``fps.plan`` picks;
     fps_adv_*, untimed: a padded tail masked out (a different length a
     cloud, at the shadow coordinate), more samples than points, exact ties
     (a quarter grid), N = 20,000, masked there too, far corners copied on
     every CTA and warp boundary, ragged N, only point 0 valid, 2 × 100,000
     (the scratch array), and every built instance under a forced plan;
     every cluster size and the scratch array are used. Phase 18
     holds P1's launches: 4 a step and a validation forward of MVPNet and
     PN2, 4 a ``test_mvpnet`` forward, none in ``precompute_2d``; and
     train_mvpnet_full reports P1's device ms a step and its share;
 28. export_mvpnet (with phase 25): ``export_inference(kind='mvpnet')`` at
     ``train_mvpnet``'s defaults (4 chunks of 8192 points, 3 views of
     120x160, f32, seeded weights), saved, loaded, 5 calls: P1 4 and K2 1 a
     call through the operators, equal to the eager model under
     deterministic algorithms; export and load seconds, bytes, ms a call
     beside the eager forward's;
 29. ddp_gloo_2proc: two processes on this card over gloo
     (``parallel.spawn``), the bench batch split 2 spheres a process: (a)
     in f32 (gather VJP 'banded', TF32 off, deterministic algorithms) one data-parallel step's loss
     and state against the single-process step on the whole batch, loss
     rtol 1e-5, state rtol 1e-4, atol 1e-6, K1 13 (26), K2 1, K3 22 + 13 a
     process; (b) the bench configuration (bf16), 5 timed steps a process,
     ms a step and peak memory;
 30. ddp_nccl_world1: one NCCL process (``torchrun --nproc-per-node 1``'s
     path): the data-parallel step bit-equal to the plain step, and the
     plain step to itself, under deterministic algorithms;
     dryrun_multichip_cpu: ``parallel.dryrun_multichip(4, device='cpu')``, 4 gloo CPU
     processes on a (data=2, model=2) mesh (FSDP2 on this machine's torch).
 31. middle and late fusion (``infer.fusion_config``): k3_L0_simple_2d and
     k3_L0_simple_2d_fused (with phase 7: K3 at middle fusion's
     ``encoder_2d`` first gather, ones ⊕ the lifted features, 65 wide, 68
     with the positions), k4_L0_simple_2d (65 → 64, all three kernels) and
     k4_L0_simple_3d (2 → 64, the 3D stream's first block: forward and
     ``wf``, no ``bwd_x``) with phase 10; after phase 12: parity and
     train_parity (phases 5 and 8, each step from the CPU's state) for
     middle and late fusion, train_parity_fused for middle fusion (K4 in
     both encoders, ``bwd_x`` on ``encoder_2d``'s first block); full_middle,
     train_full_middle, full_late, train_full_late, full_middle_fused,
     train_full_middle_fused (phases 6, 9 and 12 at the bench configuration
     with that fusion, beside early fusion's row of the same path, launches
     from the plan, K4 twice early fusion's on the fused path); every row of
     phases 6, 9 and 12 and of this one with its device busy ms and the
     hand-written kernels' device ms (``torch.profiler``, 3 runs); with phase
     15 train_scannet_late / test_models_late (the CLI's default
     configuration with ``--fusion late``) and train_scannet_middle /
     test_models_middle (the same cut to 3 levels), each 2 steps, a
     validation of one batch at step 2 and at the end, 0.5 votes: launches
     of steps, validations and the test from the plan, ``parameters.txt``
     and the checkpoint restored into a fresh model bit-equal to the trained
     one, ms, device busy and peak a step; with phase 25 export_full_late
     (phase 25 at the bench configuration with late fusion) and
     export_small_middle (middle fusion at phase 5's configuration, B=2).

Every phase's line carries ``t_s``, the script's seconds so far.

Then one JSON line with every kernel's figures (its time beside the least
time the card could take for the same bytes and operations), the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
"""

import contextlib
import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TIE_REL = 2.0**-20  # a few float32 ulps
PARITY_REL = 1e-4
SEGSUM_REL = 2.0**-18  # of Σ|rows| into each target
KPCONV_REL = 2.0**-18  # of Σ|terms| of each output element
KPCONV_INFLUENCE_ABS = 2.0**-20  # of an influence weight (they lie in [0, 1])
BF16_HALF_ULP = 2.0**-8  # of a value: what rounding it to bf16 may move it by
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM data sheet, outside the tensor cores
TRAIN_LOSS_REL = 1e-5
REG_REL = 1e-5  # the deformable regularizer, card against CPU
TRAIN_PARAM_RTOL, TRAIN_PARAM_ATOL_REL = 1e-3, 1e-5
T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also gets the script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 1)}
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=20):
    """Device ms per call of ``fn``: every kernel it launches, summed, from
    ``torch.profiler`` over ``reps`` calls after a warm-up. Unlike
    ``cuda_ms`` it does not read the wrapper's host time where that is longer
    than the kernels (0.05–0.08 ms a call). A profile that recorded no device
    time at all (it happens now and then, twice in a row as well) is taken
    again, up to six times."""
    return device_ms_by(fn, reps)["total"]


def device_ms_by(fn, reps=20, names=()):
    """``device_ms`` of ``fn``, and of the kernels whose name holds each of
    ``names``: ``{"total": ms, name: ms, ...}`` per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(6):
        with torch.profiler.profile(activities=acts, acc_events=True) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in kernels)
        if total > 0:
            return {"total": total / 1e3 / reps,
                    **{n: sum(e.self_device_time_total for e in kernels if n in e.key) / 1e3 / reps for n in names}}
    raise RuntimeError("device_ms: the profiler recorded no device time")


def ptxas_by_entry(lib):
    """``ptxas -v``'s registers and spill lines from the build log, each
    after the entry function it reports on."""
    out, entry = [], None
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else None
        elif "registers" in line or "spill" in line:
            out.append(f"{entry}: {line.strip()}" if entry else line.strip())
    return out


def bound(nbytes, flops):
    """The least ms the card could take: each input read once and each
    output written once at the memory rate, or the operations at the f32
    peak, whichever is larger; and which of the two."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def d2_gaps(d2_got, d2_want, r2=None):
    """(relative, absolute) largest gap between two selections' ascending d²
    lists; where one list has an entry and the other none (inf), the entry
    is compared with r²."""
    import torch

    if d2_got.numel() == 0:
        return 0.0, 0.0
    if r2 is not None:
        fill = torch.full_like(d2_got, r2)
        d2_got, d2_want = (
            torch.where(torch.isinf(d2_got) & torch.isfinite(d2_want), fill, d2_got),
            torch.where(torch.isinf(d2_want) & torch.isfinite(d2_got), fill, d2_want),
        )
    if torch.isinf(d2_got).ne(torch.isinf(d2_want)).any():
        return float("inf"), float("inf")
    both = torch.isfinite(d2_got)
    diff = torch.where(both, (d2_got - d2_want).abs(), torch.zeros_like(d2_got))
    rel = diff / torch.maximum(d2_got.abs(), d2_want.abs()).clamp(min=1e-30)
    return float(rel.max()), float(diff.max())


def pairs_within(query, support, r2):
    """How many (query, support) pairs of the same batch element lie within
    the squared radius, counted in slabs of queries."""
    total = 0
    for q0 in range(0, query.shape[1], 2048):
        diff = query[:, q0:q0 + 2048, None, :] - support[:, None, :, :]
        total += int(((diff * diff).sum(-1) <= r2).sum())
    return total


# Times of the kernels that the present K1–K4 kernels replaced, ms, from
# this script on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md's kernel tables);
# bwd_x's were taken with an f32 result.
EARLIER_MS = {
    "k1_L0_conv": 3.126, "k1_L0_pool": 1.866, "k1_L0_upsample": 0.154, "k1_L3_conv": 0.106,
    "k1_L2_conv_k100": 1.372,
    "k4_L0_simple_float32": 1.621, "k4_L0_simple_bfloat16": 1.577,
    "k4_L0_resnetb_float32": 0.648, "k4_L0_resnetb_bfloat16": 0.501,
    "k4_L0_strided_float32": 0.171, "k4_L0_strided_bfloat16": 0.146,
    "k4_L4_resnetb_float32": 0.294, "k4_L4_resnetb_bfloat16": 0.275,
    "k4_L0_simple_float32_bwd_x": 2.024, "k4_L0_simple_bfloat16_bwd_x": 1.995,
    "k4_L0_resnetb_float32_bwd_x": 0.443, "k4_L0_resnetb_bfloat16_bwd_x": 0.445,
    "k4_L0_strided_float32_bwd_x": 0.119, "k4_L0_strided_bfloat16_bwd_x": 0.120,
    "k4_L4_resnetb_float32_bwd_x": 0.212, "k4_L4_resnetb_bfloat16_bwd_x": 0.219,
    "k4_L0_simple_float32_wf": 0.624, "k4_L0_simple_bfloat16_wf": 0.684,
    "k4_L0_resnetb_float32_wf": 0.297, "k4_L0_resnetb_bfloat16_wf": 0.373,
    "k4_L0_strided_float32_wf": 0.084, "k4_L0_strided_bfloat16_wf": 0.102,
    "k4_L4_resnetb_float32_wf": 0.074, "k4_L4_resnetb_bfloat16_wf": 0.071,
    "k2_bfloat16": 0.0773,
    "k3_L0_simple_bfloat16": 0.269, "k3_L0_resnetb_float32": 0.151, "k3_L0_resnetb_bfloat16": 0.124,
}
EARLIER_FROM = "the kernel before its redesign (PERF.md)"


def check_k1(name, query, support, radius, k, results, timed=True):
    """K1 against its plain version on one (query, support) pair: equal
    indices, or rows that differ only where the selected d² tie within 2⁻²⁰
    relative; with ``timed`` also the kernel's and the plain version's times
    and the bound."""
    import torch
    from mvkpconv_tpu_torch.ops.kernels import radius_topk as k1

    got = k1.radius_topk(query, support, radius, k)
    want = k1.radius_topk_plain(query, support, radius, k)
    torch.cuda.synchronize()
    ns = support.shape[1]
    s_pad = torch.cat([support, torch.full_like(support[:, :1], float("inf"))], dim=1)

    def d2(idx):
        nb = torch.gather(
            s_pad, 1, idx.long().reshape(idx.shape[0], -1, 1).expand(-1, -1, 3)
        ).reshape(*idx.shape, 3)
        diff = query[:, :, None, :] - nb
        return (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]

    differ = (got != want).any(-1)
    gap, gap_abs = d2_gaps(d2(got)[differ], d2(want)[differ], k1.squared_radius(radius))
    assert got.shape == want.shape and got.dtype == torch.int32, name
    assert bool(((got >= 0) & (got <= ns)).all()), name
    assert gap <= TIE_REL, f"{name}: K1 disagrees with its plain version (d² gap {gap})"
    if not timed:
        row = {"phase": name, "nq": query.shape[1], "ns": ns, "b": query.shape[0], "k": k,
               "radius": radius, "rows_differ": int(differ.sum()), "max_d2_gap_rel": gap,
               "max_d2_gap": gap_abs, "found": int((got < ns).sum())}
        emit(row)
        results.append(row)
        return got
    ms = cuda_ms(lambda: k1.radius_topk(query, support, radius, k), reps=20)
    plain_ms = cuda_ms(lambda: k1.radius_topk_plain(query, support, radius, k), reps=3, warmup=1)
    in_radius = pairs_within(query, support, k1.squared_radius(radius))
    row = {
        "phase": name, "nq": query.shape[1], "ns": ns, "b": query.shape[0], "k": k,
        "radius": radius, "rows_differ": int(differ.sum()), "max_d2_gap_rel": gap, "max_d2_gap": gap_abs,
        "ms": ms, "plain_ms": plain_ms, "pairs_in_radius": in_radius,
        "pairs": query.shape[0] * query.shape[1] * ns,
        # the function needs a d² (8 operations) and a comparison only for
        # the pairs within the radius in this run's data: an exact search may
        # skip every other support by its box.
        **bound(nbytes(query, support, got), 9.0 * in_radius),
    }
    if name in EARLIER_MS:
        row.update({"earlier_ms": EARLIER_MS[name], "earlier_from": EARLIER_FROM})
    emit(row)
    results.append(row)
    return got


def forward_k1_calls(spec, levels):
    """(name, queries, supports, radius, k) of the 13 selections one pyramid
    makes, as ``build_pyramid`` makes them."""
    calls = []
    for l, (p, _) in enumerate(levels):
        calls.append((f"k1_L{l}_conv", p, p, spec.radius(l), spec.conv_k(l)))
        if l + 1 < len(levels):
            sub, rp = levels[l + 1][0], spec.pool_radius(l)
            calls.append((f"k1_L{l}_pool", sub, p, rp, spec.pool_k(l)))
            calls.append((f"k1_L{l}_upsample", p, sub, 2.0 * rp, 1))
    return calls


def check_k1_adversarial(p0, radius, k, results):
    """K1 on inputs made to break a skip of supports by their boxes, untimed:
    shuffled points; a support at rounded d² just under and exactly at r² of
    a query in another group; a padded tail; Ns that is no multiple of a
    group; Ns < k."""
    import numpy as np
    import torch
    from mvkpconv_tpu_torch.ops.kernels import radius_topk as k1

    dev = p0.device
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    b, n, _ = p0.shape
    perm = torch.stack([torch.randperm(n, generator=gen) for _ in range(b)]).to(dev)
    shuffled = torch.gather(p0, 1, perm[..., None].expand(b, n, 3)).contiguous()
    check_k1("k1_adv_shuffled", shuffled, shuffled, radius, k, results, timed=False)
    check_k1("k1_adv_shuffled_supports", p0, shuffled, radius, k, results, timed=False)

    # Boundary: supports far from the cloud, at x offsets around the radius
    # from queries at x = 0 that sit in other groups (the sorted cloud keeps its
    # order; the probes are appended, so their groups' boxes are their own).
    r = np.float32(radius)
    r2 = np.float32(k1.squared_radius(radius))
    base = np.array([0.0, 100.0, 0.0], np.float32)  # x = 0: the offsets below are exact
    offs = []
    for start in (r, np.nextafter(r, np.float32(0)), np.nextafter(r, np.float32(1))):
        d = start
        for _ in range(4):  # a few neighbours of the radius on either side
            offs.append(d)
            d = np.nextafter(d, np.float32(0))
    # the rounded d² of each probe, as the kernel forms it: (x_q − x_s)², y = z = 0
    probes_q = np.tile(base, (len(offs), 1))
    probes_q[:, 1] += np.arange(len(offs), dtype=np.float32) * 5.0  # probes do not see each other
    probes_s = probes_q.copy()
    probes_s[:, 0] = probes_q[:, 0] + np.asarray(offs, np.float32)
    dx = probes_q[:, 0] - probes_s[:, 0]
    d2 = (dx * dx).astype(np.float32)
    assert (d2 < r2).any() and (d2 >= r2).any() and len(probes_q) < 32, "probes do not straddle r²"
    # queries: the cloud then the probe queries; supports: the cloud, 40
    # far fillers (so the probe supports start a group of their own), then the
    # probe supports
    filler = np.tile(np.array([[-50.0, -50.0, -50.0]], np.float32), (40 + (-n - 40) % 32, 1))
    q_np = np.concatenate([p0[0].cpu().numpy(), probes_q])[None]
    s_np = np.concatenate([p0[0].cpu().numpy(), filler, probes_s])[None]
    q_t, s_t = torch.from_numpy(q_np).to(dev), torch.from_numpy(s_np).to(dev)
    got = check_k1("k1_adv_boundary", q_t, s_t, radius, k, results, timed=False)
    first = got[0, n:, 0].cpu().numpy()
    want_first = np.where(d2 < r2, n + len(filler) + np.arange(len(offs)), s_np.shape[1])
    assert (first == want_first).all(), f"k1_adv_boundary: probes at the radius: {first} != {want_first}"
    emit({"phase": "k1_adv_boundary_probes", "probes": len(offs), "within": int((d2 < r2).sum()),
          "exactly_at_r2": int((d2 == r2).sum()), "beyond": int((d2 > r2).sum())})

    # a padded tail: a few hundred rows at the shadow coordinate
    padded = p0.clone()
    padded[:, -300:] = 1e6
    got = check_k1("k1_adv_padded_tail", padded, padded, radius, k, results, timed=False)
    tail = got[:, -300:].cpu()
    assert bool((tail == torch.arange(n - 300, n - 300 + k, dtype=torch.int32)).all()), \
        "padded queries must select the first k padded supports"
    # Ns no multiple of the group size, and fewer supports than k
    some = p0[:, :3000].contiguous()
    check_k1("k1_adv_ns1000", some, p0[:, :1000].contiguous(), radius, k, results, timed=False)
    check_k1("k1_adv_ns_below_k", some, p0[:, :k - 7].contiguous(), 4 * radius, k, results, timed=False)
    check_k1("k1_adv_ns_below_k_k1", some, p0[:, 5:6].contiguous(), 40 * radius, 1, results, timed=False)


def check_k2(name, points, image_xyz, iu0, iv0, window, k, results, timed=True, **extra):
    """K2 against its plain version: equal indices, or rows that differ only
    where the selected d² tie within 2⁻²⁰ relative; with ``timed`` also the
    kernel's and the plain version's times and the bound. ``extra`` goes on
    the row."""
    import torch
    from mvkpconv_tpu_torch.ops.kernels import pixel_select as k2

    got = k2.pixel_topk(points, image_xyz, iu0, iv0, window, k)
    want = k2.pixel_topk_plain(points, image_xyz, iu0, iv0, window, k)
    torch.cuda.synchronize()
    b = points.shape[0]
    flat = image_xyz.reshape(b, -1, 3).float()

    def d2(idx):
        c = torch.gather(flat, 1, idx.long().reshape(b, -1, 1).expand(-1, -1, 3)).reshape(*idx.shape, 3)
        diff = c - points[:, :, None, :]
        return (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]

    differ = (got != want).any(-1)
    gap, gap_abs = d2_gaps(d2(got)[differ], d2(want)[differ])
    assert got.shape == want.shape and got.dtype == torch.int32, name
    assert bool(((got >= 0) & (got < flat.shape[1])).all()), name
    assert gap <= TIE_REL, f"{name}: K2 disagrees with its plain version (d² gap {gap})"
    row = {
        "phase": name, "b": b, "n": points.shape[1], "views": image_xyz.shape[1],
        "hw": list(image_xyz.shape[2:4]), "window": window, "k": k,
        "dtype": str(image_xyz.dtype).replace("torch.", ""),
        "rows_differ": int(differ.sum()), "max_d2_gap_rel": gap, "max_d2_gap": gap_abs, **extra,
    }
    if not timed:
        emit(row)
        results.append(row)
        return
    row.update({
        # device times (the wrapper's host time exceeds the kernel's)
        "ms": device_ms(lambda: k2.pixel_topk(points, image_xyz, iu0, iv0, window, k)),
        "plain_ms": device_ms(lambda: k2.pixel_topk_plain(points, image_xyz, iu0, iv0, window, k), reps=5),
        "call_ms": cuda_ms(lambda: k2.pixel_topk(points, image_xyz, iu0, iv0, window, k), reps=20),
        # a d² and a comparison for every pixel of every view's window
        **bound(nbytes(points, image_xyz, iu0, iv0, got),
                9.0 * b * points.shape[1] * image_xyz.shape[1] * window * window),
    })
    if name in EARLIER_MS:
        row.update({"earlier_ms": EARLIER_MS[name], "earlier_from": EARLIER_FROM})
    emit(row)
    results.append(row)


def check_k2_adversarial(dev, results):
    """K2 on inputs made to break its tie rule and its lane groups, untimed:
    pixel and point coordinates on a quarter grid (so many candidates of one
    point share a d² exactly), every view a copy of the first (ties across
    views), windows at the four image borders and corners, k = 1, 3 and 32,
    a window of 7 and of 3, bf16 and f32 candidates. The plain version
    breaks a tie by the lower flat index, so the indices must be equal."""
    import torch

    gen = torch.Generator(device="cpu")
    gen.manual_seed(1)
    b, v, h, w, n = 2, 5, 120, 160, 4096
    img = torch.randint(0, 4, (b, 1, h, w, 3), generator=gen).float().div(4).expand(b, v, h, w, 3)
    pts = torch.randint(0, 4, (b, n, 3), generator=gen).float().div(4)
    for window in (7, 3):
        iu0 = torch.randint(0, w - window + 1, (b, v, n), generator=gen, dtype=torch.int32)
        iv0 = torch.randint(0, h - window + 1, (b, v, n), generator=gen, dtype=torch.int32)
        for j, (u, vv) in enumerate([(0, 0), (w - window, 0), (0, h - window), (w - window, h - window)]):
            iu0[:, :, j::64] = u  # corners, then every border
            iv0[:, :, j::64] = vv
        iu0[:, :, 4::64], iv0[:, :, 5::64] = 0, h - window
        args = [t.to(dev).contiguous() for t in (pts, img, iu0, iv0)]
        for dt in (torch.bfloat16, torch.float32):
            for k in (1, 3, 32):
                check_k2(f"k2_adv_w{window}_k{k}_{str(dt)[6:]}", args[0], args[1].to(dt).contiguous(),
                         args[2], args[3], window, k, results, timed=False)
        assert all(r["rows_differ"] == 0 for r in results[-6:]), "K2 broke an exact tie differently"


def check_k3(name, index, ns, c, gen, results, timed=True, rows32=None):
    """K3 against its plain version on one gather site: f32 rows, bf16 rows,
    and f32 rows with ``round_bf16`` as the default path hands them (held
    against ``segsum_plain(rows, round_bf16=True)``, the rounding done the
    way ``Tensor.to(torch.bfloat16)`` does it).

    The kernel sums a target's rows in row order, in slots and pieces, and
    the plain version in another order; two orders of n f32 terms differ by
    at most 2(n − 1)·2⁻²⁴·Σ|terms|. So each output
    element is held to 2⁻¹⁸·Σ|rows into its target| (the plain version on
    |rows|): a bound for targets of up to 33 rows, about the neighbor lists'
    length, and far above the usual error of the shadow row's thousands. A
    kernel that rounded rows it should not round to bf16 (2⁻⁹), or did not
    round rows it should, or dropped one, would exceed it at every site. The
    shadow row, which the kernel sums in pieces of ``LONG`` rows, is
    reported on its own. Nothing in the plan or the sum depends on the order
    in which atomics land, so a second call on the same plan and a call that
    builds its own plan give the same bits. With ``timed`` also device times:
    the call given the index's plan (``ms``: every gather VJP on a pyramid's
    neighbor tensor after the first), the plan's kernels alone, the call
    that builds its plan, the plain version, ``index_add_`` and, for the
    rounded rows, the cast the path ran before; and the replaced kernel's."""
    import torch
    from mvkpconv_tpu_torch.ops.kernels import segsum as k3

    if rows32 is None:
        rows32 = torch.randn(index.numel(), c, generator=gen, device=index.device)
    flat = (index.long() + torch.arange(index.shape[0], device=index.device)[:, None, None] * ns).reshape(-1)
    plans = k3.IndexPlans()  # the index's plan, built by the first call
    for rows, rnd in ((rows32, False), (rows32.to(torch.bfloat16), False), (rows32, True)):
        dt = str(rows.dtype)[6:] + ("_round" if rnd else "")
        got = k3.segsum(rows, index, ns, rnd, plans)
        assert torch.equal(got, k3.segsum(rows, index, ns, rnd, plans)), f"{name} {dt}: K3 not the same twice"
        assert torch.equal(got, k3.segsum(rows, index, ns, rnd)), f"{name} {dt}: K3 differs with a new plan"
        want = k3.segsum_plain(rows, index, ns, rnd)
        allowance = SEGSUM_REL * k3.segsum_plain(rows.abs(), index, ns, rnd) + 1e-30
        over = (got - want).abs() / allowance
        targets, shadow = float(over[:, :-1].max()), float(over[:, -1].max())
        err = float((got - want).abs().max())
        assert got.shape == want.shape and got.dtype == torch.float32, name
        assert bool(torch.isfinite(got).all()), f"{name} {dt}: K3 wrote a non-finite value"
        assert targets <= 1.0, f"{name} {dt}: K3 disagrees with its plain version ({targets} × the allowance)"
        assert shadow <= 1.0, f"{name} {dt}: K3's shadow row disagrees with its plain version ({shadow} × the allowance)"
        row = {
            "phase": f"{name}_{dt}", "b": index.shape[0], "nq": index.shape[1],
            "k": index.shape[2], "ns": ns, "c": c, "dtype": str(rows.dtype)[6:], "round_bf16": rnd,
            "shadow_rows": int((index == ns - 1).sum()), "max_abs_err": err,
            "err_over_allowance": targets, "shadow_err_over_allowance": shadow,
        }
        results.append(row)
        if not timed:
            emit(row)
            continue
        out = torch.zeros(index.shape[0] * ns, c, device=index.device)
        src = rows.float()  # index_add_ takes its source in the output's type
        row.update({
            "ms": device_ms(lambda: k3.segsum(rows, index, ns, rnd, plans)),
            "plan_ms": device_ms(lambda: k3.segsum_plan(index, ns)),
            "first_call_ms": device_ms(lambda: k3.segsum(rows, index, ns, rnd)),
            "call_ms": cuda_ms(lambda: k3.segsum(rows, index, ns, rnd, plans), reps=20),
            "plain_ms": device_ms(lambda: k3.segsum_plain(rows, index, ns, rnd)),
            # the one PyTorch call for the sum, on the rows' values in f32 (it
            # cannot round: on the rounded rows' instance it sums them as they are)
            "library_ms": device_ms(lambda: out.index_add_(0, flat, src)),
            # one add per row element, and the rounding
            **bound(nbytes(rows, index, got), (2.0 if rnd else 1.0) * rows.numel()),
        })
        earlier = EARLIER_MS.get(f"{name}_{'bfloat16' if rnd else dt}")
        if earlier is not None:
            row.update({"earlier_ms": earlier, "earlier_from": EARLIER_FROM})
        if rnd:
            # before, the path cast the cotangent to bf16 and K3 read that
            row["earlier_cast_ms"] = device_ms(lambda: rows.to(torch.bfloat16))
        emit(row)


def check_k3_adversarial(p_index, ns, dev, gen, results):
    """K3 off the bench's data, untimed, held like ``check_k3``: every row on
    one target (far more than ``LONG`` rows: pieces and their partials),
    every row on the shadow row, widths 1, 5, 35, 69 and 300 (output rows off
    a 16-byte boundary, scalar ends), rows that start 4 and 8 bytes past a
    16-byte boundary (a view into a larger tensor), K = 1."""
    import torch

    b, nq, k = p_index.shape
    one = torch.full_like(p_index, 7)
    check_k3("k3_adv_one_target", one, ns, 32, gen, results, timed=False)
    check_k3("k3_adv_all_shadow", torch.full_like(p_index, ns - 1), ns, 35, gen, results, timed=False)
    for c in (1, 5, 35, 69, 300):
        sub = p_index[:, :min(nq, max(64, 2**22 // (k * c)))].contiguous()
        check_k3(f"k3_adv_c{c}", sub, ns, c, gen, results, timed=False)
    for skip in (1, 2):  # 4 and 8 bytes past the boundary in f32
        big = torch.randn(p_index.numel() * 32 + skip, generator=gen, device=dev)
        rows = big[skip:].view(-1, 32)
        check_k3(f"k3_adv_offset{4 * skip}", p_index, ns, 32, gen, results, timed=False, rows32=rows)
    check_k3("k3_adv_k1", p_index[..., :1].contiguous(), ns, 64, gen, results, timed=False)


def check_deform_sites(dcfg, levels, calls, gen, k1_rows, k3_rows):
    """K1 and K3 where the deformable configuration hands them other inputs
    than the bench's, untimed: each selection at ``deform_radius`` (6.0
    cells against 2.5 at the same k: about 14x the ball, most of it
    dropped), and each deformed conv's gather VJP on those neighbor
    tensors, f32 rows 3 + Cin wide (odd widths, positions jointly with the
    bottleneck's features)."""
    from mvkpconv_tpu_torch.models.kpfcnn import plan_architecture
    from mvkpconv_tpu_torch.ops.pyramid import build_pyramid

    dspec = dcfg.pyramid_spec()
    bench = {name: tuple(call) for name, _, _, *call in calls}
    widened = [c for c in forward_k1_calls(dspec, levels) if tuple(c[3:]) != bench[c[0]]]
    assert {"k1_L3_conv", "k1_L3_pool", "k1_L4_conv"} <= {c[0] for c in widened}, widened
    for name, *call in widened:
        check_k1(f"{name}_deform", *call, k1_rows, timed=False)
    pyr = build_pyramid(levels[0][0], levels[0][1], dspec)
    enc, _, _ = plan_architecture(dcfg)
    sites = {(l, "strided" in name): out_dim // 4 + 3
             for name, _, out_dim, _, l, _ in enc if "deform" in name}
    for (l, strided), c in sorted(sites.items()):
        index = pyr.pools[l] if strided else pyr.neighbors[l]
        check_k3(f"k3_L{l}_{'strided' if strided else 'resnetb'}_deform", index, dcfg.num_points[l] + 1,
                 c, gen, k3_rows, timed=False)


def check_k4(name, q_pts, q_mask, s_pts, inds, cin, cout, radius, cfg, gen, results, timed=True, bwd_x=True):
    """The three K4 kernels against their plain versions at one conv site of
    the pyramid, f32 and bf16 features; with ``timed`` also their times.
    Without ``bwd_x`` the cotangent kernel is left out: a site whose input
    needs no gradient (an encoder's first block on the batch's own
    features) launches only the forward and ``wf``.

    Kernel and plain version add the same f32 terms in different orders (the
    plain version through PyTorch's batched and plain matrix products), and
    their influences may differ in the last bit, so each output element is
    held to 2⁻¹⁸ · Σ|terms| (the plain version on |features|, |weights|,
    |cotangent|): 64 units of f32 rounding, far below a bf16 (2⁻⁹) or TF32
    (2⁻¹¹) product. An influence is 1 − d/extent, so it carries an absolute
    error of a few 2⁻²⁴ whatever its size, and one version may give 0 where
    the other gives 1e-7: the allowance adds 2⁻²⁰ · Σ|terms with every
    influence set to 1|. Both are also judged against the plain version in
    float64.
    The weight gradient sums over all B·N queries in one matrix product on
    the kernel's ``wf``; it is held the same way. A shadow neighbor of a
    valid query gets a cotangent of exactly 0 (a padded query sits on its
    shadow neighbors, which is the influence-1 case). With bf16 features the
    cotangent is also taken as the main path takes it, written in bf16 by the
    kernel: held against the plain version's f32 result within the same
    allowance plus half a bf16 ulp of the value. All three kernels run twice
    and give the same bits."""
    import torch
    from mvkpconv_tpu_torch.models import blocks
    from mvkpconv_tpu_torch.models.kernel_points import kernel_point_positions
    from mvkpconv_tpu_torch.ops.gather import group_points, pad_shadow_row
    from mvkpconv_tpu_torch.ops.kernels import kpconv as k4

    dev = q_pts.device
    m = cfg.num_kernel_points
    extent = radius * cfg.kp_extent / cfg.conv_radius
    kp = torch.from_numpy(kernel_point_positions(radius, m)).to(dev)
    s_pad = torch.cat([s_pts, torch.full_like(s_pts[:, :1], 1e6)], dim=1)
    rel = (group_points(s_pad, inds) - q_pts[:, :, None, :]).contiguous()
    x = torch.randn(*s_pts.shape[:2], cin, generator=gen, device=dev)
    nx32 = group_points(pad_shadow_row(x), inds)
    w2d = torch.randn(m * cin, cout, generator=gen, device=dev) / (m * cin) ** 0.5
    g = torch.randn(*q_pts.shape[:2], cout, generator=gen, device=dev)
    b, n, k = inds.shape
    q = b * n
    infl = k4._influence(rel, kp, extent)
    nnz = float((infl > 0).sum())
    infl_ops = 12.0 * q * k * m  # 3 differences, their squares' sum, sqrt, divide, 1 − ·, max
    rel64, kp64, w64, g64 = rel.double(), kp.double(), w2d.double(), g.double()

    def over(got, want, allowance):
        return float(((got - want).abs() / (allowance + 1e-30)).max())

    shadow = (inds == s_pts.shape[1]) & q_mask[:, :, None]

    for nx in (nx32, nx32.to(torch.bfloat16)):
        dt = str(nx.dtype)[6:]
        a_nx, a_w, a_g = nx.float().abs(), w2d.abs(), g.abs()
        ones_wf = KPCONV_INFLUENCE_ABS * a_nx.sum(2).repeat(1, 1, m)  # (B, N, M·Cin)
        checks = {}
        # forward
        got = k4.kpconv_fused_fwd(rel, nx, kp, w2d, extent)
        want = k4.kpconv_fused_plain(rel, nx, kp, w2d, extent)
        ref = k4.kpconv_fused_plain(rel64, nx.double(), kp64, w64, extent)
        allow = KPCONV_REL * k4.kpconv_fused_plain(rel, a_nx, kp, a_w, extent) + torch.matmul(ones_wf, a_w)
        assert got.shape == (b, n, cout) and got.dtype == torch.float32, name
        again = k4.kpconv_fused_fwd(rel, nx, kp, w2d, extent)
        assert torch.equal(got, again), f"{name} {dt}: K4's forward differs from run to run"
        checks["fwd"] = (over(got, want, allow), over(got, ref, allow), over(want, ref, allow),
                         float((got - want).abs().max()))
        # the cotangent of the gathered features
        if bwd_x:
            got = k4.kpconv_fused_bwd_x(rel, g, kp, w2d, extent)
            want = k4.kpconv_fused_bwd_x_plain(rel, g, kp, w2d, extent)
            ref = k4.kpconv_fused_bwd_x_plain(rel64, g64, kp64, w64, extent)
            allow = KPCONV_REL * k4.kpconv_fused_bwd_x_plain(rel, a_g, kp, a_w, extent) + (
                KPCONV_INFLUENCE_ABS * torch.matmul(a_g, a_w.t()).reshape(b, n, m, cin).sum(2)[:, :, None, :])
            assert got.shape == (b, n, k, cin) and got.dtype == torch.float32, name
            assert bool((got[shadow] == 0).all()), f"{name}: shadow neighbors got a cotangent"
            again = k4.kpconv_fused_bwd_x(rel, g, kp, w2d, extent)
            assert torch.equal(got, again), f"{name} {dt}: K4's bwd_x differs from run to run"
            checks["bwd_x"] = (over(got, want, allow), over(got, ref, allow), over(want, ref, allow),
                               float((got - want).abs().max()))
        if bwd_x and nx.dtype == torch.bfloat16:
            got = k4.kpconv_fused_bwd_x(rel, g, kp, w2d, extent, out_dtype=nx.dtype)
            assert got.shape == (b, n, k, cin) and got.dtype == nx.dtype, name
            assert bool((got[shadow] == 0).all()), f"{name}: shadow neighbors got a bf16 cotangent"
            assert torch.equal(got, k4.kpconv_fused_bwd_x(rel, g, kp, w2d, extent, out_dtype=nx.dtype)), \
                f"{name}: K4's bf16 bwd_x differs from run to run"
            got = got.float()
            checks["bwd_x_bf16_out"] = (
                over(got, want, allow + BF16_HALF_ULP * want.abs()),
                over(got, ref, allow + BF16_HALF_ULP * ref.abs().float()),
                over(want.to(nx.dtype).float(), ref, allow + BF16_HALF_ULP * ref.abs().float()),
                float((got - want).abs().max()))
        # the weighted sums, and the weight gradient built on them
        got = k4.kpconv_wf(rel, nx, kp, extent)
        want = k4.kpconv_wf_plain(rel, nx, kp, extent)
        ref = k4.kpconv_wf_plain(rel64, nx.double(), kp64, extent)
        a_wf = k4.kpconv_wf_plain(rel, a_nx, kp, extent)
        allow = KPCONV_REL * a_wf + ones_wf
        assert got.shape == (b, n, m * cin) and got.dtype == torch.float32, name
        assert torch.equal(got, k4.kpconv_wf(rel, nx, kp, extent)), f"{name} {dt}: K4's wf differs from run to run"
        checks["wf"] = (over(got, want, allow), over(got, ref, allow), over(want, ref, allow),
                        float((got - want).abs().max()))
        allow = torch.matmul((KPCONV_REL * a_wf + ones_wf).reshape(q, -1).t(), a_g.reshape(q, -1))
        dw_want = torch.matmul(want.reshape(q, -1).t(), g.reshape(q, -1))
        dw_ref = torch.matmul(ref.reshape(q, -1).t(), g64.reshape(q, -1))
        del got, want, ref, a_wf, again
        dw = k4.weight_gradient(rel, nx, kp, g, extent)
        checks["dw"] = (over(dw, dw_want, allow), over(dw, dw_ref, allow), over(dw_want, dw_ref, allow),
                        float((dw - dw_want).abs().max()))
        for what, (vs_plain, vs_f64, plain_vs_f64, _) in checks.items():
            assert vs_plain <= 1.0, f"{name} {dt}: K4 {what} disagrees with its plain version ({vs_plain} × the allowance)"
            assert vs_f64 <= 1.0, f"{name} {dt}: K4 {what} is {vs_f64} × the allowance from float64"
        row = {
            "phase": f"{name}_{dt}", "b": b, "n": n, "k": k, "m": m, "cin": cin, "cout": cout,
            "dtype": dt, "influence_nonzero_share": nnz / (q * k * m),
            "shadow_neighbors": int(shadow.sum()), "padded_queries": int((~q_mask).sum()),
            **{f"{what}_err_over_allowance": v[0] for what, v in checks.items()},
            **{f"{what}_err_vs_f64_over_allowance": v[1] for what, v in checks.items()},
            **{f"{what}_plain_vs_f64_over_allowance": v[2] for what, v in checks.items()},
            **{f"{what}_max_abs_err": v[3] for what, v in checks.items()},
        }
        results.append(row)
        if not timed:
            emit(row)
            continue

        # times: kernels, plain versions, and the einsum chain on a prebuilt influence
        infl_c = infl.to(nx.dtype)
        w3 = w2d.reshape(m, cin, cout)
        nx_leaf = nx.clone().requires_grad_(bwd_x)
        w_leaf = w2d.clone().requires_grad_(True)
        w3_leaf = w3.clone().requires_grad_(True)

        def k4_fwd_bwd():
            out = k4.kpconv_fused(rel, nx_leaf, kp, w_leaf, extent)
            torch.autograd.grad(out, (nx_leaf, w_leaf)[not bwd_x:], g)

        def chain_fwd_bwd():
            out = blocks._contract(infl_c, nx_leaf, w3_leaf, nx.dtype)
            torch.autograd.grad(out, (nx_leaf, w3_leaf)[not bwd_x:], g)

        reps = 10
        fwd_in = nbytes(rel, nx, kp, w2d)
        row.update({
            "fwd": {
                "ms": cuda_ms(lambda: k4.kpconv_fused_fwd(rel, nx, kp, w2d, extent), reps),
                "plain_ms": cuda_ms(lambda: k4.kpconv_fused_plain(rel, nx, kp, w2d, extent), reps),
                "einsum_chain_ms": cuda_ms(lambda: blocks._contract(infl_c, nx, w3, nx.dtype), reps),
                **bound(fwd_in + 4 * q * cout, infl_ops + 2 * nnz * cin + 2.0 * q * m * cin * cout),
                "earlier_ms": EARLIER_MS.get(f"{name}_{dt}"), "earlier_from": EARLIER_FROM,
            },
            # the cotangent in the features' type, as the main path takes it
            **({"bwd_x": {
                "ms": cuda_ms(lambda: k4.kpconv_fused_bwd_x(rel, g, kp, w2d, extent, nx.dtype), reps),
                "f32_out_ms": cuda_ms(lambda: k4.kpconv_fused_bwd_x(rel, g, kp, w2d, extent), reps),
                "plain_ms": cuda_ms(lambda: k4.kpconv_fused_bwd_x_plain(rel, g, kp, w2d, extent, nx.dtype), reps),
                "out_dtype": dt,
                **bound(nbytes(rel, g, kp, w2d) + nx.element_size() * q * k * cin,
                        infl_ops + 2 * nnz * cin + 2.0 * q * m * cin * cout),
                "earlier_ms": EARLIER_MS.get(f"{name}_{dt}_bwd_x"),
                "earlier_from": EARLIER_FROM + ", f32 result",
            }} if bwd_x else {}),
            "wf": {
                "ms": cuda_ms(lambda: k4.kpconv_wf(rel, nx, kp, extent), reps),
                "plain_ms": cuda_ms(lambda: k4.kpconv_wf_plain(rel, nx, kp, extent), reps),
                **bound(nbytes(rel, nx, kp) + 4 * q * m * cin, infl_ops + 2 * nnz * cin),
                "earlier_ms": EARLIER_MS.get(f"{name}_{dt}_wf"), "earlier_from": EARLIER_FROM,
            },
            "dw_ms": cuda_ms(lambda: k4.weight_gradient(rel, nx, kp, g, extent), reps),
            "fwd_bwd_ms": cuda_ms(k4_fwd_bwd, reps),
            "einsum_chain_fwd_bwd_ms": cuda_ms(chain_fwd_bwd, reps),
        })
        emit(row)


def check_k4_shapes(dev, gen, results):
    """K4's three kernels off the bench shapes, untimed, held like
    ``check_k4``: more than 16 kernel points and more than 16 or 32 neighbors
    (several tiles and halves of the per-query products), a single neighbor,
    kernel point and channel, widths that are no multiple of a chunk (with
    a last chunk of 1, 2, 6 and 8 channels, which ``wf`` folds into the pass
    before it), and feature rows at 16-, 4- and 2-byte alignment (a column
    slice of a wider tensor; the cotangent's rows are Cin wide, so its stores
    meet them too),
    with shadow neighbors and padded queries, f32 and bf16; the cotangent in
    the features' type."""
    import torch
    from mvkpconv_tpu_torch.ops.kernels import kpconv as k4

    shapes = [  # queries, K, M, Cin, Cout, columns before the features
        (1000, 40, 20, 5, 7, 0), (77, 128, 32, 70, 33, 0), (300, 1, 1, 1, 1, 0), (513, 30, 15, 66, 64, 3),
        (200, 33, 17, 32, 32, 0), (4096, 30, 15, 33, 40, 1), (129, 8, 16, 31, 65, 0), (64, 100, 15, 128, 128, 0),
        (150, 20, 15, 40, 24, 0),
    ]
    extent = 1.2
    for q, k, m, cin, cout, before in shapes:
        rel = torch.randn(1, q, k, 3, generator=gen, device=dev) * 0.6
        far = torch.rand(q, 1, 1, generator=gen, device=dev) < 0.2
        rel[0, :, k // 2:] += far * 1e6  # shadow neighbors
        rel[0, ::7] = 0.0  # padded queries: every neighbor on the centre kernel point
        shadow = rel[..., 0] > 1e5
        kp = torch.randn(m, 3, generator=gen, device=dev) * 0.5
        kp[0] = 0.0
        w2d = torch.randn(m * cin, cout, generator=gen, device=dev) / (m * cin) ** 0.5
        wide = torch.randn(1, q, k, before + cin, generator=gen, device=dev)
        g = torch.randn(1, q, cout, generator=gen, device=dev)
        rel64, kp64, w64, a_w, a_g = rel.double(), kp.double(), w2d.double(), w2d.abs(), g.abs()
        for dt in (torch.float32, torch.bfloat16):
            nx = wide.to(dt)[..., before:]
            a_nx = nx.float().abs()
            ones_wf = KPCONV_INFLUENCE_ABS * a_nx.sum(2).repeat(1, 1, m)
            name = f"k4_shape_q{q}_k{k}_m{m}_{cin}to{cout}_ld{before + cin}_{str(dt)[6:]}"
            row = {"phase": name}
            runs = {
                "fwd": (lambda: k4.kpconv_fused_fwd(rel, nx, kp, w2d, extent),
                        k4.kpconv_fused_plain(rel, nx, kp, w2d, extent),
                        k4.kpconv_fused_plain(rel64, nx.double(), kp64, w64, extent),
                        KPCONV_REL * k4.kpconv_fused_plain(rel, a_nx, kp, a_w, extent) + torch.matmul(ones_wf, a_w)),
                "bwd_x": (lambda: k4.kpconv_fused_bwd_x(rel, g, kp, w2d, extent, out_dtype=dt),
                          k4.kpconv_fused_bwd_x_plain(rel, g, kp, w2d, extent),
                          k4.kpconv_fused_bwd_x_plain(rel64, g.double(), kp64, w64, extent),
                          KPCONV_REL * k4.kpconv_fused_bwd_x_plain(rel, a_g, kp, a_w, extent) + (
                              KPCONV_INFLUENCE_ABS
                              * torch.matmul(a_g, a_w.t()).reshape(1, q, m, cin).sum(2)[:, :, None, :])),
                "wf": (lambda: k4.kpconv_wf(rel, nx, kp, extent),
                       k4.kpconv_wf_plain(rel, nx, kp, extent),
                       k4.kpconv_wf_plain(rel64, nx.double(), kp64, extent),
                       KPCONV_REL * k4.kpconv_wf_plain(rel, a_nx, kp, extent) + ones_wf),
            }
            for part, (run, want, ref, allow) in runs.items():
                got = run()
                assert torch.equal(got, run()), f"{name}: {part} differs from run to run"
                if part == "bwd_x":
                    assert got.dtype == dt and bool((got[shadow] == 0).all()), f"{name}: shadow cotangent"
                    if dt == torch.bfloat16:  # the f32 sum rounded once
                        allow = allow + BF16_HALF_ULP * want.abs()
                got = got.float()
                allow = allow + 1e-30
                vs_plain = float(((got - want).abs() / allow).max())
                vs_f64 = float(((got - ref).abs() / allow).max())
                assert bool(torch.isfinite(got).all()) and vs_plain <= 1.0 and vs_f64 <= 1.0, \
                    (name, part, vs_plain, vs_f64)
                # a bf16 cotangent's distance is its rounding's: kept apart from the f32 sums'
                key = "bwd_x_bf16_out" if part == "bwd_x" and dt == torch.bfloat16 else part
                row.update({f"{key}_err_over_allowance": vs_plain, f"{key}_err_vs_f64_over_allowance": vs_f64,
                            f"{key}_max_abs_err": float((got - want).abs().max())})
            emit(row)
            results.append(row)


def is_conv(name):
    return "simple" in name or "resnetb" in name


def fed_raw(model):
    """1 where the model's first encoder block is a ``simple`` conv fed the
    batch's own features, which need no gradient (middle fusion's 3D stream,
    late fusion's only one, the 3D-only KPFCNN); 0 where it takes the lifted
    features (early fusion), which do."""
    first = model.encoders[0].plan[0][0]
    return {"early": 0, "middle": 1, "late": 1, "none": 1}[model.cfg.fusion] if "simple" in first else 0


def trunk_gathers(model):
    """Gathers of the trunk whose features need a gradient, from the plan:
    every conv block's neighbor gather (a deformable block's two: its
    offset conv's and its deformed conv's), the max-pool shortcut of each
    strided block, each upsample and max-pool block; not the first gather of
    an encoder fed the batch's own features (``fed_raw``)."""
    n = -fed_raw(model)
    for part in (*model.encoders, model.decoder):
        for name, *_ in part.plan:
            if is_conv(name):
                n += 1 + ("strided" in name) + ("deform" in name)
            elif "upsample" in name or "pool" in name:
                n += 1
    return n


def gather_vjp_widths(model, cached):
    """Row widths of the trunk's gather VJPs, one per K3 launch, from the
    plan: a conv block gathers its KPConv's input features (a resnetb block
    its bottleneck, a quarter of the block's width), jointly with the 3
    position columns where it has no cached influence (the fused path); a
    deformable block's deformed conv always gathers them jointly, its
    offset conv as a rigid block does; a strided block's shortcut and an
    upsample or pool block gather their input as it is; an encoder's first
    block fed the batch's own features (``fed_raw``) has no gather VJP."""
    widths = []
    for part in (*model.encoders, model.decoder):
        for i, (name, in_dim, out_dim, *_) in enumerate(part.plan):
            if i == 0 and part is model.encoders[0] and fed_raw(model):
                continue
            if is_conv(name):
                cin = in_dim if "simple" in name else out_dim // 4
                widths.append(cin + (0 if cached else 3))
                if "deform" in name:
                    widths.append(cin + 3)
                if "strided" in name:
                    widths.append(in_dim)
            elif "upsample" in name or "pool" in name:
                widths.append(in_dim)
    return sorted(widths)


def conv_blocks(model):
    """(rigid KPConv blocks of the trunk, those whose input features need a
    gradient) from the plan. The fused path launches one K4 forward and one
    ``wf`` per rigid block (a deformable block never reaches K4), and one
    ``bwd_x`` per such block whose input needs a gradient: all but a first
    block fed the batch's own features (``fed_raw``)."""
    total = sum(is_conv(e[0]) and "deform" not in e[0]
                for part in (*model.encoders, model.decoder) for e in part.plan)
    return total, total - fed_raw(model)


def deform_layers(model):
    from mvkpconv_tpu_torch.models.blocks import KPConvLayer

    return [m for m in model.modules() if isinstance(m, KPConvLayer) and m.deformable]


def regularizer(model, cfg):
    """The deformable regularizer of the model's last forward (0 without
    deformable layers)."""
    import torch
    from mvkpconv_tpu_torch.training.losses import deform_regularization

    with torch.no_grad():
        return float(deform_regularization(model, cfg.repulse_extent, cfg.deform_fitting_power))


def check_train_parity(phase, label, cfg, dev, resumed):
    """3 train steps on the card (kernels, gather VJP 'banded') against the
    CPU (plain versions) from the same weights, f32: each step's loss within
    1e-5 relative, every parameter after each step within rtol 1e-3, atol
    1e-5·(the largest |param|). With ``resumed`` the card takes the CPU's
    parameters, batch statistics and momentum before each step, so every
    step starts from one state; otherwise the two run free.

    The batch has no padded rows: a padded point's pixel-relation feature
    (~3e12) makes FeatureAggregation's unmasked BN statistics follow
    rounding (ROADMAP queue 3). At 5 levels the deep levels hold so few
    points that one leaky-ReLU input changing sign moves a gradient by
    percents, so free-running states part after the first step by more
    than rounding (tests/test_torch_train_deeper.py shows it on the CPU):
    that configuration is held step by step."""
    import numpy as np
    import torch
    from mvkpconv_tpu_torch.data.synthetic_batch import make_batch
    from mvkpconv_tpu_torch.infer import batch_to_device
    from mvkpconv_tpu_torch.train import make_trainer, train_steps

    cfg = cfg.replace(gather_transpose="banded")
    cpu_tr = make_trainer(cfg, "cpu", seed=1)
    gpu_tr = make_trainer(cfg, dev, seed=2)
    gpu_tr.model.load_state_dict(cpu_tr.model.state_dict())
    tb = make_batch(cfg, 2, np.random.RandomState(1))
    cpu_b, gpu_b = batch_to_device(tb, "cpu"), batch_to_device(tb, dev)
    reset_launches()
    for step in (1, 2, 3):
        if resumed:
            gpu_tr.model.load_state_dict(cpu_tr.model.state_dict())
            gpu_tr.optimizer.load_state_dict(copy.deepcopy(cpu_tr.optimizer.state_dict()))
        want = float(train_steps(cpu_tr, cpu_b, 1)[0]["loss"])
        got = float(train_steps(gpu_tr, gpu_b, 1)[0]["loss"])
        loss_rel = abs(got - want) / abs(want)
        reg_cpu, reg_card = regularizer(cpu_tr.model, cfg), regularizer(gpu_tr.model, cfg)
        params = [(name, p.detach(), q.detach().cpu()) for (name, p), q in
                  zip(cpu_tr.model.named_parameters(), gpu_tr.model.parameters())]
        atol = TRAIN_PARAM_ATOL_REL * max(float(p.abs().max()) for _, p, _ in params)
        over = {name: float(((q - p).abs() / (TRAIN_PARAM_RTOL * p.abs() + atol)).max())
                for name, p, q in params}
        worst = max(over, key=over.get)
        emit({"phase": phase, "config": f"{label}, f32, banded",
              "start": "the CPU's state" if resumed else "free-running", "step": step,
              "loss_card": got, "loss_cpu": want, "loss_rel_err": loss_rel,
              "regularizer_card": reg_card, "regularizer_cpu": reg_cpu,
              "param_err_over_allowance": over[worst], "worst_param": worst,
              "params_outside": sum(r > 1.0 for r in over.values()), "params": len(over),
              "launches": read_launches()})
        assert np.isfinite(got) and loss_rel <= TRAIN_LOSS_REL, "card/CPU train loss disagree"
        assert abs(reg_card - reg_cpu) <= REG_REL * abs(reg_cpu), "card/CPU regularizer disagree"
        assert (reg_cpu > 0) == bool(deform_layers(cpu_tr.model)), reg_cpu
        assert over[worst] <= 1.0, "card/CPU parameters disagree"
    launches = read_launches()
    n_conv, n_bwd_x = conv_blocks(gpu_tr.model)
    assert launches["segsum"] == 3 * trunk_gathers(gpu_tr.model), launches
    assert launches["kpconv_fused_fwd"] == launches["kpconv_wf"] == (3 * n_conv if runs_k4(cfg) else 0), launches
    assert launches["kpconv_fused_bwd_x"] == (3 * n_bwd_x if runs_k4(cfg) else 0), launches


def check_forward_parity(phase, label, cfg, dev, build=None):
    """The forward on the card (kernels) against the CPU (plain versions)
    from the same weights, f32, TF32 off, on a batch with padded rows:
    max |Δ logit| ≤ 1e-4 · max |logit| on valid points (every logit of a
    classifier, which has no point axis); with deformable layers the
    regularizer of the forward within 1e-5 relative; the card's launches
    held to the plan. ``build(cfg, device, seed)`` makes the model
    (default ``make_model``)."""
    import numpy as np
    import torch
    from mvkpconv_tpu_torch.data.synthetic_batch import make_batch
    from mvkpconv_tpu_torch.infer import batch_to_device, infer, make_model

    build = build or make_model
    cpu_model = build(cfg, "cpu", seed=1)
    gpu_model = build(cfg, dev, seed=2)
    gpu_model.load_state_dict(cpu_model.state_dict())
    sb = make_batch(cfg, 2, np.random.RandomState(1))
    sb["mask"][-1, -24:] = False
    sb["points"] = np.where(sb["mask"][..., None], sb["points"], np.float32(1e6))
    want = infer(cpu_model, batch_to_device(sb, "cpu"))
    reset_launches()
    got = infer(gpu_model, batch_to_device(sb, dev)).cpu()
    launches = read_launches()
    keep = torch.from_numpy(sb["mask"]) if got.dim() == 3 else torch.ones(got.shape[0], dtype=torch.bool)
    err = float((got - want).abs()[keep].max())
    scale = float(want.abs()[keep].max())
    reg_cpu, reg_card = regularizer(cpu_model, cfg), regularizer(gpu_model, cfg)
    emit({"phase": phase, "config": label, "logits_shape": list(got.shape), "max_abs_err": err,
          "max_abs_logit": scale, "limit": PARITY_REL * scale, "launches": launches,
          "deformable_layers": len(deform_layers(gpu_model)),
          "regularizer_card": reg_card, "regularizer_cpu": reg_cpu})
    assert got.shape == want.shape, (got.shape, want.shape)
    assert bool(torch.isfinite(got).all()) and err <= PARITY_REL * scale, "card/CPU logits disagree"
    assert abs(reg_card - reg_cpu) <= REG_REL * abs(reg_cpu), "card/CPU regularizer disagree"
    assert (reg_cpu > 0) == bool(deform_layers(cpu_model)), reg_cpu
    # the pyramid's selections: a conv per level, a pool and an upsample between two
    k1_calls = 3 * cfg.num_layers - 2
    assert launches["radius_topk"] == k1_calls and launches["radius_topk_device"] == 2 * k1_calls, launches
    assert launches["pixel_topk"] == (0 if cfg.fusion == "none" else 1), launches
    assert launches["kpconv_fused_fwd"] == (conv_blocks(gpu_model)[0] if runs_k4(cfg) else 0), launches


def runs_k4(cfg):
    """Whether the configuration's conv blocks reach the fused kernel: the
    flag, and no influence cache (a cache that exists wins)."""
    return bool(cfg.use_pallas_kpconv) and cfg.influence_cache == "none"


def kernel_counters():
    from mvkpconv_tpu_torch.ops.kernels import fps as p1
    from mvkpconv_tpu_torch.ops.kernels import kpconv as k4
    from mvkpconv_tpu_torch.ops.kernels import pixel_select as k2
    from mvkpconv_tpu_torch.ops.kernels import radius_topk as k1
    from mvkpconv_tpu_torch.ops.kernels import segsum as k3

    return {"radius_topk": k1.radius_topk, "pixel_topk": k2.pixel_topk, "segsum": k3.segsum,
            "segsum_plan": k3.segsum_plan,
            "kpconv_fused_fwd": k4.kpconv_fused_fwd, "kpconv_fused_bwd_x": k4.kpconv_fused_bwd_x,
            "kpconv_wf": k4.kpconv_wf, "farthest_point_sample": p1.farthest_point_sample}


def reset_launches():
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    counters["radius_topk"].device_launches = 0


def read_launches():
    """Each wrapper's count of calls that launched its kernel; K1 makes two
    device launches a call (the box pre-pass and the search), counted too."""
    counters = kernel_counters()
    return {**{name: fn.launches for name, fn in counters.items()},
            "radius_topk_device": counters["radius_topk"].device_launches}


def config_label(cfg, what=""):
    """The bench configuration's description, with what sets ``cfg`` apart."""
    label = f"bench.py:106-117{what} (B=4, N0=16384, K=30, V=5, 120x160, width 128, bf16"
    if cfg.fusion in ("middle", "late"):
        label = f"bench.py:106-117{what} with fusion={cfg.fusion!r} (B=4, N0=16384, K=30, V=5, 120x160, width 128, bf16"
    if cfg.fusion == "none":
        label = f"bench.py:106-117{what} as the 3D-only KPFCNN (fusion='none', in_features_dim=2; B=4, N0=16384, K=30, width 128, bf16"
    if any("deform" in b for b in cfg.architecture):
        label += ", blocks 9-13 deformable (their levels' neighbors within deform_radius 6.0)"
    label += ", use_pallas_kpconv=True, influence_cache='none'" if runs_k4(cfg) else ""
    return label + (", remat='blocks'" if cfg.remat == "blocks" else "") + ")"


def busy_row(fn):
    """Device busy ms of a call of ``fn`` and each hand-written kernel's
    share of it, named as ``profile_infer`` names them (``torch.profiler``,
    3 calls after a warm-up)."""
    from mvkpconv_tpu_torch.tools.profile_infer import OWN_KERNELS

    by = device_ms_by(fn, reps=3, names=[part for parts in OWN_KERNELS.values() for part in parts])
    return {"device_busy_ms": by["total"],
            "device_ms_by_kernel": {label: sum(by[part] for part in parts) for label, parts in OWN_KERNELS.items()}}


def run_full(phase, cfg, dev, batch, smi, beside=None, forwards=5, busy=False):
    """The inference slice at full width: a warm-up, then ``forwards`` timed
    forwards with every kernel's launches counted and held to the plan; with
    ``busy`` also the device's busy time a forward (``busy_row``)."""
    import torch
    from mvkpconv_tpu_torch.infer import infer, make_model

    model = make_model(cfg, dev, seed=0)
    logits = infer(model, batch)  # warm-up (cuDNN autotune, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(forwards):
        logits = infer(model, batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / forwards
    launches = read_launches()
    n_conv, _ = conv_blocks(model)
    assert tuple(logits.shape) == (cfg.batch_num, cfg.num_points[0], cfg.num_classes), logits.shape
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    assert launches["radius_topk"] == 13 * forwards, launches
    assert launches["radius_topk_device"] == 26 * forwards, launches
    assert launches["pixel_topk"] == (0 if cfg.fusion == "none" else forwards), launches
    assert launches["kpconv_fused_fwd"] == (n_conv * forwards if runs_k4(cfg) else 0), (launches, n_conv)
    assert launches["segsum"] == launches["kpconv_fused_bwd_x"] == launches["kpconv_wf"] == 0, launches
    row = {
        "phase": phase, "config": config_label(cfg), "forwards": forwards, "ms_per_forward": dt * 1e3,
        "points_per_s": cfg.batch_num * cfg.num_points[0] / dt, "launches": launches,
        "conv_blocks": n_conv,
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "logit_abs_max": float(logits.abs().max()), "card": smi,
    }
    if busy:
        row.update(busy_row(lambda: infer(model, batch)))
    if beside is not None:
        row["beside"] = {k: beside[k] for k in ("phase", "ms_per_forward", "points_per_s", "peak_mem_gib",
                                                "device_busy_ms") if k in beside}
    emit(row)
    return row, launches


def run_train_full(phase, cfg, dev, batch, smi, beside=None, steps=5, busy=False):
    """The train step at full width: a warm-up step, then ``steps`` timed
    steps; loss finite, every trainable tensor moved, ``net_2d`` (where the
    model has one) unchanged bit for bit, every kernel's launches held to the
    plan; with ``busy`` also the device's busy time a step (``busy_row``,
    after the checks). With deformable layers also: the regularizer finite and > 0, and
    the warm-up step's update of the offset parameters (``offset_conv``,
    ``offset_bias``) ``deform_lr_factor`` times the rest's: the least-squares
    step size −Δp·g / g·g of each group within 1e-3 of its learning rate."""
    import numpy as np
    import torch
    from mvkpconv_tpu_torch.ops import gather
    from mvkpconv_tpu_torch.train import make_trainer, train_steps

    trainer = make_trainer(cfg, dev, seed=0)
    net_2d = getattr(trainer.model, "net_2d", None)
    frozen = {} if net_2d is None else {k: v.clone() for k, v in net_2d.state_dict().items()}
    start = {n: p.detach().clone() for n, p in trainer.model.named_parameters() if not n.startswith("net_2d.")}
    loss_warmup = float(train_steps(trainer, batch, 1)[0]["loss"])  # warm-up (cuDNN autotune, allocator)
    deformable = bool(deform_layers(trainer.model))
    step_size = {}
    if deformable:
        for group in ("deform", "train"):
            num = den = 0.0
            for n, p in trainer.model.named_parameters():
                if n in start and ("offset_" in n) == (group == "deform"):
                    num += float(((start[n] - p.detach()) * p.grad).sum())
                    den += float((p.grad * p.grad).sum())
            step_size[group] = num / den
        lr = cfg.learning_rate
        assert abs(step_size["train"] / lr - 1) <= 1e-3, (step_size, lr)
        assert abs(step_size["deform"] / (lr * cfg.deform_lr_factor) - 1) <= 1e-3, (step_size, lr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    metrics = train_steps(trainer, batch, steps)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    launches = read_launches()
    # one more step, untimed, with the gather VJP's rows written down
    segsum, seen, handed = gather.segsum, [], set()

    def spy(rows, index, ns, round_bf16=False, plans=None):
        seen.append(rows.shape[1])
        handed.add((str(rows.dtype)[6:], round_bf16, plans is not None))
        return segsum(rows, index, ns, round_bf16, plans)

    gather.segsum = spy
    try:
        train_steps(trainer, batch, 1)
    finally:
        gather.segsum = segsum
    losses = [float(m["loss"]) for m in metrics]
    reg = regularizer(trainer.model, cfg)
    n_gathers = trunk_gathers(trainer.model)
    n_conv, n_bwd_x = conv_blocks(trainer.model)
    fused = runs_k4(cfg)
    changed = sum(not torch.equal(p.detach(), start[n]) for n, p in trainer.model.named_parameters()
                  if n in start)
    assert all(np.isfinite(losses)), losses
    assert np.isfinite(reg) and (reg > 0) == deformable, reg
    if net_2d is not None:
        assert all(torch.equal(v, frozen[k]) for k, v in net_2d.state_dict().items()), "net_2d moved"
    assert changed == len(start), f"{len(start) - changed} trainable parameters did not move"
    assert launches["segsum"] == n_gathers * steps, (launches, n_gathers)
    # a plan a neighbor tensor of the step (the pyramid's 3 L - 2), built on
    # its first gather VJP: fewer than the gather VJPs
    assert 0 < launches["segsum_plan"] <= (3 * cfg.num_layers - 2) * steps, launches
    assert launches["segsum_plan"] < launches["segsum"], launches
    cached = cfg.influence_cache != "none"
    assert sorted(seen) == gather_vjp_widths(trainer.model, cached), (sorted(seen), cached)
    # banded_bf16: every cotangent reaches K3 in f32 with the rounding asked
    # for, so no cast runs before it, and with its neighbor tensor's plans
    assert handed == {("float32", True, True)}, handed
    assert launches["radius_topk"] == 13 * steps, launches
    assert launches["pixel_topk"] == (0 if cfg.fusion == "none" else steps), launches
    assert launches["radius_topk_device"] == 26 * steps, launches
    # under remat='blocks' a block's forward runs again in the backward: K4's
    # forward twice a fused block; K3 still once a gather (the backward runs
    # the first forward's graph) with its plans, and wf / bwd_x once
    fwd_per_step = n_conv * (2 if cfg.remat == "blocks" else 1)
    assert launches["kpconv_fused_fwd"] == (fwd_per_step * steps if fused else 0), launches
    assert launches["kpconv_wf"] == (n_conv * steps if fused else 0), launches
    assert launches["kpconv_fused_bwd_x"] == (n_bwd_x * steps if fused else 0), (launches, n_bwd_x)
    row = {
        "phase": phase, "config": config_label(cfg, " train step, banded_bf16"), "steps": steps, "ms_per_step": dt * 1e3, "points_per_s": cfg.batch_num * cfg.num_points[0] / dt,
        "loss_warmup": loss_warmup, "losses": losses, "accuracy_last": float(metrics[-1]["accuracy"]),
        "launches": launches,
        "trunk_gathers_with_grad": n_gathers, "gather_vjp_row_widths": sorted(seen),
        "gather_vjp_rows": sorted(f"{d}{' round_bf16' if r else ''}" for d, r, _ in handed),
        "conv_blocks": n_conv, "conv_blocks_with_input_grad": n_bwd_x,
        "params_moved": changed, "deformable_layers": len(deform_layers(trainer.model)),
        "regularizer_last": reg, "step_size_by_group": step_size,
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30, "card": smi,
    }
    if busy:
        row.update(busy_row(lambda: train_steps(trainer, batch, 1)))
    if beside is not None:
        row["beside"] = {k: beside[k] for k in ("phase", "ms_per_step", "points_per_s", "peak_mem_gib",
                                                "device_busy_ms") if k in beside}
    emit(row)
    return row, launches


def check_deform_and_baselines(dev, batch, smi, small, full_row, train_row):
    """The deformable MV-KPConv and the 3D-only baselines: card against CPU
    at small configurations (forward, 3 train steps), then the deformable
    train step and the KPFCNN forward and train step at full width, each
    with its launch counts held to the plan. Returns the launches of the
    three full-width runs."""
    from mvkpconv_tpu_torch.infer import FUSED_OPTIONS, baseline_config, deform_config
    from mvkpconv_tpu_torch.models.kpfcnn import KPCNN
    from mvkpconv_tpu_torch.training.config import KPConfig
    from mvkpconv_tpu_torch.training.init import init_parameters

    deform_small = small.replace(
        architecture=("simple", "resnetb", "resnetb_strided", "resnetb_deformable",
                      "resnetb_deformable_strided", "resnetb_deformable",
                      "nearest_upsample", "unary", "nearest_upsample", "unary"),
        num_points=small.num_points[:3], conv_neighbors=small.conv_neighbors[:3],
        pool_neighbors=small.pool_neighbors[:2],
    )
    deform_label = "3 levels, the last two deformable, N0=1024, width 32"
    for modulated in (False, True):
        what = ", modulated" if modulated else ""
        check_forward_parity("parity_deform", f"MV-KPConv, {deform_label}, 3 views 24x32{what}, f32",
                             deform_small.replace(modulated=modulated), dev)
    check_train_parity("train_parity_deform", f"MV-KPConv, {deform_label}, 3 views 24x32",
                       deform_small, dev, resumed=True)
    # the modulated steps on the 3D-only trunk: with the lift, ReLU inputs in
    # FeatureAggregation that flip at rounding move a step by more than the
    # allowance (tests/test_torch_deformable.py, the lift's ReLU flips)
    check_train_parity("train_parity_deform", f"KPFCNN (fusion='none'), {deform_label}, modulated",
                       deform_small.replace(modulated=True, fusion="none", in_features_dim=2),
                       dev, resumed=True)
    base_small = small.replace(fusion="none", in_features_dim=2)
    base_label = "KPFCNN (fusion='none'), ARCHITECTURE_DEEPER, N0=1024, width 32"
    # the train steps at 3 levels: at 5, one leaky-ReLU input of the third
    # step that flips at rounding moves a tensor by ~2x the allowance
    # (tests/test_torch_baselines.py, the deeper trunk's flips)
    base_three = deform_small.replace(
        fusion="none", in_features_dim=2,
        architecture=tuple(b.replace("_deformable", "") for b in deform_small.architecture))
    for flags, what in (({}, ""), (FUSED_OPTIONS, ", K4")):
        check_forward_parity("parity_baseline", f"{base_label}, f32{what}", base_small.replace(**flags), dev)
        check_train_parity("train_parity_baseline", f"KPFCNN (fusion='none'), 3 levels, N0=1024, width 32{what}",
                           base_three.replace(**flags), dev, resumed=True)
    kpcnn = KPConfig(
        fusion="none", in_features_dim=2, num_classes=40, first_features_dim=32,
        architecture=("simple", "resnetb", "resnetb_strided", "resnetb", "resnetb_strided",
                      "resnetb", "global_average"),
        num_points=(1024, 256, 64), conv_neighbors=(16,) * 3, pool_neighbors=(16,) * 2,
    )

    def build_kpcnn(cfg, device, seed):
        return init_parameters(KPCNN(cfg), seed).to(device).eval()

    check_forward_parity("parity_kpcnn", "KPCNN, 3 levels, N0=1024, width 32, 40 classes, f32", kpcnn, dev,
                         build=build_kpcnn)

    base = baseline_config()
    return {
        "train_full_deform": run_train_full("train_full_deform", deform_config(), dev, batch, smi,
                                            beside=train_row)[1],
        "full_baseline": run_full("full_baseline", base, dev, batch, smi, beside=full_row)[1],
        "train_full_baseline": run_train_full("train_full_baseline", base, dev, batch, smi,
                                              beside=train_row)[1],
    }


def check_fusions(dev, batch, smi, small, small_label, early):
    """Middle fusion (two encoders over one pyramid and one influence cache,
    their skips concatenated) and late fusion (the lifted features joined
    before the head): card against CPU at ``small`` (the forward on the
    padded batch; 3 train steps, each from the CPU's state, and middle
    fusion's also on the fused path, where K4 runs in both encoders and
    ``bwd_x`` on ``encoder_2d``'s first block), then the forward and the
    train step at the bench configuration on the default path and, for
    middle fusion, on the fused one, each beside early fusion's row of the
    same path (``early``), launches held to the plan, device busy measured.
    Returns the full-width runs' (rows, launches)."""
    from mvkpconv_tpu_torch.infer import FUSED_OPTIONS, fusion_config

    for fusion in ("middle", "late"):
        cfg = small.replace(fusion=fusion)
        check_forward_parity("parity", f"{small_label}, f32, fusion={fusion}", cfg, dev)
        check_train_parity("train_parity", f"{small_label}, fusion={fusion}", cfg, dev, resumed=True)
    check_train_parity("train_parity_fused", f"{small_label}, fusion=middle, K4",
                       small.replace(fusion="middle", **FUSED_OPTIONS), dev, resumed=True)
    rows, paths = {}, {}
    for name, cfg, path in (("middle", fusion_config("middle"), ""), ("late", fusion_config("late"), ""),
                            ("middle_fused", fusion_config("middle").replace(**FUSED_OPTIONS), "_fused")):
        fwd, step = f"full_{name}", f"train_full_{name}"
        rows[fwd], paths[fwd] = run_full(fwd, cfg, dev, batch, smi, beside=early["full" + path], busy=True)
        rows[step], paths[step] = run_train_full(step, cfg, dev, batch, smi, beside=early["train_full" + path],
                                                 busy=True)
    # ARCHITECTURE_DEEPER's decoder has no conv block: two encoders launch K4 twice as often
    for phase, early_phase in (("full_middle_fused", "full_fused"), ("train_full_middle_fused", "train_full_fused")):
        for part in ("kpconv_fused_fwd", "kpconv_wf"):
            assert paths[phase][part] == 2 * early[early_phase]["launches"][part], (phase, part, paths[phase])
    return rows, paths


# ---- the training entry point (tools/train_scannet.py, tools/test_models.py)

def cli_config():
    """The configuration ``train_scannet --fusion early`` builds by default:
    MV-KPConv early fusion, ARCHITECTURE_DEEPER at width 128, B=5 spheres of
    N0=16384, K=34, 5 views of 120x160, f32."""
    from mvkpconv_tpu_torch.tools.train_scannet import default_config

    return default_config("early", 66)


class LaunchSplit:
    """Launches of the kernels, split between the Trainer's validations
    (and final snapshot) and the rest of the run (its train steps), by
    wrapping ``Trainer._validate_and_checkpoint``; the state each
    ``maybe_resume`` restored, cloned."""

    def __init__(self):
        from mvkpconv_tpu_torch.training.trainer import Trainer

        self.cls, self.validate, self.resume = Trainer, Trainer._validate_and_checkpoint, Trainer.maybe_resume
        self.val = dict.fromkeys(read_launches(), 0)
        self.val_calls = 0
        self.restored = []
        split = self

        def validate(trainer, step):
            before = read_launches()
            split.validate(trainer, step)
            split.val_calls += 1
            for k, v in read_launches().items():
                split.val[k] += v - before[k]

        def resume(trainer):
            split.resume(trainer)
            split.restored.append(copy.deepcopy(trainer.state_dict()))

        Trainer._validate_and_checkpoint, Trainer.maybe_resume = validate, resume

    def close(self):
        self.cls._validate_and_checkpoint, self.cls.maybe_resume = self.validate, self.resume

    def steps(self):
        return {k: v - self.val[k] for k, v in read_launches().items()}


def training_log_steps(run):
    return [int(line.split()[1]) for line in (run / "training.txt").read_text().splitlines()[1:]]


def same_state(got, want):
    """Whether two ``Trainer.state_dict()``s are equal bit for bit."""
    import torch

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
        if isinstance(a, dict):
            return isinstance(b, dict) and a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return a == b

    return same(got, want)


def check_train_scannet(dev, smi, tmp):
    """The training entry point at full width on the card: ``train_scannet``
    (4 steps, a validation and a checkpoint at step 2 and at the end), its
    resume to step 6, the frozen-2D run from a UNet checkpoint, then
    ``test_models`` on the run. Returns the launches by path."""
    import numpy as np
    import torch
    from mvkpconv_tpu_torch.data.spheres import SphereDataset, device_batch
    from mvkpconv_tpu_torch.infer import FUSED_OPTIONS, batch_to_device, make_model
    from mvkpconv_tpu_torch.models.unet2d import UNetResNet34
    from mvkpconv_tpu_torch.tools import test_models, train_scannet
    from mvkpconv_tpu_torch.tools.common import load_scenes
    from mvkpconv_tpu_torch.training.checkpoint import Checkpointer
    from mvkpconv_tpu_torch.training.init import init_parameters

    base = cli_config()
    cfg = base.replace(epoch_steps=2, validation_size=2 * base.batch_num)
    cfg_path = tmp / "parameters_cli.txt"
    cfg.save(cfg_path)
    run = tmp / "run"
    flags = ["--fusion", "early", "--data", "synthetic:2", "--val-data", "synthetic:1",
             "--config", str(cfg_path), "--output", str(run)]
    label = ("train_scannet --fusion early defaults (ARCHITECTURE_DEEPER, width 128, B=5, N0=16384, K=34, "
             "V=5, 120x160, f32, UNet trained) with epoch_steps=2, validation_size=10")
    split = LaunchSplit()
    try:
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer = train_scannet.main(flags + ["--steps", "4"])
        seconds = time.perf_counter() - t0
        steps_launches, val_launches, val_calls = split.steps(), dict(split.val), split.val_calls
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        meters = trainer.meters.meters
        losses = list(meters["loss"].values)
        step_ms = [1e3 * t for t in meters["time"].values]
        data_ms = [1e3 * t for t in meters["data"].values]
        vals = [json.loads(line) for line in (run / "scalars.jsonl").read_text().splitlines()]
        mious = [v["value"] for v in vals if v["tag"] == "val_miou"]
        ckpts = sorted(p.name for p in (run / "checkpoints").iterdir())
        assert training_log_steps(run) == [1, 2, 3, 4], training_log_steps(run)
        assert ckpts == ["ckpt_00000002.pt", "ckpt_00000004.pt", "last_checkpoint", "model_best.pt"], ckpts
        assert len(losses) == 4 and all(np.isfinite(losses)), losses
        assert len(mious) == val_calls == 3 and all(np.isfinite(mious)), (mious, val_calls)
        gathers = trunk_gathers(trainer.model)
        evals = val_calls * 2  # validation_size // batch_num batches a validation
        # a step: 13 selections (26 device launches), 1 pixel selection, a K3
        # sum a trunk gather, a plan a pyramid index tensor at most; an
        # evaluation forward: the same selections, no K3
        k1 = 3 * cfg.num_layers - 2
        assert steps_launches["radius_topk"] == k1 * 4 and val_launches["radius_topk"] == k1 * evals, (
            steps_launches, val_launches)
        assert steps_launches["radius_topk_device"] == 2 * k1 * 4, steps_launches
        assert steps_launches["pixel_topk"] == 4 and val_launches["pixel_topk"] == evals, (steps_launches, val_launches)
        assert steps_launches["segsum"] == gathers * 4 and val_launches["segsum"] == 0, (steps_launches, gathers)
        assert 0 < steps_launches["segsum_plan"] <= k1 * 4, steps_launches
        assert steps_launches["kpconv_fused_fwd"] == 0, steps_launches

        # the spheres those 4 steps took (the dataset replayed from its seed)
        # and the host's sampling time a batch
        t1 = time.perf_counter()
        scenes = load_scenes("synthetic:2", True, cfg.num_views, (cfg.image_height, cfg.image_width))
        load_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        ds = SphereDataset(scenes, trainer.cfg, training=True, seed=0)
        dataset_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        batches = [ds.sample_batch() for _ in range(4)]
        sample_ms = (time.perf_counter() - t1) / 4 * 1e3
        counts = ds.sphere_counts
        stage_ms = {k: 1e3 * sum(v) / 4 for k, v in ds.stage_times.items()}

        # resume: the same command to step 6
        trainer2 = train_scannet.main(flags + ["--steps", "6"])
        assert len(split.restored) == 2, len(split.restored)
        saved = torch.load(run / "checkpoints" / "ckpt_00000004.pt", map_location="cpu", weights_only=True)
        resumed = split.restored[1]
        assert resumed["step"] == saved["step"] == 4, (resumed["step"], saved["step"])
        assert same_state(resumed["model"], saved["model"]), "resumed model differs from the checkpoint"
        assert same_state(resumed["optimizer"], saved["optimizer"]), "resumed optimizer differs from the checkpoint"
        assert training_log_steps(run) == [1, 2, 3, 4, 5, 6], training_log_steps(run)
        assert trainer2.step == 6
    finally:
        split.close()
    # the device's busy time of a step, on the replayed batches
    tb = batch_to_device(device_batch(batches[0]), dev)
    busy_ms = device_ms(lambda: trainer2.train_step(tb), reps=3)
    emit({"phase": "train_scannet_full", "config": label, "seconds": seconds, "steps": 4,
          "ms_per_step": step_ms, "data_ms_per_step": data_ms,
          "ms_per_step_after_first": sum(step_ms[1:]) / 3, "data_ms_after_first": sum(data_ms[1:]) / 3,
          "device_busy_ms_per_step": busy_ms, "peak_mem_gib": peak, "losses": losses,
          "losses_finite": bool(all(np.isfinite(losses))), "val_miou": mious,
          "sphere_counts": counts, "points_per_sphere_budget": cfg.num_points[0],
          "budget_filled": float(np.mean(np.minimum(counts, cfg.num_points[0]))) / cfg.num_points[0],
          "host_sample_ms_per_batch": sample_ms, "host_stage_ms_per_batch": stage_ms,
          "scene_load_s": load_s, "dataset_setup_s": dataset_s,
          "launches_steps": steps_launches, "launches_validation": val_launches, "validations": val_calls,
          "launches_per_step": {k: steps_launches[k] / 4 for k in
                                ("radius_topk", "radius_topk_device", "pixel_topk", "segsum", "segsum_plan")},
          "trunk_gathers_with_grad": gathers, "checkpoints": ckpts, "card": smi})
    emit({"phase": "train_scannet_resume", "resumed_at": resumed["step"],
          "state_equal_bitwise": True, "training_txt_steps": training_log_steps(run),
          "losses_after_resume": list(trainer2.meters.meters["loss"].values)})

    # ---- the frozen 2D net from a UNet checkpoint (--path-2d), on the fused
    # KPConv path (--config with use_pallas_kpconv=True, influence_cache='none')
    unet = init_parameters(UNetResNet34(cfg.num_classes), seed=3)
    Checkpointer(tmp / "run2d" / "checkpoints").save({"step": 1, "model": unet.state_dict()}, 1)
    fused_path = tmp / "parameters_cli_fused.txt"
    cfg.replace(**FUSED_OPTIONS).save(fused_path)
    frozen_run = tmp / "frozen"
    reset_launches()
    frozen = train_scannet.main(["--fusion", "early", "--data", "synthetic:2", "--val-data", "synthetic:1",
                                 "--config", str(fused_path), "--output", str(frozen_run), "--steps", "2",
                                 "--path-2d", str(tmp / "run2d")])
    launches_frozen = read_launches()
    n_conv, n_bwd_x = conv_blocks(frozen.model)
    # 2 steps; 2 validations (step 2 and the final one) of 2 batches
    assert launches_frozen["kpconv_fused_fwd"] == n_conv * (2 + 4), (launches_frozen, n_conv)
    assert launches_frozen["kpconv_wf"] == n_conv * 2 and launches_frozen["kpconv_fused_bwd_x"] == n_bwd_x * 2, (
        launches_frozen, n_bwd_x)
    assert launches_frozen["radius_topk"] == k1 * 6 and launches_frozen["pixel_topk"] == 6, launches_frozen
    fresh = make_model(cfg, dev, seed=0)
    start = {n: p for n, p in fresh.named_parameters() if not n.startswith("net_2d.")}
    moved = [n for n, p in frozen.model.named_parameters() if n in start and not torch.equal(p, start[n])]
    got_2d = frozen.model.net_2d.state_dict()
    assert frozen.model.freeze_2d and frozen.step == 2
    assert all(torch.equal(v, got_2d[k].cpu()) for k, v in unet.state_dict().items()), "net_2d moved"
    assert len(moved) == len(start), f"{len(start) - len(moved)} parameters outside net_2d did not move"
    emit({"phase": "train_scannet_frozen", "config": "the same, use_pallas_kpconv=True, influence_cache='none', "
          "--path-2d (a seeded UNet checkpoint)", "steps": frozen.step, "net_2d_equal_bitwise": True,
          "params_moved": len(moved), "params_outside_net_2d": len(start),
          "losses": list(frozen.meters.meters["loss"].values), "launches": launches_frozen})

    # ---- the voting test of the run
    reset_launches()
    t0 = time.perf_counter()
    ev, full = test_models.main(["--run", str(run), "--data", "synthetic:1", "--votes", "0.5"])
    seconds = time.perf_counter() - t0
    launches_test = read_launches()
    forwards = launches_test["pixel_topk"]
    assert np.isfinite(ev.miou) and np.isfinite(full.miou), (ev.miou, full.miou)
    assert forwards > 0 and launches_test["radius_topk"] == k1 * forwards, launches_test
    assert launches_test["segsum"] == launches_test["segsum_plan"] == 0, launches_test
    emit({"phase": "test_models", "votes": 0.5, "seconds": seconds, "forwards": forwards,
          "miou_subsampled": ev.miou, "miou_full_resolution": full.miou,
          "oa_full_resolution": full.overall_accuracy, "launches": launches_test})
    return {"train_scannet": steps_launches, "train_scannet_validation": val_launches,
            "train_scannet_frozen_fused": launches_frozen, "test_models": launches_test}


def check_trainer_parity(dev, small, tmp):
    """2 ``Trainer`` steps on the card (kernels) against the CPU (plain
    versions): ``small``'s configuration with the UNet trained end to end,
    the same seeded weights and the same ``SphereDataset`` seed, f32, TF32
    off, gather VJP 'banded'. Each step's loss within 1e-5 relative; every
    parameter and statistic after the 2 steps within rtol 1e-3, atol
    1e-5·(the largest |param|). The dataset runs on the numpy host ops, the
    batches this check was set on: the native ops list voxels in another
    order, and on their first batches the UNet's statistics follow rounding
    (a 1e-7 weight jitter moves them by 28x that allowance on the CPU alone:
    ``tests/test_torch_trainer.py::
    test_unfrozen_trainer_steps_follow_rounding_on_the_native_ops_batches``)."""
    import numpy as np
    import torch
    from mvkpconv_tpu_torch.data.spheres import SphereDataset, device_batch
    from mvkpconv_tpu_torch.tools.common import load_scenes
    from mvkpconv_tpu_torch.train import make_trainer
    from mvkpconv_tpu_torch.training.trainer import Trainer

    cfg = small.replace(gather_transpose="banded", epoch_steps=100)
    scenes = load_scenes("synthetic:1", True, cfg.num_views, (cfg.image_height, cfg.image_width))
    sides = {}
    for name, device, seed in (("cpu", "cpu", 1), ("card", dev, 2)):
        setup = make_trainer(cfg, device, seed=seed, freeze_2d=False)
        if name == "card":
            setup.model.load_state_dict(sides["cpu"][1])
        start = copy.deepcopy(setup.model.state_dict())
        with numpy_host_ops():
            ds = SphereDataset(scenes, cfg, training=True, seed=0)
        trainer = Trainer(setup.step, setup.model, setup.optimizer, str(tmp / f"parity_{name}"), cfg)
        reset_launches()
        trainer.fit((device_batch(b) for b in ds.batches()), max_steps=2)
        sides[name] = (trainer, start, read_launches(), ds.sphere_counts[:2 * cfg.batch_num])
    cpu, card = sides["cpu"][0], sides["card"][0]
    losses = {k: list(t.meters.meters["loss"].values) for k, t in (("cpu", cpu), ("card", card))}
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses["card"], losses["cpu"])]
    want, got = cpu.model.state_dict(), card.model.state_dict()
    atol = TRAIN_PARAM_ATOL_REL * max(float(v.abs().max()) for k, v in want.items() if v.is_floating_point())
    over = {k: float(((got[k].cpu() - v).abs() / (TRAIN_PARAM_RTOL * v.abs() + atol)).max())
            for k, v in want.items() if v.is_floating_point()}
    outside = {k: r for k, r in over.items() if r > 1.0}
    worst = max(over, key=over.get)
    emit({"phase": "trainer_parity", "config": f"ARCHITECTURE_DEEPER, N0={cfg.num_points[0]}, width "
          f"{cfg.first_features_dim}, {cfg.num_views} views {cfg.image_height}x{cfg.image_width}, B={cfg.batch_num} "
          "real spheres, f32, banded, UNet trained", "losses_card": losses["card"], "losses_cpu": losses["cpu"],
          "loss_rel_err": loss_rel, "sphere_counts": sides["cpu"][3],
          "state_err_over_allowance": over[worst], "worst": worst, "outside": outside,
          "tensors": len(over), "launches_card": sides["card"][2]})
    assert len(loss_rel) == 2 and max(loss_rel) <= TRAIN_LOSS_REL, "card/CPU Trainer losses disagree"
    assert not outside, "card/CPU Trainer states disagree"


# ARCHITECTURE_DEEPER cut to 3 levels (the blocks of its first three, and two
# upsamples back), for middle fusion's run of the CLIs
THREE_LEVELS = ("simple", "resnetb", "resnetb_strided", "resnetb", "resnetb_strided", "resnetb",
                "nearest_upsample", "unary", "nearest_upsample", "unary")


def check_cli_fusions(dev, smi, tmp):
    """``train_scannet`` → ``test_models`` for late fusion at the CLI's
    default configuration (width 128, B=5, N0=16384, K=34, 5 views of
    120x160, f32, the UNet trained) and for middle fusion at the same
    configuration cut to 3 levels; each cut to 2 steps (``epoch_steps=2``),
    a validation of one batch (``validation_size`` = B) at step 2 and the
    final one, then the voting test of the run at 0.5 votes. The launches
    of steps, validations and the test held to the plan; the run's
    ``parameters.txt`` and last checkpoint restored into a fresh model equal
    the trained one bit for bit (middle fusion's ``encoder_3d`` /
    ``encoder_2d`` scopes); ms and data ms a step, device busy a step on a
    batch of the run's dataset, peak memory. Returns the launches by path."""
    import numpy as np
    import torch
    from mvkpconv_tpu_torch.data.spheres import SphereDataset, device_batch
    from mvkpconv_tpu_torch.infer import batch_to_device, make_model
    from mvkpconv_tpu_torch.tools import test_models, train_scannet
    from mvkpconv_tpu_torch.tools.common import load_scenes
    from mvkpconv_tpu_torch.training.config import KPConfig
    from mvkpconv_tpu_torch.training.jax_checkpoint import restore_run

    paths = {}
    for fusion, cut in (("late", {}), ("middle", {"architecture": THREE_LEVELS})):
        base = train_scannet.default_config(fusion, 66)
        cfg = base.replace(epoch_steps=2, validation_size=base.batch_num, **cut)
        cfg_path = tmp / f"parameters_cli_{fusion}.txt"
        cfg.save(cfg_path)
        run = tmp / f"run_{fusion}"
        split = LaunchSplit()
        try:
            reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            trainer = train_scannet.main(["--fusion", fusion, "--data", "synthetic:2", "--val-data", "synthetic:1",
                                          "--config", str(cfg_path), "--output", str(run), "--steps", "2"])
            seconds = time.perf_counter() - t0
            steps, val, val_calls = split.steps(), dict(split.val), split.val_calls
        finally:
            split.close()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        meters = trainer.meters.meters
        losses = list(meters["loss"].values)
        mious = [v["value"] for v in map(json.loads, (run / "scalars.jsonl").read_text().splitlines())
                 if v["tag"] == "val_miou"]
        k1, gathers = 3 * cfg.num_layers - 2, trunk_gathers(trainer.model)
        assert training_log_steps(run) == [1, 2] and trainer.step == 2, training_log_steps(run)
        assert not trainer.model.freeze_2d and trainer.model.cfg.fusion == fusion
        assert len(losses) == 2 and all(np.isfinite(losses)), losses
        assert val_calls == len(mious) == 2 and all(np.isfinite(mious)), (val_calls, mious)
        assert steps["radius_topk"] == 2 * k1 and val["radius_topk"] == val_calls * k1, (steps, val)
        assert steps["radius_topk_device"] == 4 * k1, steps
        assert steps["pixel_topk"] == 2 and val["pixel_topk"] == val_calls, (steps, val)
        assert steps["segsum"] == 2 * gathers and val["segsum"] == 0, (steps, gathers)
        assert 0 < steps["segsum_plan"] <= 2 * k1, steps
        assert steps["kpconv_fused_fwd"] == 0, steps
        # the run read back as test_models reads it
        loaded = KPConfig.load(run / "parameters.txt")
        assert (loaded.fusion, loaded.architecture, loaded.num_layers) == (fusion, cfg.architecture, cfg.num_layers)
        fresh = make_model(loaded, dev, seed=7)
        restored_step, restored_from = restore_run(fresh, run / "checkpoints")
        want = trainer.model.state_dict()
        got = fresh.state_dict()
        assert restored_step == 2 and got.keys() == want.keys(), (restored_step, restored_from)
        assert all(torch.equal(v, want[k]) for k, v in got.items()), "the restored model differs from the trained one"
        scopes = sorted({k.split(".")[0] for k in want})
        assert ({"encoder_3d", "encoder_2d"} <= set(scopes)) == (fusion == "middle"), scopes
        del fresh, got
        # the device's busy time of a step, on a batch of the run's dataset
        scenes = load_scenes("synthetic:2", True, cfg.num_views, (cfg.image_height, cfg.image_width))
        tb = batch_to_device(device_batch(SphereDataset(scenes, trainer.cfg, training=True, seed=0).sample_batch()),
                             dev)
        busy_ms = device_ms(lambda: trainer.train_step(tb), reps=3)
        del trainer, tb
        reset_launches()
        t0 = time.perf_counter()
        ev, full = test_models.main(["--run", str(run), "--data", "synthetic:1", "--votes", "0.5"])
        test_s = time.perf_counter() - t0
        launches_test = read_launches()
        forwards = launches_test["pixel_topk"]
        assert np.isfinite(ev.miou) and np.isfinite(full.miou), (ev.miou, full.miou)
        assert forwards > 0 and launches_test["radius_topk"] == k1 * forwards, launches_test
        assert launches_test["segsum"] == launches_test["kpconv_fused_fwd"] == 0, launches_test
        emit({"phase": f"train_scannet_{fusion}",
              "config": f"train_scannet --fusion {fusion} defaults{' at 3 levels' if cut else ''} (width 128, B=5, "
                        "N0=16384, K=34, V=5, 120x160, f32, UNet trained), 2 steps, epoch_steps=2, validation_size=5",
              "seconds": seconds, "ms_per_step": [1e3 * t for t in meters["time"].values],
              "data_ms_per_step": [1e3 * t for t in meters["data"].values], "device_busy_ms_per_step": busy_ms,
              "peak_mem_gib": peak, "losses": losses, "val_miou": mious, "validations": val_calls,
              "launches_steps": steps, "launches_validation": val, "trunk_gathers_with_grad": gathers,
              "restored": {"step": restored_step, "file": restored_from.name, "state_equal_bitwise": True,
                           "scopes": scopes}, "card": smi})
        emit({"phase": f"test_models_{fusion}", "votes": 0.5, "seconds": test_s, "forwards": forwards,
              "miou_subsampled": ev.miou, "miou_full_resolution": full.miou,
              "oa_full_resolution": full.overall_accuracy, "launches": launches_test})
        paths.update({f"train_scannet_{fusion}": steps, f"train_scannet_{fusion}_validation": val,
                      f"test_models_{fusion}": launches_test})
    return paths


# ---- the mvpnet fork's workflow (tools/train_2d, test_2d, train_mvpnet,
# test_mvpnet, precompute_2d): K2 and K3 at the shapes the MVPNet path gives them

PN2_LEVELS = ((2048, 0.1), (512, 0.2), (128, 0.4), (32, 0.8))  # PN2SSG's centroids and radii


def chunk_scenes(num_views, hw):
    from mvkpconv_tpu_torch.tools.common import load_scenes

    return load_scenes("synthetic:2", True, num_views, hw)


def mvpnet_batch(dev, scenes, b=4, n=8192, num_views=3, seed=0):
    """A ``ChunkDataset`` batch as ``train_mvpnet`` hands it to its step (its
    defaults: 4 chunks of 8192 points, 3 views), on ``dev``."""
    from mvkpconv_tpu_torch.data.chunks import ChunkDataset
    from mvkpconv_tpu_torch.infer import batch_to_device
    from mvkpconv_tpu_torch.tools.train_mvpnet import chunk_batch

    ds = ChunkDataset(scenes, num_points=n, num_views=num_views, seed=seed)
    return batch_to_device(chunk_batch(ds.sample_batch(b), False), dev)


def pn2_index_ops(points):
    """The index tensors one PN2SSG forward builds from (B, N, 3) points —
    per set-abstraction level the FPS (kernel P1) and the ball query of its
    centroids, per propagation level the 3-NN — and the time of each call
    (CUDA events around the calls)."""
    from mvkpconv_tpu_torch.ops.gather import batch_index_select
    from mvkpconv_tpu_torch.ops.neighbors import ball_query, knn
    from mvkpconv_tpu_torch.ops.sampling import farthest_point_sample

    xyz, levels = points, [points]
    times = {"fps": [], "ball_query": [], "knn": []}
    sa, fp = [], []
    for m, r in PN2_LEVELS:
        times["fps"].append(cuda_ms(lambda: farthest_point_sample(xyz, m), reps=5, warmup=1))  # noqa: B023
        new = batch_index_select(xyz, farthest_point_sample(xyz, m))
        times["ball_query"].append(cuda_ms(lambda: ball_query(new, xyz, r, 32), reps=3, warmup=1))  # noqa: B023
        sa.append((ball_query(new, xyz, r, 32), xyz.shape[1]))
        xyz = new
        levels.append(xyz)
    for i in range(len(PN2_LEVELS)):
        dense, sparse = levels[-2 - i], levels[-1 - i]
        times["knn"].append(cuda_ms(lambda: knn(dense, sparse, 3), reps=3, warmup=1))  # noqa: B023
        fp.append((knn(dense, sparse, 3)[0], sparse.shape[1]))
    return times, sa, fp, levels


def precompute_k2_inputs(dev):
    """K2's inputs in ``precompute_2d`` at its defaults (a ``train_2d`` run's
    ``KPConfig``): one synthetic scene with the frames the CLI renders for
    it, its points subsampled as ``attach_precomputed_features`` does, and
    per point chunk (``POINT_CHUNK``) the points and window anchors; the
    first chunk and the last, padded with points at the origin. Returns
    (window, k, [(name, points, image_xyz, iu0, iv0, real points)])."""
    import numpy as np
    import torch
    from mvkpconv_tpu_torch.data.spheres import grid_subsample_np
    from mvkpconv_tpu_torch.eval.precompute import POINT_CHUNK
    from mvkpconv_tpu_torch.ops.unproject import project_to_views, unproject_depth, window_anchors
    from mvkpconv_tpu_torch.tools.common import load_scenes
    from mvkpconv_tpu_torch.training.config import KPConfig

    cfg = KPConfig()
    scene = load_scenes("synthetic:1", True, max(cfg.num_views, 8), (cfg.image_height, cfg.image_width))[0]
    pts, _, _ = grid_subsample_np(scene["points"], scene["colors"], scene["labels"],
                                  cfg.first_subsampling_dl, cfg.num_classes)
    as_t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)[None]  # noqa: E731
    intr, poses = as_t(scene["intrinsics"]), as_t(scene["poses"])
    image_xyz = unproject_depth(as_t(scene["depth"]), intr, poses)[0].contiguous()
    v, h, w = image_xyz.shape[1:4]
    window, k = cfg.pixel_window, min(cfg.pixel_knn, v * cfg.pixel_window**2)
    last = (len(pts) - 1) // POINT_CHUNK * POINT_CHUNK
    out = []
    for name, start in (("first", 0), ("padded_tail", last)):
        real = len(pts[start:start + POINT_CHUNK])
        chunk = as_t(np.pad(pts[start:start + POINT_CHUNK], ((0, POINT_CHUNK - real), (0, 0)))).contiguous()
        u, vv = project_to_views(chunk, intr, poses)
        out.append((name, chunk, image_xyz, window_anchors(u, w, window).contiguous(),
                    window_anchors(vv, h, window).contiguous(), real))
    return window, k, out


FPS_EARLIER_MS = "258-394 ms a forward (the eager loop before P1, PERF.md section 5)"


def check_fps(name, points, num_samples, rows, mask=None, timed=True, plan=None, **extra):
    """P1 against its plain version (the eager loop) on the same inputs:
    the indices equal; the plan (CTAs a cluster, threads a CTA, points a
    thread: ``fps.plan(N)`` through the operator, or ``plan`` given to
    ``fps.launch``); timed, kernel and plain ms (CUDA events), the bound
    (the points read once and the indices written once at 3.35 TB/s, or
    9·B·N·S operations at 67 TFLOP/s), the dependent steps (S − 1 argmaxes
    over the cloud, the serial chain that sets the real floor), µs a step,
    and the kernel's device ms and µs a step (``torch.profiler``)."""
    import torch
    from mvkpconv_tpu_torch.ops.kernels import fps

    b, n, _ = points.shape
    got = (fps.farthest_point_sample(points, num_samples, mask) if plan is None
           else fps.launch(points, num_samples, mask, plan))
    torch.cuda.synchronize()
    want = fps.farthest_point_sample_plain(points, num_samples, mask)
    differ = int((got != want).sum())
    row = {"phase": name, "b": b, "n": n, "s": num_samples, "masked": 0 if mask is None else int((~mask).sum()),
           "plan": (plan or fps.plan(n))._asdict(), "serial_steps": num_samples - 1, "indices_differ": differ,
           "max_abs_err": float(differ), **extra}
    if timed:
        row["ms"] = cuda_ms(lambda: fps.farthest_point_sample(points, num_samples, mask), reps=10)
        row["plain_ms"] = cuda_ms(lambda: fps.farthest_point_sample_plain(points, num_samples, mask), reps=2,
                                  warmup=1)
        row.update(bound(nbytes(points, got) + (0 if mask is None else nbytes(mask)), 9 * b * n * num_samples))
        row["us_per_step"] = row["ms"] * 1e3 / max(num_samples - 1, 1)
        # the kernel alone: at the small levels the call's ms is the wrapper's host time
        row["device_ms"] = device_ms_by(lambda: fps.farthest_point_sample(points, num_samples, mask), reps=10,
                                        names=("fps_kernel",))["fps_kernel"]
        row["device_us_per_step"] = row["device_ms"] * 1e3 / max(num_samples - 1, 1)
    emit(row)
    rows.append(row)
    assert differ == 0, f"{name}: {differ} indices differ from the plain version"


def time_fps_plans(name, points, num_samples, smi):
    """P1 under every plan a built instance takes for these points (1 CTA
    with 1, 2, 4 or 8 points a thread, 2, 4 or 8 CTAs with 8; the fewest
    threads that cover a CTA's range; no CTA left empty): indices equal to
    the plain version, the kernel's device ms and µs a step, and the plan
    ``fps.plan`` picks."""
    import torch
    from mvkpconv_tpu_torch.ops.kernels import fps

    b, n, _ = points.shape
    want = fps.farthest_point_sample_plain(points, num_samples)
    plans = []
    for c, k in fps.INSTANCES:
        pl = fps.layout(n, c, k)
        if k == 0 or pl.threads > fps.MAX_THREADS or (c - 1) * pl.span >= n:
            continue
        assert torch.equal(fps.launch(points, num_samples, None, pl), want), f"{name}: {pl} differs"
        ms = device_ms_by(lambda: fps.launch(points, num_samples, None, pl), reps=10,  # noqa: B023
                          names=("fps_kernel",))["fps_kernel"]
        plans.append({"clusters": c, "threads": pl.threads, "points": k, "device_ms": ms,
                      "device_us_per_step": ms * 1e3 / max(num_samples - 1, 1), "chosen": pl == fps.plan(n)})
    emit({"phase": name, "b": b, "n": n, "s": num_samples, "plans": plans,
          "fastest": min(plans, key=lambda r: r["device_ms"]), "card": smi})


def boundary_duplicates(n, b, g, dev):
    """Uniform points with copies of 4 far corners on both sides of every
    boundary of P1's plan for ``n`` (each rank's and each warp's first point
    and the point before it), a corner a boundary in turn: equal keys meet
    across ranks and lanes, and the lowest index must win."""
    import torch
    from mvkpconv_tpu_torch.ops.kernels import fps

    pts = torch.rand(b, n, 3, generator=g, device=dev)
    corners = torch.tensor([[4, 4, 4], [-4, -4, 4], [4, -4, -4], [-4, 4, -4]], dtype=torch.float32, device=dev)
    for j, i in enumerate(i for i in fps.plan(n).warp_starts() if i > 0):
        pts[:, i - 1:i + 1] = corners[j % len(corners)]
    return pts


def check_fps_adversarial(dev, rows):
    """P1, untimed, on inputs made to break it: a padded tail masked out (at
    the shadow coordinate, a different length per cloud), more samples than
    points (index 0 repeats), exact ties (coordinates on a quarter grid, so
    every d² is exact and many equal: the lowest index must win), N = 20,000
    (the scratch path before the cluster plan, now 8 CTAs of 320 threads),
    unmasked and masked; then copies of far corners on every CTA and warp
    boundary of the plan (N = 8,192 and 2,049), N not a multiple of the
    plan's CTAs x threads (8,191, 2,049 and the least N of each cluster
    size), only point 0 valid in an 8-CTA cloud, 2 x 100,000 points (the
    scratch array: 8 CTAs x 1024 threads, warps striding), and every
    built instance of the kernel (``fps.INSTANCES``) on ragged N through
    ``fps.launch``. Asserts that
    the operator's own plans used every cluster size and the scratch
    array."""
    import torch
    from mvkpconv_tpu_torch.ops.kernels import fps

    g = torch.Generator(device=dev)
    g.manual_seed(1)
    pts = torch.rand(4, 8192, 3, generator=g, device=dev)
    tail = torch.tensor([[1500], [1], [0], [4096]], device=dev)
    mask = torch.arange(8192, device=dev)[None] < 8192 - tail
    padded = torch.where(mask[..., None], pts, torch.full_like(pts, 1e6))
    check_fps("fps_adv_padded_tail", padded, 2048, rows, mask=mask, timed=False)
    check_fps("fps_adv_more_samples", pts[:, :100].contiguous(), 300, rows, timed=False)
    grid = torch.randint(0, 8, (4, 8192, 3), generator=g, device=dev).float() * 0.25
    check_fps("fps_adv_ties", grid, 2048, rows, timed=False)
    check_fps("fps_adv_scratch_path", torch.rand(2, 20000, 3, generator=g, device=dev), 256, rows, timed=False)
    masked = torch.rand(2, 20000, generator=g, device=dev) > 0.5
    masked[:, 0] = True
    check_fps("fps_adv_scratch_path_masked", torch.rand(2, 20000, 3, generator=g, device=dev), 256, rows,
              mask=masked, timed=False)
    for n in (8192, 2049):
        check_fps(f"fps_adv_ties_across_ranks_{n}", boundary_duplicates(n, 4, g, dev), 512, rows, timed=False)
    first_of_size = {}  # the least N the plan gives each cluster size (ragged for every size but 1)
    for n in range(1, fps.REGISTER_POINTS + 1):
        first_of_size.setdefault(fps.plan(n).clusters, n)
    for n in sorted({8191, 2049} | {n for c, n in first_of_size.items() if c > 1}):
        check_fps(f"fps_adv_ragged_{n}", torch.rand(4, n, 3, generator=g, device=dev), 512, rows, timed=False)
    only0 = torch.zeros(4, 8192, dtype=torch.bool, device=dev)
    only0[:, 0] = True
    check_fps("fps_adv_only_point_0", pts, 64, rows, mask=only0, timed=False)
    check_fps("fps_adv_scratch_100k", torch.rand(2, 100000, 3, generator=g, device=dev), 256, rows, timed=False)
    used = {(r["plan"]["clusters"], r["plan"]["points"]) for r in rows}
    assert {c for c, _ in used} == set(fps.CLUSTER_SIZES) and any(k == 0 for _, k in used), used
    for c, k in fps.INSTANCES:
        n = c * 64 * (k or 16) - 7
        check_fps(f"fps_adv_instance_c{c}_k{k}", torch.rand(2, n, 3, generator=g, device=dev), 64, rows,
                  timed=False, plan=fps.Plan(n, c, 64 if k else 256, k))


def check_mvpnet_kernels(dev, gen, scenes, smi, k2_rows, k3_rows, p1_rows):
    """K2, K3 and P1 where the MVPNet path hands them other inputs than the
    bench's (P1 at PN2SSG's four levels, then ``check_fps_adversarial``): K2 at ``MVPNet3D``'s selection (4 chunks of 8192 points, 3 views
    of 120x160, window 9, k = 3, f32 candidates), timed; K3 at the SA0
    feature gather (ball-query index (4, 2048, 32) into 8192 targets, 64
    wide), the FP3 interpolation gather (3-NN index (4, 8192, 3) into 2048
    targets, 128 wide) and a ball query with heavy padding (radius 0.025 at
    SA0's centroids: most rows repeat the centroid's own index), each with
    f32, bf16 and rounded rows, timed, the call that builds its own plan
    (as every PN2 gather VJP does: no pyramid attaches one) beside the sum
    given the plan; K2 at ``precompute_2d``'s selection (one scene's
    frames, a 4,096-point chunk, timed, and the last chunk, whose padding
    points sit at the origin, untimed). Returns the index ops' times and
    the precompute's K2 shapes."""
    from mvkpconv_tpu_torch.ops.neighbors import ball_query
    from mvkpconv_tpu_torch.ops.unproject import project_to_views, unproject_depth, window_anchors

    batch = mvpnet_batch(dev, scenes)
    p = batch["points"]
    image_xyz, _ = unproject_depth(batch["depth"], batch["intrinsics"], batch["poses"])
    u, v = project_to_views(p, batch["intrinsics"], batch["poses"])
    h, w = image_xyz.shape[2:4]
    check_k2("k2_mvpnet_float32", p, image_xyz.contiguous(), window_anchors(u, w, 9).contiguous(),
             window_anchors(v, h, 9).contiguous(), 9, 3, k2_rows)
    window, k, chunks = precompute_k2_inputs(dev)
    for name, chunk, xyz, iu0, iv0, real in chunks:
        check_k2(f"k2_precompute_{name}", chunk, xyz, iu0, iv0, window, k, k2_rows, timed=name == "first",
                 real_points=real)
    assert chunks[-1][-1] < chunks[-1][1].shape[1], "the scene's last chunk is not padded"
    pre_shapes = {(tuple(c[1].shape), tuple(c[2].shape), window, k) for c in chunks}
    times, sa, fp, levels = pn2_index_ops(p)
    per_forward = {k: sum(t) for k, t in times.items()}
    emit({"phase": "pn2_index_ops", "points": list(p.shape), "levels": [list(x.shape) for x in levels],
          "ms": times, "ms_per_forward": per_forward, "timing": "CUDA events around each call",
          "fps_earlier": FPS_EARLIER_MS, "card": smi})
    # P1 at PN2SSG's four set-abstraction levels, then on adversarial inputs
    for i, ((m, _radius), level) in enumerate(zip(PN2_LEVELS, levels)):
        check_fps(f"fps_sa{i}", level.contiguous(), m, p1_rows)
    for i, ((m, _radius), level) in enumerate(zip(PN2_LEVELS, levels)):
        time_fps_plans(f"fps_plans_sa{i}", level.contiguous(), m, smi)
    check_fps_adversarial(dev, p1_rows)
    emit({"phase": "fps_forward_sum", "levels": len(PN2_LEVELS),
          **{x: sum(r[x] for r in p1_rows[:len(PN2_LEVELS)])
             for x in ("ms", "device_ms", "plain_ms", "bound_ms", "serial_steps")},
          "card": smi})
    check_k3("k3_pn2_sa0", sa[0][0], sa[0][1], 64, gen, k3_rows)
    check_k3("k3_pn2_fp3", fp[3][0], fp[3][1], 128, gen, k3_rows)
    padded = ball_query(levels[1], p, 0.025, 32)
    repeats = float((padded[..., 1:] == padded[..., :1]).float().mean())
    check_k3("k3_pn2_padded", padded, p.shape[1], 64, gen, k3_rows)
    emit({"phase": "k3_pn2_padded_index", "radius": 0.025, "repeated_entries": repeats,
          "targets_hit": int((padded[0].reshape(-1).bincount(minlength=p.shape[1]) > 0).sum()),
          "largest_target_rows": int(padded[0].reshape(-1).bincount().max())})
    assert repeats > 0.5, repeats
    return per_forward, pre_shapes


def val_mious(run):
    return [rec["value"] for line in (run / "scalars.jsonl").read_text().splitlines()
            if (rec := json.loads(line))["tag"] == "val_miou"]


def trainer_row(trainer, seconds, peak):
    meters = trainer.meters.meters
    step_ms = [1e3 * t for t in meters["time"].values]
    data_ms = [1e3 * t for t in meters["data"].values]
    return {"seconds": seconds, "steps": trainer.step, "ms_per_step": step_ms, "data_ms_per_step": data_ms,
            "ms_per_step_after_first": sum(step_ms[1:]) / max(len(step_ms) - 1, 1),
            "data_ms_after_first": sum(data_ms[1:]) / max(len(data_ms) - 1, 1),
            "losses": list(meters["loss"].values), "peak_mem_gib": peak}


def run_cli(main, argv, dev):
    """``main(argv)`` with every kernel's launches split between the
    Trainer's validations and the rest; returns (result, seconds, peak GiB,
    launches of the rest, launches of the validations, validations)."""
    import torch

    split = LaunchSplit()
    try:
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return (out, seconds, torch.cuda.max_memory_allocated(dev) / 2**30, split.steps(), dict(split.val),
                split.val_calls)
    finally:
        split.close()


def check_mvpnet_workflow(dev, smi, tmp, scenes, index_ms, pre_shapes):
    """The mvpnet fork's workflow at the CLIs' defaults on the card, as a
    user runs it: ``train_2d`` (B=8 frames of 120x160, lr 5e-3, f32; 3 steps
    and its full-frame validation sweep and checkpoint), ``test_2d`` on that
    run (the trainer's last ``val_miou`` within 1e-6), ``train_mvpnet`` (B=4
    chunks of 8192 points, 3 views of 120x160, PN2SSG at the published
    widths, the UNet frozen; 3 steps, the 4-batch validation, a checkpoint;
    ``net_2d`` bit-equal to its seeded weights, every other tensor moved),
    ``test_mvpnet`` (the sliding chunks, stride 0.5, over one scene),
    ``train_mvpnet --no-images`` (the PN2 baseline) and ``precompute_2d``
    from the 2D run (one scene, 4,096-point chunks). Launches held to the
    plan: a step of MVPNet K2 once and K3 8 times, each sum with a plan of
    its own (SA0–SA3 feature gathers, FP0–FP3 interpolation gathers; the
    xyz gathers take no gradient), 7 for the baseline (SA0 gathers the
    input colors); K2 once a forward elsewhere, once a chunk in the
    precompute, there at the shapes ``check_mvpnet_kernels`` held it at
    (``pre_shapes``); K1 and K4 never. Returns the launches by path."""
    import math

    import numpy as np
    import torch
    from mvkpconv_tpu_torch.data.chunks import Frames2DDataset
    from mvkpconv_tpu_torch.infer import batch_to_device, make_model
    from mvkpconv_tpu_torch.ops import unproject
    from mvkpconv_tpu_torch.tools import precompute_2d, test_2d, test_mvpnet, train_2d, train_mvpnet
    from mvkpconv_tpu_torch.tools.common import load_scenes

    never = ("radius_topk", "kpconv_fused_fwd", "kpconv_fused_bwd_x", "kpconv_wf")

    # ---- train_2d, then test_2d on its run
    run2d = tmp / "train_2d_run"
    trainer, seconds, peak, launches_2d, val_2d, vals = run_cli(
        train_2d.main, ["--data", "synthetic:2", "--output", str(run2d), "--steps", "3"], dev)
    mious = val_mious(run2d)
    assert trainer.step == 3 and vals == 1 and len(mious) == 1 and np.isfinite(mious[0]), (trainer.step, mious)
    assert (run2d / "checkpoints" / "model_best.pt").exists() and any((run2d / "panels").iterdir())
    assert not any(launches_2d.values()) and not any(val_2d.values()), (launches_2d, val_2d)
    cfg2d = trainer.cfg
    frames = Frames2DDataset(load_scenes("synthetic:2", True, cfg2d.num_views,
                                         (cfg2d.image_height, cfg2d.image_width)), seed=0)
    fb = batch_to_device(frames.sample_batch(cfg2d.batch_num), dev)
    busy = device_ms(lambda: trainer.train_step(fb), reps=3)
    t0 = time.perf_counter()
    ev = test_2d.main(["--run", str(run2d), "--data", "synthetic:2"])
    test_seconds = time.perf_counter() - t0
    emit({"phase": "train_2d_full", "config": "train_2d defaults (UNet-ResNet34, B=8 frames of 120x160, lr 5e-3, "
          "momentum 0.9, f32) on synthetic:2, 3 steps", **trainer_row(trainer, seconds, peak),
          "device_busy_ms_per_step": busy, "val_miou": mious, "test_2d_miou": ev.miou,
          "test_2d_seconds": test_seconds, "test_2d_labelled_pixels": int(ev.confusion.sum()),
          "launches": launches_2d, "card": smi})
    assert abs(ev.miou - mious[-1]) <= 1e-6, (ev.miou, mious[-1])

    # ---- train_mvpnet, then test_mvpnet on its run
    runm = tmp / "train_mvpnet_run"
    trainer, seconds, peak, steps_l, val_l, vals = run_cli(
        train_mvpnet.main, ["--data", "synthetic:2", "--output", str(runm), "--steps", "3"], dev)
    mious = val_mious(runm)
    per_forward = trainer.cfg.batch_num  # test_mvpnet's chunks a forward
    assert trainer.step == 3 and vals == 1 and np.isfinite(mious).all(), (trainer.step, mious)
    assert steps_l["pixel_topk"] == 3 and steps_l["segsum"] == steps_l["segsum_plan"] == 8 * 3, steps_l
    assert val_l["pixel_topk"] == 4 and val_l["segsum"] == val_l["segsum_plan"] == 0, val_l
    # P1 once a set-abstraction level, a step and a validation forward
    assert steps_l["farthest_point_sample"] == 4 * 3 and val_l["farthest_point_sample"] == 4 * 4, (steps_l, val_l)
    assert not any(steps_l[k] + val_l[k] for k in never), (steps_l, val_l)
    fresh = make_model(trainer.cfg, dev, seed=0, kind="mvpnet")
    got_2d, start = trainer.model.net_2d.state_dict(), fresh.state_dict()
    assert all(torch.equal(v, start[f"net_2d.{k}"]) for k, v in got_2d.items()), "net_2d moved"
    outside = [n for n, _ in fresh.named_parameters() if not n.startswith("net_2d.")]
    now = dict(trainer.model.named_parameters())
    moved = sum(not torch.equal(now[n], start[n]) for n in outside)
    assert moved == len(outside), f"{len(outside) - moved} parameters outside net_2d did not move"
    mb = mvpnet_batch(dev, scenes)
    busy = device_ms_by(lambda: trainer.train_step(mb), reps=3, names=("fps_kernel",))
    row = trainer_row(trainer, seconds, peak)
    emit({"phase": "train_mvpnet_full", "config": "train_mvpnet defaults (MVPNet3D: UNet-ResNet34 frozen, "
          "FeatureAggregation 64, PN2SSG centroids 2048/512/128/32, radii 0.1-0.8, 32 neighbors; B=4 chunks "
          "of 8192 points, 3 views of 120x160, f32) on synthetic:2, 3 steps", **row,
          "device_busy_ms_per_step": busy["total"], "fps_device_ms_per_step": busy["fps_kernel"],
          "fps_share_of_busy": busy["fps_kernel"] / busy["total"],
          "fps_share_of_step": busy["fps_kernel"] / row["ms_per_step_after_first"],
          "earlier_ms_per_step": "306-600 (the eager FPS before P1, PERF.md section 5)",
          "val_miou": mious, "index_ops_ms_per_forward": index_ms,
          "launches_steps": steps_l, "launches_validation": val_l,
          "launches_per_step": {k: steps_l[k] / 3 for k in ("pixel_topk", "segsum", "segsum_plan",
                                                            "farthest_point_sample")},
          "net_2d_equal_bitwise": True, "params_moved": moved, "params_outside_net_2d": len(outside),
          "card": smi})
    reset_launches()
    t0 = time.perf_counter()
    ev, per_scene = test_mvpnet.main(["--run", str(runm), "--data", "synthetic:1"])
    seconds = time.perf_counter() - t0
    launches_test = read_launches()
    chunks = per_scene[0]["chunks"]
    assert launches_test["pixel_topk"] == math.ceil(chunks / per_forward), (launches_test, chunks)
    assert launches_test["farthest_point_sample"] == 4 * launches_test["pixel_topk"], launches_test
    assert launches_test["segsum"] == 0 and not any(launches_test[k] for k in never), launches_test
    assert np.isfinite(ev.miou) and per_scene[0]["coverage"] > 0.5, (ev.miou, per_scene)
    emit({"phase": "test_mvpnet", "stride": 0.5, "scenes": 1, "chunks": chunks,
          "forwards": math.ceil(chunks / per_forward),
          "seconds": seconds, "coverage": per_scene[0]["coverage"], "miou": ev.miou, "launches": launches_test})

    # ---- the 3D-only PointNet++ baseline
    trainer, seconds, peak, pn2_l, pn2_val, vals = run_cli(
        train_mvpnet.main, ["--data", "synthetic:2", "--output", str(tmp / "train_pn2_run"), "--steps", "3", "--no-images"],
        dev)
    assert trainer.step == 3 and np.isfinite(trainer.meters.meters["loss"].values).all()
    assert pn2_l["pixel_topk"] == 0 and pn2_l["segsum"] == pn2_l["segsum_plan"] == 7 * 3, pn2_l
    assert pn2_l["farthest_point_sample"] == 4 * 3, pn2_l
    assert pn2_val["pixel_topk"] == pn2_val["segsum"] == 0 and not any(pn2_l[k] for k in never), pn2_val
    emit({"phase": "train_pn2_full", "config": "train_mvpnet --no-images (PN2SSG on the points' colors, the "
          "same sizes)", **trainer_row(trainer, seconds, peak), "val_miou": val_mious(tmp / "train_pn2_run"),
          "launches_steps": pn2_l, "launches_validation": pn2_val, "card": smi})

    # ---- precompute_2d from the 2D run, K2's inputs recorded at each launch
    shapes = []
    pixel_topk = unproject.pixel_topk

    def recorded(points, image_xyz, iu0, iv0, window, k):
        shapes.append((tuple(points.shape), tuple(image_xyz.shape), window, k))
        return pixel_topk(points, image_xyz, iu0, iv0, window, k)

    unproject.pixel_topk = recorded
    try:
        reset_launches()
        t0 = time.perf_counter()
        cached = precompute_2d.main(["--run", str(run2d), "--data", "synthetic:1", "--out", str(tmp / "f.pkl")])
        seconds = time.perf_counter() - t0
        launches_pre = read_launches()
    finally:
        unproject.pixel_topk = pixel_topk
    feat = cached[0]["feature_2d3d"]
    n = len(cached[0]["points"])
    assert feat.shape == (n, 64) and np.isfinite(feat).all() and np.abs(feat).max() > 0, feat.shape
    assert launches_pre["pixel_topk"] == math.ceil(n / 4096) == len(shapes) and launches_pre["segsum"] == 0, \
        (launches_pre, len(shapes))
    assert launches_pre["farthest_point_sample"] == 0, launches_pre
    # the shapes check_mvpnet_kernels held K2 at, first and padded chunk
    assert set(shapes) == pre_shapes, (set(shapes), pre_shapes)
    emit({"phase": "precompute_2d", "points": n, "chunks": len(shapes), "frames": shapes[0][1][1],
          "k2_inputs": {"points": list(shapes[0][0]), "image_xyz": list(shapes[0][1]), "window": shapes[0][2],
                        "k": shapes[0][3]},
          "feature_shape": list(feat.shape), "seconds": seconds, "launches": launches_pre})
    return {"train_2d": launches_2d, "train_mvpnet": steps_l, "train_mvpnet_validation": val_l,
            "test_mvpnet": launches_test, "train_pn2": pn2_l, "precompute_2d": launches_pre}


# Each trained tensor's update, card against CPU: ‖Δcard − ΔCPU‖ / ‖ΔCPU‖.
# Sound steps follow rounding (PN2SSG's max over a centroid's neighbors):
# the port on the CPU against itself under a weight jitter of 1e-7 / 1e-6 /
# 1e-5 moves its worst tensor by 0.0099 / 0.037 / 0.088 (MVPNet) and
# 0.0035 / 0.012 / 0.053 (PN2); a planted fault (a tensor's gradient or a
# gather's VJP zeroed) by 1.0 or more. The limit sits between.
LEAF_UPDATE_REL = 0.25


def update_gaps(cpu_state, gpu_state, start, trained):
    """Per trained tensor ‖Δcard − ΔCPU‖ / ‖ΔCPU‖ of one step from ``start``,
    and the same over all of them as one vector."""
    import torch

    leaf, num, den = {}, [], []
    for n in trained:
        want, got = cpu_state[n] - start[n], gpu_state[n] - start[n]
        leaf[n] = float((got - want).norm() / want.norm().clamp(min=1e-30))
        num.append((got - want).ravel())
        den.append(want.ravel())
    return leaf, float(torch.cat(num).norm() / torch.cat(den).norm())


def assert_updates_agree(kind, leaf):
    worst = max(leaf, key=leaf.get)
    assert leaf[worst] <= LEAF_UPDATE_REL, f"card/CPU {kind} updates disagree at {worst} ({leaf[worst]})"


def check_mvpnet_parity(dev, smi):
    """MVPNet3D and PN2SSG on the card (K2, K3) against the CPU (plain
    versions), f32, TF32 off, the same weights, dropout 0 (the two devices'
    generators differ), on 2 chunks of 1024 points with 3 views of 24x32
    and PN2SSG's centroids cut to (256, 64, 16, 4): the eval forward's
    logits within 1e-4·max|logit|; 3 train steps (gather VJP 'banded'),
    each from the CPU's state: each loss within 1e-5 relative, the BN
    statistics within rtol 1e-3, atol 1e-5·(the largest |value|), the frozen
    ``net_2d`` unchanged bit for bit, and each trained tensor's update
    within ``LEAF_UPDATE_REL`` of the CPU's norm of it. The update is not
    held element by element: PN2SSG's max over a centroid's 32 neighbors
    picks another neighbor where two lie within rounding, and the port on
    the CPU against itself under a 1e-7 weight jitter moves single
    parameters by 31.5x (MVPNet) and 10.8x (PN2) phase 8's allowance
    (tests/test_torch_mvpnet_train.py::test_updates_follow_rounding_in_the_port,
    ROADMAP queue 3). Two planted faults must fail the same check: step 1
    on the card with the smallest trained tensor's gradient zeroed, and
    with the first gather VJP of the backward (K3's sum) zeroed. The
    launches: K2 once a forward of MVPNet3D, K3 8 sums a step (7 for the
    baseline, whose SA0 gathers the input colors), each with its own
    plan."""
    import numpy as np
    import torch
    from mvkpconv_tpu_torch.data.chunks import ChunkDataset
    from mvkpconv_tpu_torch.infer import batch_to_device, infer
    from mvkpconv_tpu_torch.models.mvpnet3d import MVPNet3D
    from mvkpconv_tpu_torch.models.pn2 import PN2SSG
    from mvkpconv_tpu_torch.ops import gather
    from mvkpconv_tpu_torch.tools.train_mvpnet import chunk_batch
    from mvkpconv_tpu_torch.training.config import KPConfig
    from mvkpconv_tpu_torch.training.init import init_parameters
    from mvkpconv_tpu_torch.training.optim import make_optimizer
    from mvkpconv_tpu_torch.training.steps import make_train_step

    small = dict(num_centroids=(256, 64, 16, 4), dropout=0.0)
    cfg = KPConfig(gather_transpose="banded", learning_rate=0.05)
    ds = ChunkDataset(chunk_scenes(3, (24, 32)), num_points=1024, num_views=3, use_color_feature=True, seed=2)
    raw = ds.sample_batch(2)
    by_path = {}
    for kind, build, sums, frozen in (("mvpnet", lambda: MVPNet3D(20, **small), 8, ("net_2d",)),
                                      ("pn2", lambda: PN2SSG(20, in_channels=3, **small), 7, ())):
        batch = chunk_batch(raw, no_images=kind == "pn2")
        cpu_b, gpu_b = batch_to_device(batch, "cpu"), batch_to_device(batch, dev)
        cpu = init_parameters(build(), 1).eval()
        gpu = build().to(dev).eval()
        gpu.load_state_dict(cpu.state_dict())
        want = infer(cpu, cpu_b)
        reset_launches()
        got = infer(gpu, gpu_b).cpu()
        launches = read_launches()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        emit({"phase": f"parity_{kind}", "config": "2 chunks of 1024 points, 3 views of 24x32, PN2SSG centroids "
              "(256, 64, 16, 4), f32, TF32 off", "logits_shape": list(got.shape), "max_abs_err": err,
              "max_abs_logit": scale, "limit": PARITY_REL * scale, "launches": launches})
        assert bool(torch.isfinite(got).all()) and err <= PARITY_REL * scale, f"card/CPU {kind} logits disagree"
        assert launches["pixel_topk"] == (1 if kind == "mvpnet" else 0) and launches["segsum"] == 0, launches

        cpu.train()
        gpu.train()
        cpu_opt = make_optimizer(cpu, cfg, frozen_prefixes=frozen)
        gpu_opt = make_optimizer(gpu, cfg, frozen_prefixes=frozen)
        cpu_step, gpu_step = make_train_step(cpu, cfg, cpu_opt), make_train_step(gpu, cfg, gpu_opt)
        trained = [n for n, _ in cpu.named_parameters() if not n.startswith(frozen)]
        first = None  # (start, optimizer state, CPU state after) of step 1, for the planted faults
        reset_launches()
        for step in (1, 2, 3):
            gpu.load_state_dict(cpu.state_dict())
            gpu_opt.load_state_dict(copy.deepcopy(cpu_opt.state_dict()))
            start = {k: v.clone() for k, v in cpu.state_dict().items()}
            opt_start = copy.deepcopy(cpu_opt.state_dict())
            want = float(cpu_step(cpu_b)["loss"])
            got = float(gpu_step(gpu_b)["loss"])
            loss_rel = abs(got - want) / abs(want)
            cpu_state = cpu.state_dict()
            gpu_state = {k: v.cpu() for k, v in gpu.state_dict().items()}
            if first is None:
                first = (start, opt_start, {k: v.clone() for k, v in cpu_state.items()})
            leaf, gap = update_gaps(cpu_state, gpu_state, start, trained)
            scale = max(float(v.abs().max()) for k, v in cpu_state.items() if v.is_floating_point())

            def over(k):
                allowance = TRAIN_PARAM_RTOL * cpu_state[k].abs() + TRAIN_PARAM_ATOL_REL * scale
                return float(((gpu_state[k] - cpu_state[k]).abs() / allowance).max())

            stats = {k: over(k) for k in cpu_state if k not in trained and cpu_state[k].is_floating_point()
                     and not k.startswith(frozen)}
            params = {n: over(n) for n in trained}
            unet_still = all(torch.equal(gpu_state[k], start[k]) for k in gpu_state if k.startswith(frozen))
            worst_stat = max(stats, key=stats.get)
            worst = max(params, key=params.get)
            worst_leaf = max(leaf, key=leaf.get)
            emit({"phase": f"train_parity_{kind}", "config": "the same, banded, each step from the CPU's state",
                  "step": step, "loss_card": got, "loss_cpu": want, "loss_rel_err": loss_rel,
                  "worst_leaf_update_gap": leaf[worst_leaf], "worst_leaf": worst_leaf,
                  "worst_leaf_numel": cpu_state[worst_leaf].numel(), "limit": LEAF_UPDATE_REL,
                  "update_vector_gap": gap,
                  "stat_err_over_allowance": stats[worst_stat], "worst_stat": worst_stat,
                  "param_err_over_allowance": params[worst], "worst_param": worst,
                  "params_outside": sum(r > 1.0 for r in params.values()), "params": len(params),
                  "net_2d_equal_bitwise": unet_still, "launches": read_launches()})
            assert np.isfinite(got) and loss_rel <= TRAIN_LOSS_REL, f"card/CPU {kind} train loss disagree"
            assert_updates_agree(kind, leaf)
            assert stats[worst_stat] <= 1.0, f"card/CPU {kind} BN statistics disagree"
            assert unet_still, "the frozen net_2d moved on the card"
        launches = read_launches()
        assert launches["segsum"] == launches["segsum_plan"] == 3 * sums, launches
        assert launches["pixel_topk"] == (3 if kind == "mvpnet" else 0), launches
        by_path[f"train_parity_{kind}"] = launches

        # ---- planted faults on the card's step 1, through the same check
        start, opt_start, cpu_after = first
        smallest = min(trained, key=lambda n: cpu_after[n].numel())
        segsum = gather.segsum
        for fault in ("gradient", "gather_vjp"):
            gpu.load_state_dict(start)
            gpu_opt.load_state_dict(copy.deepcopy(opt_start))
            calls = []

            def zeroed(rows, index, ns, round_bf16=False, plans=None):
                calls.append(index.shape)
                out = segsum(rows, index, ns, round_bf16, plans)
                return torch.zeros_like(out) if len(calls) == 1 else out

            hook = None
            if fault == "gradient":
                hook = dict(gpu.named_parameters())[smallest].register_hook(torch.zeros_like)
            else:
                gather.segsum = zeroed
            try:
                gpu_step(gpu_b)
            finally:
                gather.segsum = segsum
                if hook is not None:
                    hook.remove()
            leaf, gap = update_gaps(cpu_after, {k: v.cpu() for k, v in gpu.state_dict().items()}, start, trained)
            worst_leaf = max(leaf, key=leaf.get)
            try:
                assert_updates_agree(kind, leaf)
                caught = False
            except AssertionError:
                caught = True
            emit({"phase": f"train_parity_{kind}_planted_fault", "fault": fault,
                  "where": smallest if fault == "gradient" else f"K3 sum of index {list(calls[0])}",
                  "worst_leaf_update_gap": leaf[worst_leaf], "worst_leaf": worst_leaf, "limit": LEAF_UPDATE_REL,
                  "update_vector_gap": gap, "caught": caught})
            assert caught, f"a planted fault ({fault}) passed the {kind} update check"
    return by_path


# ---- custom-dataset inference: the native host ops, test_colmap on a COLMAP workspace

SCAN_POINTS = 1_000_000  # a terrestrial scan of one room
COLMAP_VIEWS, COLMAP_HW = 24, (480, 640)  # above 120x160, so that the tool's resize runs
COLMAP_VOTES = 1.0  # the JAX tool's default is 10
PARITY_VOTES = 0.05


@contextlib.contextmanager
def recorded(*targets):
    """Each ``(owner, name)`` attribute wrapped for the block: every call's
    host seconds and result are appended to ``calls[name]``."""
    calls = {name: [] for _, name in targets}
    saved = [(owner, name, getattr(owner, name)) for owner, name in targets]

    def wrap(name, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            calls[name].append((time.perf_counter() - t0, out))
            return out
        return call

    for owner, name, fn in saved:
        setattr(owner, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


@contextlib.contextmanager
def numpy_host_ops():
    """The port's host ops on their numpy fallbacks for the block."""
    from mvkpconv_tpu_torch.data import native

    load = native._load
    native._load = lambda: None
    try:
        yield
    finally:
        native._load = load


def check_native_host_ops(scan, cell):
    """The C++ host ops against their numpy fallbacks on the scan: the voxel
    subsample (as many voxels; the same voxels, barycentres and mean colours
    within 1e-5 and the same majority labels, but for the few a point on a
    cell boundary puts on another side, counted) and the 1-NN of 256 jittered scan points into
    the subsampled scan (the same indices as numpy's brute force); host ms
    of each. The
    library must build and load: a run on the fallbacks fails here."""
    import numpy as np
    from mvkpconv_tpu_torch.data import native, spheres

    t0 = time.perf_counter()
    loaded = native.available()
    load_s = time.perf_counter() - t0
    assert loaded, f"the native host ops did not build or load ({native._LIB_PATH})"
    pts, cols, labs = scan["points"], scan["colors"], scan["labels"]
    t0 = time.perf_counter()
    got = native.grid_subsample_native(pts, cols, labs, cell)
    native_sub_ms = (time.perf_counter() - t0) * 1e3
    with numpy_host_ops():
        t0 = time.perf_counter()
        want = spheres.grid_subsample_np(pts, cols, labs, cell)
        numpy_sub_ms = (time.perf_counter() - t0) * 1e3

    # a point on a cell boundary may fall on either side: the C++ op takes
    # floor(x * (1 / cell)), numpy floor(x / cell); the voxels such points
    # touch are counted and left out of the comparison
    inv = np.float32(1) / np.float32(cell)
    native_vox, numpy_vox = np.floor(pts * inv).astype(np.int64), np.floor(pts / cell).astype(np.int64)
    apart = (native_vox != numpy_vox).any(1)

    def key(vox):
        return (vox[:, 0] << 42) + (vox[:, 1] << 21) + vox[:, 2]

    touched = set(key(native_vox[apart]).tolist()) | set(key(numpy_vox[apart]).tolist())

    def by_voxel(sub):
        k = key(np.floor(sub[0] / np.float32(cell)).astype(np.int64))
        keep = ~np.isin(k, list(touched))
        order = np.argsort(k[keep], kind="stable")
        return k[keep][order], sub[0][keep][order], sub[1][keep][order], sub[2][keep][order]

    (gk, gp, gc, gl), (wk, wp, wc, wl) = by_voxel(got), by_voxel(want)
    assert len(got[0]) == len(want[0]), (len(got[0]), len(want[0]))
    assert apart.sum() <= 1e-4 * len(pts), int(apart.sum())
    assert np.array_equal(gk, wk), (len(gk), len(wk))
    sub_gap = float(max(np.abs(gp - wp).max(), np.abs(gc - wc).max()))
    assert sub_gap <= 1e-5, sub_gap
    assert np.array_equal(gl, wl), int((gl != wl).sum())

    rng = np.random.RandomState(0)
    supports = got[0]
    queries = (pts[rng.choice(len(pts), 256, replace=False)] + rng.normal(0, 0.02, (256, 3))).astype(np.float32)
    t0 = time.perf_counter()
    idx, d2 = native.nearest_neighbor_1nn_native(queries, supports)
    native_nn_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want_idx = np.concatenate([((q[:, None] - supports[None]) ** 2).sum(-1).argmin(1)
                               for q in np.array_split(queries, 64)])
    numpy_nn_ms = (time.perf_counter() - t0) * 1e3
    assert np.array_equal(idx, want_idx), int((idx != want_idx).sum())
    return {"phase": "native_host_ops", "library": str(native._LIB_PATH.relative_to(ROOT)), "loaded": loaded,
            "build_and_load_s": load_s, "scan_points": len(pts), "cell": cell, "voxels": len(got[0]),
            "points_on_cell_boundaries": int(apart.sum()), "voxels_left_out": len(touched),
            "subsample_native_ms": native_sub_ms, "subsample_numpy_ms": numpy_sub_ms,
            "subsample_max_gap": sub_gap, "nn_queries": len(queries), "nn_supports": len(supports),
            "nn_native_ms": native_nn_ms, "nn_numpy_ms": numpy_nn_ms, "nn_indices_equal": True}


def overlap_nn_ms(scene):
    """Host ms of the frame overlap's 1-NN (2,048 scan points into the first
    frame's pixel cloud, as ``compute_rgbd_overlap`` asks it): the native op at
    the JAX package's cell (0.1 m) and at the library's own, and numpy."""
    import numpy as np
    from mvkpconv_tpu_torch.data import native, spheres
    from mvkpconv_tpu_torch.ops.common import SHADOW_COORD

    pix = spheres.SphereDataset._frame_pixel_clouds({k: scene[k][:1] for k in ("depth", "intrinsics", "poses")},
                                                    stride=4)[0]
    pix = pix[pix[:, 0] < SHADOW_COORD / 2]
    base = scene["points"][np.random.RandomState(0).choice(len(scene["points"]), 2048, replace=False)]
    out = {}
    for name, cell in (("native_cell_0.1_ms", 0.1), ("native_own_cell_ms", None)):
        t0 = time.perf_counter()
        _, d2 = native.nearest_neighbor_1nn_native(base, pix, cell)
        out[name] = (time.perf_counter() - t0) * 1e3
        out.setdefault("d2", d2)
        assert np.array_equal(d2, out["d2"]), name
    t0 = time.perf_counter()
    d2 = ((base[:, None] - pix[None]) ** 2).sum(-1).min(1)
    out["numpy_ms"] = (time.perf_counter() - t0) * 1e3
    out["within_0.1"] = int((out.pop("d2") < 0.01).sum())
    assert out["within_0.1"] == int((d2 < 0.01).sum())
    return dict(out, pixels=len(pix), base_points=len(base))


def colmap_workspace(root, scan, views, hw, seed=11):
    """A COLMAP workspace of the scan, as a user's reconstruction gives it:
    ``sparse/cameras.bin`` (one PINHOLE camera), ``sparse/images.bin``
    (world-to-camera quaternions in COLMAP's own frame), dense depth maps
    ``depths/<image>.geometric.bin`` (the scan rendered by z-buffer at
    ``hw``, each hole filled from its nearest rendered pixel, as a fused
    COLMAP map has none), ``laser.ply`` and ``matrix_for_images.txt``: a
    rotation about z and a translation taking COLMAP's frame into the scan's.
    Returns the paths and the rendered views."""
    import numpy as np
    from scipy import ndimage
    from mvkpconv_tpu_torch.data import colmap_io as cio
    from mvkpconv_tpu_torch.data import synthetic
    from mvkpconv_tpu_torch.utils.ply import write_ply

    sparse, depths = root / "sparse", root / "depths"
    sparse.mkdir(parents=True), depths.mkdir()
    rendered = synthetic.render_views(scan, views, hw[0], hw[1], seed=seed)
    c, s = np.cos(0.4), np.sin(0.4)
    align = np.array([[c, -s, 0, 1.5], [s, c, 0, -0.75], [0, 0, 1, 0.2], [0, 0, 0, 1]])
    np.savetxt(root / "matrix_for_images.txt", align)
    K = rendered["intrinsics"][0]
    cio.write_cameras_binary({1: cio.Camera(1, "PINHOLE", hw[1], hw[0],
                                            np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float64))},
                             sparse / "cameras.bin")
    images = {}
    for v in range(views):
        w2c = np.linalg.inv(np.linalg.inv(align) @ rendered["poses"][v].astype(np.float64))
        images[v + 1] = cio.ColmapImage(v + 1, cio.rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], 1, f"frame_{v:04d}.jpg")
        depth = rendered["depth"][v]
        nearest = ndimage.distance_transform_edt(depth <= 0, return_distances=False, return_indices=True)
        cio.write_array(depth[tuple(nearest)], depths / f"frame_{v:04d}.jpg.geometric.bin")
    cio.write_images_binary(images, sparse / "images.bin")
    write_ply(root / "laser.ply", [scan["points"], (scan["colors"] * 255).astype(np.uint8)],
              ["x", "y", "z", "red", "green", "blue"])
    return {"sparse": sparse, "depths": depths, "laser": root / "laser.ply",
            "alignment": root / "matrix_for_images.txt", "rendered": rendered}


def seeded_run(root, cfg, dev):
    """A run directory of the port: ``cfg``'s ``parameters.txt`` and a
    checkpoint of seeded weights (no training)."""
    from mvkpconv_tpu_torch.infer import make_model
    from mvkpconv_tpu_torch.training.checkpoint import Checkpointer

    root.mkdir(parents=True)
    cfg.save(root / "parameters.txt")
    Checkpointer(root / "checkpoints").save({"step": 0, "model": make_model(cfg, dev, seed=0).state_dict()}, 0)
    return root


def colmap_argv(ws, run, votes, out_ply=None):
    argv = ["--run", str(run), "--sparse", str(ws["sparse"]), "--depths", str(ws["depths"]),
            "--laser", str(ws["laser"]), "--alignment", str(ws["alignment"]), "--votes", str(votes)]
    return argv + (["--output-ply", str(out_ply)] if out_ply else [])


def check_colmap_kernels(dev, ds, cfg, k1_rows, k2_rows):
    """K1 and K2 against their plain versions at a batch of ``test_colmap``'s
    own dataset (spheres of the dense scan, views posed from COLMAP's
    quaternions through the alignment, depth resized by nearest index): K1
    at the 13 selections of its pyramid (the level-0 conv timed), K2 at its
    views with the bf16 candidates the lift hands it, timed, with the share
    of (point, view) pairs that project inside the image."""
    import torch
    from mvkpconv_tpu_torch.data.spheres import device_batch
    from mvkpconv_tpu_torch.infer import batch_to_device
    from mvkpconv_tpu_torch.ops.sampling import grid_subsample
    from mvkpconv_tpu_torch.ops.unproject import project_to_views, unproject_depth, window_anchors

    batch = batch_to_device(device_batch(ds.sample_batch()), dev)
    spec = cfg.pyramid_spec()
    p0, m0 = batch["points"], batch["mask"]
    levels = [(p0, m0)]
    for lv in range(1, spec.num_levels):
        sub = grid_subsample(levels[-1][0], spec.cell_size(lv), spec.num_points[lv], mask=levels[-1][1])
        levels.append((sub.points, sub.mask))
    for name, q, sup, r, k in forward_k1_calls(spec, levels):
        check_k1(f"{name}_colmap", q, sup, r, k, k1_rows, timed=name == "k1_L0_conv")
    image_xyz, _ = unproject_depth(batch["depth"], batch["intrinsics"], batch["poses"])
    u, v = project_to_views(p0, batch["intrinsics"], batch["poses"])
    w = cfg.pixel_window
    inside = (u >= 0) & (u < cfg.image_width) & (v >= 0) & (v < cfg.image_height) & m0[:, None, :]
    iu0 = window_anchors(u, cfg.image_width, w).contiguous()
    iv0 = window_anchors(v, cfg.image_height, w).contiguous()
    check_k2("k2_colmap_bfloat16", p0, image_xyz.to(torch.bfloat16).contiguous(), iu0, iv0, w, cfg.pixel_knn,
             k2_rows, in_view=float(inside.sum()) / float(m0.sum() * inside.shape[1]),
             real_points=int(m0.sum()))


def check_test_colmap(dev, smi, tmp, scan, ws, k1_rows, k2_rows):
    """``tools/test_colmap.main`` at the training CLI's default configuration
    on the workspace, on the card: K1 13 calls (26 launches) and K2 once a
    forward, no K3 or K4; the prediction PLY re-read, one label in [0, C) per
    point of the subsampled scan; host seconds of the scene's assembly and of
    the dataset's construction, forwards, ms a forward, device busy a
    forward, peak memory, the spheres' fill of N0."""
    import numpy as np
    import torch
    from mvkpconv_tpu_torch.data import colmap_io, spheres
    from mvkpconv_tpu_torch.data.spheres import device_batch
    from mvkpconv_tpu_torch.eval import voting
    from mvkpconv_tpu_torch.infer import batch_to_device
    from mvkpconv_tpu_torch.tools import test_colmap
    from mvkpconv_tpu_torch.training import steps
    from mvkpconv_tpu_torch.utils.ply import read_ply

    cfg = cli_config()
    run = seeded_run(tmp / "colmap_run", cfg, dev)
    out_ply = tmp / "colmap_pred.ply"
    with recorded((colmap_io, "load_colmap_scene"), (spheres.SphereDataset, "__init__"),
                  (voting.VotingTester, "run"), (steps, "make_eval_step")) as calls:
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        tester = test_colmap.main(colmap_argv(ws, run, COLMAP_VOTES, out_ply))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    forwards = launches["pixel_topk"]
    k1 = 3 * cfg.num_layers - 2
    assert forwards > 0 and launches["radius_topk"] == k1 * forwards, launches
    assert launches["radius_topk_device"] == 2 * k1 * forwards, launches
    assert launches["segsum"] == launches["segsum_plan"] == launches["kpconv_fused_fwd"] == 0, launches
    probs = tester.probs[0]
    ds = tester.ds
    cloud = ds.scenes[0]["points"]
    assert probs.shape == (len(cloud), cfg.num_classes) and np.isfinite(probs).all(), probs.shape
    ply = read_ply(out_ply)
    assert len(ply["pred"]) == len(cloud) and np.array_equal(np.stack([ply["x"], ply["y"], ply["z"]], 1), cloud)
    assert 0 <= ply["pred"].min() and ply["pred"].max() < cfg.num_classes
    assert np.array_equal(ply["pred"], probs.argmax(-1))
    scene_s, scene = calls["load_colmap_scene"][0]
    dataset_s = calls["__init__"][0][0]
    sweep_s = calls["run"][0][0]
    assert scene["depth"].shape == (COLMAP_VIEWS, cfg.image_height, cfg.image_width), scene["depth"].shape
    # the poses came back in the scan's frame: align @ cam_to_world
    pose_gap = float(np.abs(scene["poses"] - ws["rendered"]["poses"]).max())
    assert pose_gap < 1e-4, pose_gap
    eval_step = calls["make_eval_step"][0][1]
    check_colmap_kernels(dev, ds, cfg, k1_rows, k2_rows)
    tb = batch_to_device(device_batch(ds.sample_batch()), dev)
    ms_forward = cuda_ms(lambda: eval_step(tb), reps=5)
    busy = device_ms(lambda: eval_step(tb), reps=3)
    counts = ds.sphere_counts
    row = {"phase": "test_colmap_full", "config": "train_scannet --fusion early defaults (ARCHITECTURE_DEEPER, "
           "width 128, B=5, N0=16384, K=34, V=5, 120x160, f32), seeded weights", "votes": COLMAP_VOTES,
           "scan_points": len(scan["points"]), "subsampled_points": len(cloud), "images": COLMAP_VIEWS,
           "depth_hw": list(COLMAP_HW), "pose_gap": pose_gap, "seconds": seconds,
           "scene_assembly_s": scene_s, "dataset_construction_s": dataset_s, "sweep_s": sweep_s,
           "forwards": forwards, "sweep_ms_per_forward": sweep_s / forwards * 1e3,
           "ms_per_forward": ms_forward, "device_busy_ms_per_forward": busy, "peak_mem_gib": peak,
           "sphere_counts_mean": float(np.mean(counts)), "spheres": len(counts),
           "budget_filled": float(np.mean(np.minimum(counts, cfg.num_points[0]))) / cfg.num_points[0],
           "launches": launches, "launches_per_forward": {k: launches[k] / forwards for k in
                                                          ("radius_topk", "radius_topk_device", "pixel_topk")},
           "pred_classes": int(len(np.unique(ply["pred"]))), "overlap_nn": overlap_nn_ms(scene), "card": smi}
    emit(row)
    return launches


def check_colmap_parity(dev, tmp, ws):
    """``test_colmap`` on the card against ``--device cpu`` on the same
    workspace at a small configuration (3 levels, width 32, N0 1024, B=2, 3
    views of 120x160), the same seeded weights, f32, TF32 off: the spheres
    are the same by construction (the dataset's own seed); the accumulated
    probabilities within 1e-4 of their largest, the labels equal except
    where the two best classes lie within that bound (counted)."""
    import numpy as np
    from mvkpconv_tpu_torch.tools import test_colmap
    from mvkpconv_tpu_torch.training.config import KPConfig

    small = cli_config().replace(
        architecture=("simple", "resnetb", "resnetb_strided", "resnetb", "resnetb_strided", "resnetb",
                      "nearest_upsample", "unary", "nearest_upsample", "unary"),
        num_points=(1024, 256, 64), conv_neighbors=(16,) * 3, pool_neighbors=(16,) * 2,
        first_features_dim=32, num_views=3, batch_num=2)
    assert isinstance(small, KPConfig)
    run = seeded_run(tmp / "colmap_parity_run", small, "cpu")
    argv = colmap_argv(ws, run, PARITY_VOTES)
    reset_launches()
    t0 = time.perf_counter()
    card = test_colmap.main(argv)
    card_s = time.perf_counter() - t0
    launches = read_launches()
    t0 = time.perf_counter()
    cpu = test_colmap.main(argv + ["--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    got, want = card.probs[0], cpu.probs[0]
    scale = float(np.abs(want).max())
    gap = float(np.abs(got - want).max())
    top2 = np.sort(want, -1)[:, -2:]
    near_tie = top2[:, 1] - top2[:, 0] <= PARITY_REL * scale
    covered = want.sum(-1) > 0  # points some sphere reached
    differ = got.argmax(-1) != want.argmax(-1)
    emit({"phase": "test_colmap_parity", "config": "3 levels, width 32, N0=1024, B=2, 3 views of 120x160, f32, "
          "TF32 off", "votes": PARITY_VOTES, "forwards": launches["pixel_topk"], "card_s": card_s, "cpu_s": cpu_s,
          "spheres_equal": card.ds.sphere_counts == cpu.ds.sphere_counts, "max_abs_gap": gap, "prob_max": scale,
          "gap_over_allowance": gap / (PARITY_REL * scale), "points": len(want), "covered": int(covered.sum()),
          "labels_differ": int(differ.sum()), "near_ties_covered": int((near_tie & covered).sum()),
          "labels_differ_off_ties": int((differ & ~near_tie).sum()),
          "launches": launches})
    assert launches["pixel_topk"] > 0 and launches["radius_topk"] == 7 * launches["pixel_topk"], launches
    assert card.ds.sphere_counts == cpu.ds.sphere_counts
    assert scale > 0 and gap <= PARITY_REL * scale, (gap, scale)
    assert not (differ & ~near_tie).any(), int((differ & ~near_tie).sum())


def check_custom_dataset(dev, smi, tmp, k1_rows, k2_rows):
    """The native host ops on a scan of 1,000,000 points, then test_colmap on
    a COLMAP workspace of it: at full width with PyTorch's TF32 defaults, as
    a user runs it, then card against CPU with TF32 off."""
    from mvkpconv_tpu_torch.data import synthetic

    t0 = time.perf_counter()
    scan = synthetic.make_scene(seed=11, num_points=SCAN_POINTS)
    scan_s = time.perf_counter() - t0
    row = check_native_host_ops(scan, cli_config().first_subsampling_dl)
    emit(row)
    t0 = time.perf_counter()
    ws = colmap_workspace(tmp / "colmap", scan, COLMAP_VIEWS, COLMAP_HW)
    emit({"phase": "colmap_workspace", "scan_s": scan_s, "workspace_s": time.perf_counter() - t0,
          "images": COLMAP_VIEWS, "depth_hw": list(COLMAP_HW)})
    import torch

    torch.backends.cudnn.allow_tf32 = True  # as a user runs the tool
    try:
        launches = check_test_colmap(dev, smi, tmp, scan, ws, k1_rows, k2_rows)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    check_colmap_parity(dev, tmp, ws)
    return {"test_colmap": launches}


# ---- a JAX run resumed, deformable inspection, the serving export through
# the kernels' operators, the variant-accuracy matrix

@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` inside:
    the pyramid's ``scatter_add_`` atomics would otherwise part two runs of
    one forward or step by more than the orders of their sums do."""
    import warnings

    import torch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)

DDP_LOSS_RTOL, DDP_PARAM_RTOL, DDP_PARAM_ATOL = 1e-5, 1e-4, 1e-6  # tests/test_parallel.py:166-172


EXPORT_PROB_REL = 1e-6  # of the largest probability


def allowance_over(got, want):
    """Each tensor's largest |got − want| over the train-step allowance
    (rtol 1e-3, atol 1e-5 · the largest |value| of all of ``want``)."""
    atol = TRAIN_PARAM_ATOL_REL * max(float(v.abs().max()) for v in want.values())
    return {k: float(((got[k].cpu() - v).abs() / (TRAIN_PARAM_RTOL * v.abs() + atol)).max())
            for k, v in want.items()}


def remat_two_steps(cfg, dev, batch):
    """Two train steps of a trainer seeded 0: their losses, and every
    floating parameter and statistic after them (on the host)."""
    import torch
    from mvkpconv_tpu_torch.train import make_trainer, train_steps

    trainer = make_trainer(cfg, dev, seed=0)
    losses = [float(m["loss"]) for m in train_steps(trainer, batch, 2)]
    state = {k: v.detach().float().cpu() for k, v in trainer.model.state_dict().items() if v.is_floating_point()}
    del trainer
    torch.cuda.empty_cache()
    return {"losses": losses, "state": state}


def check_resume_jax_run(dev, small, tmp):
    """A JAX-layout run directory (``training/jax_checkpoint.py``
    ``write_jax_checkpoint``: the flax ``TrainState`` bytes of 2 CPU steps of
    ``small``'s configuration, the UNet frozen, 'banded', lr decay 0.5 at
    ``epoch_steps=2``) resumed by ``Trainer.maybe_resume`` on the card and on
    the CPU, then one step each, f32, TF32 off: the restored momentum equal
    bit for bit to what was written, the step's loss within 1e-5 relative,
    every parameter and momentum buffer within the train-step allowance,
    the learning rate (the decayed one) and the schedule's count equal, the
    card's launches held to the plan."""
    import numpy as np
    import torch
    from mvkpconv_tpu_torch.data.synthetic_batch import make_batch
    from mvkpconv_tpu_torch.infer import batch_to_device
    from mvkpconv_tpu_torch.train import make_trainer
    from mvkpconv_tpu_torch.training.jax_checkpoint import write_jax_checkpoint
    from mvkpconv_tpu_torch.training.trainer import Trainer

    cfg = small.replace(gather_transpose="banded", epoch_steps=2, lr_decay=0.5)
    tb = make_batch(cfg, 2, np.random.RandomState(1))
    src = make_trainer(cfg, "cpu", seed=1)
    for _ in range(2):
        src.step(batch_to_device(tb, "cpu"))
    ck = tmp / "jax_run" / "checkpoints"
    path = write_jax_checkpoint(ck / "ckpt_00000002.msgpack", src.model, src.optimizer, 2)
    (ck / "last_checkpoint").write_text(path.name)
    written = {n: src.optimizer.state[p]["momentum_buffer"] for n, p in src.model.named_parameters()
               if p in src.optimizer.state}
    sides = {}
    for name, device, seed in (("cpu", "cpu", 3), ("card", dev, 4)):
        setup = make_trainer(cfg, device, seed=seed)
        trainer = Trainer(setup.step, setup.model, setup.optimizer, str(tmp / "jax_run"), cfg)
        trainer.maybe_resume()
        params = dict(setup.model.named_parameters())
        restored = {n: setup.optimizer.state[params[n]]["momentum_buffer"] for n in written}
        assert trainer.step == 2 and all(torch.equal(restored[n].cpu(), b) for n, b in written.items()), name
        reset_launches()
        loss = float(trainer.train_step(batch_to_device(tb, device))["loss"])
        sides[name] = (trainer, loss, read_launches())
    (cpu, want_loss, _), (card, got_loss, launches) = sides["cpu"], sides["card"]

    def state(tr):
        params = dict(tr.model.named_parameters())
        bufs = {f"momentum:{n}": tr.optimizer.state[params[n]]["momentum_buffer"] for n in written}
        return {**{n: p.detach() for n, p in params.items()}, **bufs}

    over = allowance_over(state(card), state(cpu))
    worst = max(over, key=over.get)
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    lrs = [[g["lr"] for g in tr.optimizer.param_groups] for tr in (card, cpu)]
    counts = [[g["count"] for g in tr.optimizer.param_groups] for tr in (card, cpu)]
    emit({"phase": "resume_jax_run", "config": "ARCHITECTURE_DEEPER, N0=1024, width 32, 3 views 24x32, "
          "f32, banded, UNet frozen, lr_decay 0.5 at epoch_steps 2", "file": path.name,
          "file_bytes": path.stat().st_size, "momentum_buffers": len(written), "step_after": card.step + 1,
          "loss_card": got_loss, "loss_cpu": want_loss, "loss_rel_err": loss_rel, "lr": lrs[0],
          "count": counts[0], "err_over_allowance": over[worst], "worst": worst,
          "outside": sum(r > 1.0 for r in over.values()), "tensors": len(over), "launches": launches})
    assert np.isfinite(got_loss) and loss_rel <= TRAIN_LOSS_REL, "card/CPU resumed step losses disagree"
    assert over[worst] <= 1.0, "card/CPU resumed states disagree"
    assert lrs[0] == lrs[1] == [cfg.learning_rate * 0.5] and counts[0] == counts[1] == [3], (lrs, counts)
    assert launches["radius_topk"] == 13 and launches["pixel_topk"] == 1, launches
    assert launches["segsum"] == trunk_gathers(card.model), launches
    return launches


def check_inspect_deform(dev, raw, smi, tmp):
    """``eval/deform_inspect.inspect_deformable`` at full width:
    ``infer.deform_config()`` (blocks 9–13 deformable) with seeded weights
    on the bench batch, on the card: 5 deformable layers, finite statistics,
    a PLY and a viewer HTML each, K1 13 calls (26 launches) and K2 1 in its
    forward, no K3 or K4; its seconds (forward, collection, files) beside
    the ms of the same forward alone."""
    import numpy as np
    import torch
    from mvkpconv_tpu_torch.eval.deform_inspect import inspect_deformable
    from mvkpconv_tpu_torch.infer import batch_to_device, deform_config, infer, make_model

    cfg = deform_config()
    model = make_model(cfg, dev, seed=0)
    inspect_deformable(model, raw, cfg, tmp / "deform_warmup")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    summary = inspect_deformable(model, raw, cfg, tmp / "deform")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    batch = batch_to_device(raw, dev)
    fwd_ms = cuda_ms(lambda: infer(model, batch), 5)
    layers = summary["layers"]
    emit({"phase": "inspect_deform_full", "config": config_label(cfg), "seconds": seconds,
          "forward_ms": fwd_ms, "layers": layers, "plys": [Path(p).name for p in summary["plys"]],
          "launches": launches, "card": smi})
    assert len(layers) == 5 and len(summary["plys"]) == 5, layers
    assert all(np.isfinite([s["mean_kp_radius"], s["max_kp_radius"], s["fit_fraction"]]).all() for s in layers)
    assert all(Path(p).exists() and Path(p).with_suffix(".html").exists() for p in summary["plys"])
    assert launches["radius_topk"] == 13 and launches["radius_topk_device"] == 26, launches
    assert launches["pixel_topk"] == 1 and launches["segsum"] == launches["kpconv_fused_fwd"] == 0, launches
    return launches


def check_export(phase, cfg, dev, batch, smi, beside, tmp, calls=5, label=None):
    """``eval/export.export_inference`` of ``cfg`` on the card (seeded
    weights; ``batch`` of its shapes), saved, loaded back by
    ``ServingModel`` (the kernels' operators, no model code) and called
    ``calls`` times: K1 3L − 2 (twice that in launches: 13 (26) at 5
    levels), K2 1 and, on the fused path, K4's forward once a conv block, a
    call, all through the ``mvkpconv::`` operators; the probabilities equal
    the eager model's within 1e-6 of the largest, both run under
    ``torch.use_deterministic_algorithms`` (the pyramid's ``scatter_add_``
    atomics part two runs of either by more: read as ``spread``); export
    and load seconds, artifact bytes, ms a call beside the eager forward's
    timed right after it (and beside the full-width run ``beside``'s, where
    given). ``label`` describes a configuration other than the bench's."""
    import torch
    from mvkpconv_tpu_torch.eval.export import ServingModel, export_inference, save_exported
    from mvkpconv_tpu_torch.infer import infer, make_model

    model = make_model(cfg, dev, seed=0)
    t0 = time.perf_counter()
    data = export_inference(model, cfg)
    export_s = time.perf_counter() - t0
    path = save_exported(data, tmp / f"{phase}.pt2")
    t0 = time.perf_counter()
    served = ServingModel.load(path)
    load_s = time.perf_counter() - t0
    sb = {k: batch[k] for k in served.input_spec}
    served(sb)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(calls):
        out = served(sb)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / calls * 1e3
    launches = read_launches()
    t0 = time.perf_counter()
    for _ in range(calls):
        torch.softmax(infer(model, batch), dim=-1)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / calls * 1e3
    with torch.no_grad():
        spread = float((out - torch.softmax(infer(model, batch), dim=-1)).abs().max())
    with deterministic(), torch.no_grad():
        want = torch.softmax(infer(model, batch), dim=-1)
        got = served(sb)
    err, top = float((got - want).abs().max()), float(want.abs().max())
    n_conv, _ = conv_blocks(model)
    k1 = 3 * cfg.num_layers - 2
    emit({"phase": phase, "config": label or config_label(cfg), "export_s": export_s, "load_s": load_s,
          "artifact_bytes": len(data), "calls": calls, "ms_per_call": ms, "eager_ms_per_call": eager_ms,
          "full_ms_per_forward": beside and beside["ms_per_forward"], "launches": launches,
          "max_abs_err": err, "max_prob": top, "limit": EXPORT_PROB_REL * top, "spread_nondeterministic": spread,
          "device": str(served.device), "card": smi})
    assert tuple(got.shape) == (cfg.batch_num, cfg.num_points[0], cfg.num_classes), got.shape
    assert bool(torch.isfinite(got).all()) and err <= EXPORT_PROB_REL * top, "export/eager probabilities disagree"
    assert launches["radius_topk"] == k1 * calls and launches["radius_topk_device"] == 2 * k1 * calls, launches
    assert launches["pixel_topk"] == calls, launches
    assert launches["kpconv_fused_fwd"] == (n_conv * calls if runs_k4(cfg) else 0), (launches, n_conv)
    assert launches["segsum"] == 0, launches
    return launches


def check_measure_variants(dev, tmp):
    """``tools/measure_variants.main --tiny`` on the card, row by row into
    one ``--out``: the KPFCNN row (K1, K3; no K2), then the early-fusion
    row (the 2D net pretrained 2 steps, frozen; K1, K2, K3); the report's
    keys and protocols, each row's launches."""
    from mvkpconv_tpu_torch.tools import measure_variants

    paths = {}
    argv = ["--tiny", "--steps", "2", "--steps-2d", "2", "--train-scenes", "1", "--val-scenes", "1",
            "--out", str(tmp / "variants"), "--device", str(dev)]
    for row in ("kpconv_baseline", "mvkpconv_early"):
        reset_launches()
        t0 = time.perf_counter()
        res = measure_variants.main([*argv, "--only", row])
        seconds = time.perf_counter() - t0
        paths[f"measure_variants_{row}"] = launches = read_launches()
        emit({"phase": "measure_variants_tiny", "row": row, "result": res[row], "seconds": seconds,
              "launches": launches})
        assert set(res[row]) == {"miou", "oa", "final_loss", "steps", "minutes", "protocol"}, res
        assert res[row]["protocol"] == ("3d_only" if row == "kpconv_baseline" else "two_stage_frozen_2d")
        assert launches["radius_topk"] > 0 and launches["segsum"] > 0, launches
        assert (launches["pixel_topk"] > 0) == (row == "mvkpconv_early"), launches
    return paths


def check_export_mvpnet(dev, smi, scenes, tmp, calls=5):
    """``eval/export.export_inference(kind='mvpnet')`` at ``train_mvpnet``'s
    defaults on the card (MVPNet3D with seeded weights, the UNet frozen; 4
    chunks of 8192 points from ``ChunkDataset``, 3 views of 120x160, f32),
    saved, loaded back by ``ServingModel`` and called ``calls`` times: P1
    once a set-abstraction level (4) and K2 once a call, through the
    ``mvkpconv::`` operators, no K1, K3 or K4; the probabilities equal the
    eager model's within 1e-6 of the largest under
    ``torch.use_deterministic_algorithms``; export and load seconds, bytes,
    ms a call beside the eager forward's, timed right after it."""
    import torch
    from mvkpconv_tpu_torch.eval.export import ServingModel, TensorSpec, export_inference, save_exported
    from mvkpconv_tpu_torch.infer import infer, make_model
    from mvkpconv_tpu_torch.training.config import KPConfig

    cfg = KPConfig(batch_num=4, num_views=3, epoch_steps=100)  # tools/train_mvpnet.py's
    batch = mvpnet_batch(dev, scenes)
    sb = {k: batch[k] for k in ("points", "images", "depth", "intrinsics", "poses")}
    spec = {k: TensorSpec(tuple(v.shape), v.dtype) for k, v in sb.items()}
    model = make_model(cfg, dev, seed=0, kind="mvpnet")
    t0 = time.perf_counter()
    data = export_inference(model, cfg, "mvpnet", batch_spec=spec)
    export_s = time.perf_counter() - t0
    path = save_exported(data, tmp / "export_mvpnet.pt2")
    t0 = time.perf_counter()
    served = ServingModel.load(path)
    load_s = time.perf_counter() - t0
    served(sb)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(calls):
        out = served(sb)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / calls * 1e3
    launches = read_launches()
    t0 = time.perf_counter()
    for _ in range(calls):
        torch.softmax(infer(model, sb), dim=-1)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / calls * 1e3
    with torch.no_grad():
        spread = float((out - torch.softmax(infer(model, sb), dim=-1)).abs().max())
    with deterministic(), torch.no_grad():
        want = torch.softmax(infer(model, sb), dim=-1)
        got = served(sb)
    err, top = float((got - want).abs().max()), float(want.abs().max())
    emit({"phase": "export_mvpnet", "config": "train_mvpnet defaults (MVPNet3D, UNet frozen, PN2SSG "
          "2048/512/128/32; B=4 chunks of 8192 points, 3 views of 120x160, f32), seeded weights",
          "export_s": export_s, "load_s": load_s, "artifact_bytes": len(data), "calls": calls, "ms_per_call": ms,
          "eager_ms_per_call": eager_ms, "launches": launches, "max_abs_err": err, "max_prob": top,
          "limit": EXPORT_PROB_REL * top, "spread_nondeterministic": spread, "device": str(served.device),
          "card": smi})
    assert tuple(got.shape) == (4, 8192, cfg.num_classes), got.shape
    assert bool(torch.isfinite(got).all()) and err <= EXPORT_PROB_REL * top, "export/eager probabilities disagree"
    assert launches["farthest_point_sample"] == 4 * calls and launches["pixel_topk"] == calls, launches
    assert not any(launches[k] for k in ("radius_topk", "segsum", "kpconv_fused_fwd")), launches
    return launches


# ---- data parallelism on torch.distributed (parallel/, the step over a mesh)


def ddp_f32_config():
    """The bench configuration in f32 with the exact gather VJP ('banded')."""
    import torch
    from mvkpconv_tpu_torch.infer import bench_config

    return bench_config().replace(compute_dtype=torch.float32, gather_transpose="banded")


def ddp_gloo_worker(rank, world, raw, steps):
    """A process of ``ddp_gloo_2proc`` on ``cuda:0`` (gloo): (a) one
    data-parallel step of ``ddp_f32_config()`` on its half of ``raw``, TF32
    off, deterministic algorithms, with its launches and the state after it; (b) the bench
    configuration (bf16), a warm-up and ``steps`` timed steps, and its peak
    memory."""
    import torch
    from mvkpconv_tpu_torch.infer import batch_to_device, bench_config
    from mvkpconv_tpu_torch.parallel import make_mesh, shard_batch
    from mvkpconv_tpu_torch.train import make_trainer

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(device_type="cuda")
    local = shard_batch(batch_to_device(raw, dev), mesh)
    setup = make_trainer(ddp_f32_config(), dev, seed=0, mesh=mesh)
    reset_launches()
    with deterministic():
        m = setup.step(local)
        torch.cuda.synchronize()
    out = {"f32": {"loss": float(m["loss"]), "accuracy": float(m["accuracy"]), "launches": read_launches(),
                   "state": {k: v.cpu() for k, v in setup.model.state_dict().items()},
                   "local_batch": list(local["points"].shape)}}
    del setup
    torch.cuda.empty_cache()
    setup = make_trainer(bench_config(), dev, seed=0, mesh=mesh)
    setup.step(local)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ms, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        m = setup.step(local)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out["bf16"] = {"ms_per_step": ms, "losses": losses, "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    return out


def ddp_world1_worker(rank, world, raw):
    """``ddp_nccl_world1``'s process: the bench step through the plain step,
    again (the control), and through the data-parallel step over a mesh of
    this one NCCL process, each from the same seeded weights, under
    ``torch.use_deterministic_algorithms``: whether the losses and every
    tensor of the state after the step are equal bit for bit."""
    import torch
    import torch.distributed as dist
    from mvkpconv_tpu_torch.infer import batch_to_device, bench_config
    from mvkpconv_tpu_torch.parallel import make_mesh, shard_batch
    from mvkpconv_tpu_torch.train import make_trainer

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(device_type="cuda")
    batch = batch_to_device(raw, dev)
    runs = {}
    with deterministic():
        for name, m in (("plain", None), ("plain_again", None), ("data_parallel", mesh)):
            setup = make_trainer(bench_config(), dev, seed=0, mesh=m)
            reset_launches()
            out = setup.step(batch if m is None else shard_batch(batch, m))
            torch.cuda.synchronize()
            runs[name] = (float(out["loss"]), {k: v.clone() for k, v in setup.model.state_dict().items()},
                          read_launches())

    def equal(a, b):
        return a[0] == b[0] and all(torch.equal(v, b[1][k]) for k, v in a[1].items())

    return {"losses": {k: v[0] for k, v in runs.items()}, "launches": runs["data_parallel"][2],
            "control_equal": equal(runs["plain_again"], runs["plain"]),
            "equal": equal(runs["data_parallel"], runs["plain"]),
            "differing": [k for k, v in runs["data_parallel"][1].items() if not torch.equal(v, runs["plain"][1][k])],
            "backend": dist.get_backend()}


def check_ddp(dev, raw, smi, steps=5):
    """``ddp_gloo_2proc``: two processes on ``cuda:0`` over gloo (NCCL
    refuses two ranks on one card; gloo's all-reduce and broadcast take CUDA
    tensors, all DDP needs), the bench batch split 2 spheres a process. (a)
    f32, TF32 off, deterministic algorithms (both sides): the loss and every parameter and statistic after one
    data-parallel step against the single-process step on the whole batch
    on the same card, at JAX's tolerances for its sharded step (loss rtol
    1e-5, state rtol 1e-4, atol 1e-6); K1 13 (26), K2 1 and K3 22 sums + 13
    plans a process. (b) bf16, ``steps`` timed steps a process: ms a step and
    peak memory. ``ddp_nccl_world1``: the path ``torchrun --nproc-per-node
    1`` takes, the data-parallel step over one NCCL process, bit-equal to the
    plain step. Both through ``parallel.spawn``. Then
    ``dryrun_multichip(4, device='cpu')`` on this machine's CPU: the (data,
    model) mesh with FSDP2 on its torch."""
    import numpy as np
    import torch
    from mvkpconv_tpu_torch.infer import batch_to_device, bench_config
    from mvkpconv_tpu_torch.parallel import dryrun_multichip, spawn
    from mvkpconv_tpu_torch.train import make_trainer

    t0 = time.perf_counter()
    gloo = spawn(ddp_gloo_worker, 2, raw, steps, timeout=600)
    seconds = time.perf_counter() - t0
    setup = make_trainer(ddp_f32_config(), dev, seed=0)
    with deterministic():
        single = setup.step(batch_to_device(raw, dev))
    want = {k: v.cpu() for k, v in setup.model.state_dict().items()}
    del setup
    loss_rel, over, worst = [], [], []
    for r in gloo:
        got = r["f32"]
        loss_rel.append(abs(got["loss"] - float(single["loss"])) / abs(float(single["loss"])))
        by_tensor = {k: float(((got["state"][k] - v).abs() / (DDP_PARAM_RTOL * v.abs() + DDP_PARAM_ATOL)).max())
                     for k, v in want.items() if v.is_floating_point()}
        over.append(max(by_tensor.values()))
        worst.append(sorted(by_tensor.items(), key=lambda kv: -kv[1])[:3])
    emit({"phase": "ddp_gloo_2proc", "config": "bench.py:106-117 (B=4, N0=16384, K=30, V=5, 120x160, width 128): "
          "(a) in f32, gather VJP 'banded', TF32 off, deterministic algorithms; (b) as the bench runs it, bf16", "processes": 2, "backend": "gloo", "device": str(dev),
          "local_batch": gloo[0]["f32"]["local_batch"], "seconds": seconds,
          "f32_loss": [r["f32"]["loss"] for r in gloo], "single_process_loss": float(single["loss"]),
          "loss_rel_err": loss_rel, "state_err_over_allowance": over, "worst_tensors": worst,
          "launches_per_process": [r["f32"]["launches"] for r in gloo],
          "bf16_ms_per_step": [r["bf16"]["ms_per_step"] for r in gloo],
          "bf16_ms_per_step_mean": [float(np.mean(r["bf16"]["ms_per_step"])) for r in gloo],
          "bf16_losses": [r["bf16"]["losses"] for r in gloo],
          "peak_mem_gib": [r["bf16"]["peak_mem_gib"] for r in gloo], "card": smi})
    assert max(loss_rel) <= DDP_LOSS_RTOL, "data-parallel and single-process losses disagree"
    assert max(over) <= 1.0, "data-parallel and single-process states disagree"
    for r in gloo:
        n = r["f32"]["launches"]
        assert (n["radius_topk"], n["radius_topk_device"], n["pixel_topk"], n["segsum"], n["segsum_plan"]) == \
            (13, 26, 1, 22, 13), n
        assert all(np.isfinite(r["bf16"]["losses"])), r["bf16"]
    t0 = time.perf_counter()
    (one,) = spawn(ddp_world1_worker, 1, raw, backend="nccl", timeout=600)
    emit({"phase": "ddp_nccl_world1", "config": config_label(bench_config()), "seconds": time.perf_counter() - t0,
          **one, "card": smi})
    assert one["backend"] == "nccl" and one["control_equal"], one
    assert one["equal"], "the data-parallel step at world size 1 is not the plain step bit for bit"
    # the (data, model) dry run on this machine's torch: FSDP2 over 4 gloo CPU processes
    t0 = time.perf_counter()
    loss = dryrun_multichip(4, device="cpu")
    ranks = dryrun_multichip.ranks
    emit({"phase": "dryrun_multichip_cpu", "processes": 4, "mesh": ranks[0]["mesh"], "loss": loss,
          "accuracy": ranks[0]["accuracy"], "sharded_over_model": len(ranks[0]["sharded"]),
          "seconds": time.perf_counter() - t0, "torch": torch.__version__})
    assert ranks[0]["mesh"] == {"data": 2, "model": 2} and ranks[0]["sharded"], ranks[0]["mesh"]
    return {"ddp_gloo_2proc": gloo[0]["f32"]["launches"], "ddp_nccl_world1": one["launches"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "mvkpconv_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing next to {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from mvkpconv_tpu_torch.data.synthetic_batch import make_batch
    from mvkpconv_tpu_torch.infer import (FUSED_OPTIONS, batch_to_device, bench_config, deform_config, fused_config,
                                          fusion_config)
    from mvkpconv_tpu_torch.models.kpfcnn import plan_architecture
    from mvkpconv_tpu_torch.ops import _build
    from mvkpconv_tpu_torch.ops.pyramid import build_pyramid
    from mvkpconv_tpu_torch.ops.sampling import grid_subsample
    from mvkpconv_tpu_torch.ops.unproject import project_to_views, unproject_depth, window_anchors
    from mvkpconv_tpu_torch.training.config import ARCHITECTURE_DEEPER, KPConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True, check=True)
    emit({
        "phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
        "torch_cuda": torch.version.cuda, "nvcc": nvcc.stdout.strip().splitlines()[-1],
        "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    })

    # ---- build ----
    t0 = time.perf_counter()
    lib = _build.build()
    seconds = time.perf_counter() - t0
    _build.library()
    emit({"phase": "build", "seconds": seconds, "library": lib.name, "ptxas": ptxas_by_entry(lib)})

    # ---- kernels against their plain versions at main-path shapes ----
    cfg = bench_config()
    spec = cfg.pyramid_spec()
    raw = make_batch(cfg, cfg.batch_num, np.random.RandomState(0))
    batch = batch_to_device(raw, dev)
    p0, m0 = batch["points"], batch["mask"]
    levels = [(p0, m0)]
    for l in range(1, spec.num_levels):
        sub = grid_subsample(levels[-1][0], spec.cell_size(l), spec.num_points[l], mask=levels[-1][1])
        levels.append((sub.points, sub.mask))
    k1_rows, k2_rows = [], []
    calls = forward_k1_calls(spec, levels)
    assert len(calls) == 13, len(calls)
    for call in calls:
        check_k1(*call, k1_rows)
    emit({"phase": "k1_forward_sum", "calls": len(calls),
          "ms": sum(r["ms"] for r in k1_rows), "plain_ms": sum(r["plain_ms"] for r in k1_rows),
          "bound_ms": sum(r["bound_ms"] for r in k1_rows),
          "earlier_ms_of": {n: EARLIER_MS[n] for n, *_ in calls if n in EARLIER_MS}})
    # off the main path: more supports within the radius (283 a query) than the list holds
    check_k1("k1_L2_conv_k100", levels[2][0], levels[2][0], spec.radius(2), 100, k1_rows)
    k1_adv_rows = []
    check_k1_adversarial(p0, spec.radius(0), spec.conv_k(0), k1_adv_rows)

    image_xyz, _ = unproject_depth(batch["depth"], batch["intrinsics"], batch["poses"])
    u, v = project_to_views(p0, batch["intrinsics"], batch["poses"])
    w = cfg.pixel_window
    iu0 = window_anchors(u, cfg.image_width, w).contiguous()
    iv0 = window_anchors(v, cfg.image_height, w).contiguous()
    for dt in (torch.bfloat16, torch.float32):
        check_k2(f"k2_{str(dt)[6:]}", p0, image_xyz.to(dt).contiguous(), iu0, iv0, w, cfg.pixel_knn, k2_rows)
    k2_adv_rows = []
    check_k2_adversarial(dev, k2_adv_rows)

    # ---- card against CPU on the same weights, f32 ----
    small = KPConfig(
        fusion="early", in_features_dim=66, architecture=ARCHITECTURE_DEEPER,
        num_points=(1024, 256, 64, 32, 16), conv_neighbors=(16,) * 5,
        pool_neighbors=(16,) * 4, first_features_dim=32, num_views=3,
        image_height=24, image_width=32,
    )
    small_label = "ARCHITECTURE_DEEPER, N0=1024, width 32, 3 views 24x32"
    check_forward_parity("parity", f"{small_label}, f32", small, dev)

    # ---- the slice at full width ----
    full_row, launches = run_full("full", cfg, dev, batch, smi, busy=True)

    # ---- K3 and K4 at the conv sites of the bench pyramid ----
    pyr = build_pyramid(p0, m0, spec)
    enc, dec, _ = plan_architecture(cfg)
    n1 = pyr.points[1].shape[1]
    up_c = [e[1] for e in dec if "upsample" in e[0]][-1]  # the last upsample's width
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    k3_rows, k4_rows = [], []
    check_k3("k3_L0_simple", pyr.neighbors[0], cfg.num_points[0] + 1, enc[0][1], gen, k3_rows)
    check_k3("k3_L0_resnetb", pyr.neighbors[0], cfg.num_points[0] + 1, enc[1][2] // 4, gen, k3_rows)
    check_k3("k3_L0_strided", pyr.pools[0], cfg.num_points[0] + 1, enc[2][2] // 4, gen, k3_rows)
    check_k3("k3_L0_strided_maxpool", pyr.pools[0], cfg.num_points[0] + 1, enc[2][1], gen, k3_rows)
    check_k3("k3_L0_upsample", pyr.upsamples[0], n1 + 1, up_c, gen, k3_rows)
    # the fused path's conv gathers: positions ⊕ features, 3 + Cin wide
    check_k3("k3_L0_resnetb_fused", pyr.neighbors[0], cfg.num_points[0] + 1, 3 + enc[1][2] // 4, gen, k3_rows)
    check_k3("k3_L0_simple_fused", pyr.neighbors[0], cfg.num_points[0] + 1, 3 + enc[0][1], gen, k3_rows)
    # middle fusion's encoder_2d first block: ones ⊕ the lifted features
    c2d = cfg.feature_2d_dim + 1
    check_k3("k3_L0_simple_2d", pyr.neighbors[0], cfg.num_points[0] + 1, c2d, gen, k3_rows)
    check_k3("k3_L0_simple_2d_fused", pyr.neighbors[0], cfg.num_points[0] + 1, 3 + c2d, gen, k3_rows)
    k3_adv_rows = []
    check_k3_adversarial(pyr.neighbors[0], cfg.num_points[0] + 1, dev, gen, k3_adv_rows)
    # the deformable path's selections and deformed gathers (train_full_deform)
    check_deform_sites(deform_config(), levels, calls, gen, k1_rows, k3_rows)
    # the MVPNet path's pixel selection and PN2's gathers (train_mvpnet)
    mv_scenes = chunk_scenes(3, (120, 160))
    p1_rows = []
    index_ms, pre_shapes = check_mvpnet_kernels(dev, gen, mv_scenes, smi, k2_rows, k3_rows, p1_rows)
    top = len(pyr.points) - 1
    for name, q_l, s_l, inds, entry, cin, cout in (
        ("k4_L0_simple", 0, 0, pyr.neighbors[0], enc[0], enc[0][1], enc[0][2] // 2),
        ("k4_L0_resnetb", 0, 0, pyr.neighbors[0], enc[1], enc[1][2] // 4, enc[1][2] // 4),
        ("k4_L0_strided", 1, 0, pyr.pools[0], enc[2], enc[2][2] // 4, enc[2][2] // 4),
        (f"k4_L{top}_resnetb", top, top, pyr.neighbors[top], enc[-1], enc[-1][2] // 4, enc[-1][2] // 4),
    ):
        check_k4(name, pyr.points[q_l], pyr.masks[q_l], pyr.points[s_l], inds, cin, cout,
                 entry[3], cfg, gen, k4_rows)
    # middle fusion's first blocks: encoder_2d's on ones ⊕ the lifted features
    # (its input needs a gradient), encoder_3d's (and late fusion's) on the 2
    # base columns (no bwd_x)
    for name, cin, with_bwd_x in (("k4_L0_simple_2d", c2d, True),
                                  ("k4_L0_simple_3d", cfg.base_feature_dim, False)):
        check_k4(name, pyr.points[0], pyr.masks[0], pyr.points[0], pyr.neighbors[0], cin, enc[0][2] // 2,
                 enc[0][3], cfg, gen, k4_rows, bwd_x=with_bwd_x)
    # the levels between, one ``resnetb`` site each, held but not timed
    for l in range(1, top):
        entry = next(e for e in enc if e[4] == l and e[0] == "resnetb")
        check_k4(f"k4_L{l}_resnetb", pyr.points[l], pyr.masks[l], pyr.points[l], pyr.neighbors[l],
                 entry[2] // 4, entry[2] // 4, entry[3], cfg, gen, k4_rows, timed=False)
    del pyr
    k4_shape_rows = []
    check_k4_shapes(dev, gen, k4_shape_rows)

    # ---- train step: card against CPU on the same weights, f32 ----
    two_level = KPConfig(
        fusion="early", in_features_dim=66,
        architecture=("simple", "resnetb", "resnetb_strided", "resnetb", "nearest_upsample", "unary"),
        num_points=(256, 64), conv_neighbors=(10, 10), pool_neighbors=(10,),
        first_features_dim=32, num_views=2, image_height=24, image_width=32,
    )
    check_train_parity("train_parity", small_label, small, dev, resumed=True)
    check_train_parity("train_parity", "6 blocks, 2 levels, N0=256, width 32, 2 views 24x32", two_level, dev, resumed=False)

    # ---- the train step at full width ----
    train_row, train_launches = run_train_full("train_full", cfg, dev, batch, smi, busy=True)

    # ---- the fused KPConv path (K4): card against CPU, then full width ----
    for fusion in ("early", "middle", "late"):
        check_forward_parity("parity_fused", f"{small_label}, f32, fusion={fusion}, K4",
                             small.replace(fusion=fusion, **FUSED_OPTIONS), dev)
    check_train_parity("train_parity_fused", f"{small_label}, K4", small.replace(**FUSED_OPTIONS), dev, resumed=True)
    fused = fused_config()
    fused_row, fused_launches = run_full("full_fused", fused, dev, batch, smi, beside=full_row, busy=True)
    fused_train_row, fused_train_launches = run_train_full("train_full_fused", fused, dev, batch, smi,
                                                           beside=train_row, busy=True)

    # ---- middle and late fusion: card against CPU, then full width on both paths
    fusion_rows, fusion_paths = check_fusions(
        dev, batch, smi, small, small_label,
        {"full": full_row, "train_full": train_row, "full_fused": fused_row, "train_full_fused": fused_train_row})

    # ---- deformable MV-KPConv, the KPFCNN and KPCNN baselines ----
    other_paths = check_deform_and_baselines(dev, batch, smi, small, full_row, train_row)
    # ---- remat='blocks' at full width, beside the same steps without it
    remat_paths = {}
    for name, rcfg, beside in (("train_full_remat", cfg, train_row),
                               ("train_full_fused_remat", fused, fused_train_row)):
        row, remat_paths[name] = run_train_full(name, rcfg.replace(remat="blocks"), dev, batch, smi, beside=beside)
        # two steps from the same weights with and without remat, both under
        # deterministic algorithms: the pyramid's voxel barycenters are sums
        # by scatter_add_'s atomics, so two runs of one configuration differ
        # in the last bits of every level above 0, and in bf16 the timed
        # runs' warm-up losses part by up to 1.03e-5 relative (three runs on
        # an H100: 8.6e-7, 2.5e-6, 1.03e-5); on the CPU the two are equal bit
        # for bit (tests/test_torch_trainer.py). The first step's loss is the
        # forward's alone; the second step's, and the state after two steps,
        # are what the recomputing backward decides.
        with deterministic():
            without, with_remat = (remat_two_steps(c, dev, batch) for c in (rcfg, rcfg.replace(remat="blocks")))
        rel = abs(with_remat["losses"][1] - without["losses"][1]) / abs(without["losses"][1])
        over = allowance_over(with_remat["state"], without["state"])
        worst = max(over, key=over.get)
        emit({"phase": name + "_losses", "losses_deterministic": with_remat["losses"],
              "losses_deterministic_without": without["losses"], "rel_diff_second_step": rel,
              "state_worst": worst, "state_worst_over_allowance": over[worst],
              "rel_diff_timed_runs": abs(row["loss_warmup"] - beside["loss_warmup"]) / abs(beside["loss_warmup"]),
              "losses": row["losses"], "losses_without": beside["losses"],
              "peak_mem_gib": row["peak_mem_gib"], "peak_mem_gib_without": beside["peak_mem_gib"]})
        assert rel <= TRAIN_LOSS_REL, "remat='blocks' changed the second step's loss"
        assert over[worst] <= 1.0, f"remat='blocks' changed the state after two steps: {worst}"
        assert row["peak_mem_gib"] < beside["peak_mem_gib"], "remat='blocks' kept as much memory"

    # ---- the training entry point: train_scannet, resume, frozen 2D, test_models,
    # run as a user runs them: PyTorch's TF32 defaults (cuDNN on, matmul off)
    with tempfile.TemporaryDirectory() as tmp:
        torch.backends.cudnn.allow_tf32 = True
        entry_paths = check_train_scannet(dev, smi, Path(tmp))
        entry_paths.update(check_cli_fusions(dev, smi, Path(tmp)))
        torch.backends.cudnn.allow_tf32 = False
        check_trainer_parity(dev, small, Path(tmp))
        # ---- the mvpnet fork's workflow: train_2d, test_2d, train_mvpnet,
        # test_mvpnet, the PN2 baseline, precompute_2d; as a user runs them
        torch.backends.cudnn.allow_tf32 = True
        mvpnet_paths = check_mvpnet_workflow(dev, smi, Path(tmp), mv_scenes, index_ms, pre_shapes)
        torch.backends.cudnn.allow_tf32 = False
    mvpnet_parity = check_mvpnet_parity(dev, smi)
    # ---- a JAX run resumed with its optimizer state, deformable inspection
    # at full width, the serving export on both paths, the variant matrix
    small_middle = small.replace(fusion="middle", batch_num=2)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        serving_paths = {"resume_jax_run": check_resume_jax_run(dev, small, tmp),
                         "inspect_deform_full": check_inspect_deform(dev, raw, smi, tmp),
                         "export_full": check_export("export_full", cfg, dev, batch, smi, full_row, tmp),
                         "export_full_fused": check_export("export_full_fused", fused, dev, batch, smi,
                                                           fused_row, tmp),
                         "export_full_late": check_export("export_full_late", fusion_config("late"), dev, batch,
                                                          smi, fusion_rows["full_late"], tmp),
                         "export_small_middle": check_export(
                             "export_small_middle", small_middle, dev,
                             batch_to_device(make_batch(small_middle, 2, np.random.RandomState(1)), dev), smi, None,
                             tmp, label=f"{small_label}, B=2, fusion=middle, f32"),
                         "export_mvpnet": check_export_mvpnet(dev, smi, mv_scenes, tmp)}
        torch.backends.cudnn.allow_tf32 = True  # as a user runs the tool
        serving_paths.update(check_measure_variants(dev, tmp))
        torch.backends.cudnn.allow_tf32 = False
    # ---- custom-dataset inference: the native host ops, test_colmap on a
    # COLMAP workspace of a 1,000,000-point scan (PyTorch's TF32 defaults),
    # then card against CPU (TF32 off)
    with tempfile.TemporaryDirectory() as tmp:
        custom_paths = check_custom_dataset(dev, smi, Path(tmp), k1_rows, k2_rows)
    # ---- data parallelism: two gloo processes on this card, NCCL at world size 1
    ddp_paths = check_ddp(dev, raw, smi)
    by_path = {"full": launches, "train_full": train_launches, "full_fused": fused_launches,
               "train_full_fused": fused_train_launches, **fusion_paths, **other_paths, **remat_paths, **entry_paths,
               **mvpnet_paths, **mvpnet_parity, **custom_paths, **serving_paths, **ddp_paths}

    def path_launches(*names):
        """Each full-width run's launches of a kernel, over its forwards or steps."""
        return {path: {n: counts[n] for n in names} for path, counts in by_path.items()}

    l0 = k1_rows[0]
    bf16 = k2_rows[0]
    # K3 as the default path hands it its rows: f32, rounded by the kernel
    k3_main = next(r for r in k3_rows if r["phase"] == "k3_L0_resnetb_float32_round")
    k3_bf16 = next(r for r in k3_rows if r["phase"] == "k3_L0_resnetb_bfloat16")
    k4_main = next(r for r in k4_rows if r["phase"] == "k4_L0_resnetb_bfloat16")
    k2_mvpnet = next(r for r in k2_rows if r["phase"] == "k2_mvpnet_float32")
    k2_pre = [r for r in k2_rows if r["phase"].startswith("k2_precompute_")]
    k3_pn2 = [r for r in k3_rows if r["phase"].startswith("k3_pn2_")]
    k1_colmap = next(r for r in k1_rows if r["phase"] == "k1_L0_conv_colmap")
    k2_colmap = next(r for r in k2_rows if r["phase"] == "k2_colmap_bfloat16")

    fusion_site_names = ("k3_L0_simple_2d", "k4_L0_simple_2d", "k4_L0_simple_3d")

    def k4_entry(name, part, count):
        return {"name": name, "route": "cuda", "source": "mvkpconv_tpu_torch/csrc/kpconv.cu",
                "replaces": "mvkpconv_tpu/ops/pallas/kpconv.py:135", "launches": count,
                "max_abs_err": max(r[f"{part}_max_abs_err"] for r in k4_rows + k4_shape_rows
                                   if f"{part}_max_abs_err" in r),
                "ms": k4_main[part]["ms"], "plain_ms": k4_main[part]["plain_ms"],
                "bound_ms": k4_main[part]["bound_ms"], "bound_by": k4_main[part]["bound_by"],
                "library_ms": None,
                # middle and late fusion's first blocks (timed like the level-0 sites)
                "fusion_sites": [{"phase": r["phase"], "cin": r["cin"], "cout": r["cout"],
                                  **{x: r[part][x] for x in ("ms", "plain_ms", "bound_ms", "bound_by")}}
                                 for r in k4_rows if r["phase"].startswith(fusion_site_names) and part in r]}

    emit({"kernels": [
        {"name": "radius_topk", "route": "cuda", "source": "mvkpconv_tpu_torch/csrc/radius_topk.cu",
         "replaces": "mvkpconv_tpu/ops/pallas/radius_topk.py:121",
         "launches": launches["radius_topk"],
         "device_launches": launches["radius_topk_device"],
         "launches_by_path": path_launches("radius_topk", "radius_topk_device"),
         "max_abs_err": max(r["max_d2_gap"] for r in k1_rows + k1_adv_rows),
         "ms": l0["ms"], "plain_ms": l0["plain_ms"], "bound_ms": l0["bound_ms"],
         "bound_by": l0["bound_by"], "library_ms": None,
         "colmap_shape": {x: k1_colmap[x] for x in ("b", "nq", "ns", "k", "ms", "plain_ms", "bound_ms", "bound_by",
                                                    "pairs_in_radius", "rows_differ")}},
        {"name": "pixel_topk", "route": "cuda", "source": "mvkpconv_tpu_torch/csrc/pixel_select.cu",
         "replaces": "mvkpconv_tpu/ops/pallas/pixel_select.py:97",
         "launches": launches["pixel_topk"], "launches_by_path": path_launches("pixel_topk"),
         "max_abs_err": max(r["max_d2_gap"] for r in k2_rows + k2_adv_rows),
         "timing": "device time, torch.profiler",
         "ms": bf16["ms"], "plain_ms": bf16["plain_ms"], "bound_ms": bf16["bound_ms"],
         "bound_by": bf16["bound_by"], "library_ms": None,
         "earlier_ms": bf16.get("earlier_ms"), "earlier_from": EARLIER_FROM,
         "mvpnet_shape": {x: k2_mvpnet[x] for x in ("b", "n", "views", "hw", "window", "dtype", "ms", "plain_ms",
                                                     "bound_ms", "bound_by", "rows_differ")},
         "precompute_shape": [{x: r.get(x) for x in ("phase", "b", "n", "real_points", "views", "hw", "window", "k",
                                                     "dtype", "ms", "plain_ms", "bound_ms", "bound_by",
                                                     "rows_differ", "max_d2_gap")} for r in k2_pre],
         "colmap_shape": {x: k2_colmap[x] for x in ("b", "n", "real_points", "views", "hw", "window", "dtype", "ms",
                                                     "plain_ms", "bound_ms", "bound_by", "rows_differ", "in_view")}},
        {"name": "segsum", "route": "cuda", "source": "mvkpconv_tpu_torch/csrc/segsum.cu",
         "replaces": "mvkpconv_tpu/ops/pallas/segsum.py:284",
         "launches": train_launches["segsum"], "plan_launches": train_launches["segsum_plan"],
         "launches_by_path": path_launches("segsum", "segsum_plan"),
         "max_abs_err": max(r["max_abs_err"] for r in k3_rows + k3_adv_rows),
         "timing": "device time, torch.profiler; ms with the index's plan cached",
         "plan_ms": k3_main["plan_ms"], "first_call_ms": k3_main["first_call_ms"],
         "ms": k3_main["ms"], "plain_ms": k3_main["plain_ms"], "bound_ms": k3_main["bound_ms"],
         "bound_by": k3_main["bound_by"], "library_ms": k3_main["library_ms"],
         "library_of": "index_add_ of the same f32 rows (one call; it cannot round them)",
         "instance": "level-0 resnetb site, f32 rows with round_bf16, as the default path hands them",
         "earlier_ms": k3_main["earlier_ms"], "earlier_cast_ms": k3_main["earlier_cast_ms"],
         "earlier_from": EARLIER_FROM + ": the cast to bf16, then the kernel on bf16 rows",
         "bf16_rows": {x: k3_bf16[x] for x in ("ms", "bound_ms", "earlier_ms", "library_ms")},
         "pn2_sites": [{x: r[x] for x in ("phase", "nq", "k", "ns", "c", "ms", "first_call_ms", "plan_ms",
                                          "plain_ms", "library_ms", "bound_ms", "bound_by", "err_over_allowance")}
                       for r in k3_pn2],
         "fusion_sites": [{x: r[x] for x in ("phase", "c", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                             "err_over_allowance")}
                          for r in k3_rows if r["phase"].startswith(fusion_site_names)]},
        {**k4_entry("kpconv_fused", "fwd", fused_launches["kpconv_fused_fwd"]),
         "einsum_chain_ms": k4_main["fwd"]["einsum_chain_ms"],
         "launches_by_path": path_launches("kpconv_fused_fwd")},
        {**k4_entry("kpconv_fused_bwd_x", "bwd_x", fused_train_launches["kpconv_fused_bwd_x"]),
         "launches_by_path": path_launches("kpconv_fused_bwd_x")},
        {**k4_entry("kpconv_wf", "wf", fused_train_launches["kpconv_wf"]),
         "launches_by_path": path_launches("kpconv_wf")},
        {"name": "farthest_point_sample", "route": "cuda", "source": "mvkpconv_tpu_torch/csrc/fps.cu",
         "replaces": "mvkpconv_tpu/ops/sampling.py:47 (P1, port-only: the JAX FPS is a lax.fori_loop, "
                     "no pl.pallas_call)",
         "launches": mvpnet_paths["train_mvpnet"]["farthest_point_sample"],
         "launches_by_path": path_launches("farthest_point_sample"),
         "max_abs_err": max(r["max_abs_err"] for r in p1_rows),
         "design": "fps_kernel<K, kCluster>: a cloud a thread-block cluster of 1-8 CTAs (fps.plan(N)), points "
                   "by index in registers, warp winners stored into every CTA by st.async (DSMEM), a transaction "
                   "mbarrier the step's one barrier",
         "timing": "CUDA events; ms at PN2SSG's first level (4 x 8192 -> 2048)",
         "ms": p1_rows[0]["ms"], "plain_ms": p1_rows[0]["plain_ms"], "bound_ms": p1_rows[0]["bound_ms"],
         "bound_by": p1_rows[0]["bound_by"], "library_ms": None, "serial_steps": p1_rows[0]["serial_steps"],
         "us_per_step": p1_rows[0]["us_per_step"], "plan": p1_rows[0]["plan"],
         "levels": [{x: r[x] for x in ("phase", "b", "n", "s", "plan", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "serial_steps", "us_per_step", "device_ms", "device_us_per_step")}
                    for r in p1_rows[:len(PN2_LEVELS)]]},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
