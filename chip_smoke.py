#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cavp_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

from the repository root, on a machine with a CUDA GPU and ``nvcc``. It:

1. prints the card (``nvidia-smi`` name and power limit) and the torch,
   CUDA and nvcc versions;
2. builds the CUDA kernels from ``cavp_tpu_torch/csrc`` and prints the
   build time and ptxas's register report;
3. holds the fusion kernel against its plain PyTorch version on the card
   (float32 with TF32 off; bf16 at the eval shape [120, 3136, 304], the
   serving bucket's [8, 3136, 304], B = 1, phase 13's eval step [80, 16384,
   304], and token counts that are not a
   multiple of the kernel's 64-token tile; two bf16 launches must be
   bit-equal) and times both at [120, 3136, 304] bf16, the wrapper and the
   launch alone, beside the module path (``CAVP.forward_fusion``) the plain
   eval step runs;
4. serves requests of 1, 5, 8 and 11 images through ``Predictor`` (avss,
   224x224, bf16, fusion kernel on, batch bucket 8), checks the masks,
   that the kernel ran, and that they agree with the same Predictor on
   the plain fusion path;
5. runs ``make_eval_step`` at batch 120 with the kernel and with the
   plain fusion path and prints frames/s for both;
6. holds the train fusion kernels (forward and backward) against their
   plain PyTorch versions: float32 with TF32 off and bf16 at
   [32, 3136, 304] and at phase 13's train step [16, 16384, 304], float32
   at a ragged token count (3199) and at C = 112;
   the bf16 forward also at [8, 3136, 304] and B = 1, two launches of it
   bit-equal; every one of dx, dwqk, dm and the 17 weight gradients is
   compared, two backward launches must give bit-equal gradients; the bf16 backward's
   three launches are also held apart (stage A's operands against the plain
   backward's, stage B + the reduction against float32 products of the same
   operands) and timed one by one, and the kernels are timed beside their
   plain versions and autograd through the module path;
7. takes train steps through ``make_train_step`` (avss, batch 32, 224x224,
   bf16, ``use_pallas_fusion_train``): one at epoch 0 and three at epoch 1,
   checks the loss, the CoroCL term, that every optimizer group and the
   sound bank moved and that each step launched the forward and each of the
   backward's three kernels once,
   then takes the same steps from the same state on the module path and
   prints step time, frames/s and peak memory of both;
8. holds the log-mel kernel against the function in float64, beside its
   plain version and the unfused ``preprocess_audio`` (float32, 120, 8, 16
   and 80 rows of 16000 samples, a frame count that is no multiple of the kernel's
   tile, a tone over a noise floor, the 60-7000 Hz band, and the VPO setups'
   32 rows of 48000 samples -> 300 frames, also as 16 stereo clips through
   ``preprocess_audio``, whose rows 2i + c must be clip i's channel c; two
   launches bit-equal), and times it (also at the VPO shape) beside the
   plain version, the unfused
   frontend and a composition of ``torch.fft.rfft``, power, filterbank and
   log, with its bound and the old dense design's;
9. holds the upsample + argmax kernel against its plain version: bit-equal
   masks for bf16 at [120, 56, 56, 71] -> 224 x 224 and [8, ...], at
   phase 13's [80, 128, 128, 71] -> 512 x 512, at a ragged size, with exact ties planted and on a tie-heavy input (logits
   of five values), at the binary setup's 2 classes ([120, 56, 56, 2]
   and [16, ...] -> 224 x 224, a ragged [3, 30, 41, 2] -> 97 x 131, a
   tie-heavy batch) and at the VPO validation's 22 classes and the VPO
   setups' own 24 ([16, 128, 128, C] -> 512 x 512, a tie-heavy batch, a
   ragged [3, 30, 41, 22]); two bf16 launches bit-equal (at 71, 2, 22 and 24
   classes); float32 equal wherever the top two resized logits differ by
   more than 1e-5; timed beside ``F.interpolate`` + ``argmax`` at 71, 2 and
   22 classes;
10. holds the fused layer1 kernels against their plain version on the stem
    output of real batches: float32 (TF32 off) and bf16 at B = 120 and
    B = 8, bf16 at a ragged map (37 x 45), at the 128-wide map of
    512-square images (B = 2 and phase 13's eval step, B = 80) and at a
    200-wide map, and float32 at the 128-wide
    map; two bf16 launches bit-equal; timed beside the ``layer1`` modules;
11. runs the eval step at batch 120 and the ``Predictor`` requests of
    phase 4 with every kernel flag on (mel, layer1, fusion, argmax):
    checks that each step launched each of the four eval kernels once
    (layer1 once for each bottleneck), that the masks agree with the all-plain arm, that the argmax kernel
    leaves the fusion-kernel arm's masks and accumulators bit-equal, and
    prints frames/s of the all-kernels, the fusion-kernel and the plain
    arm;
12. runs the evaluation entry point ``python -m
    cavp_tpu_torch.test_avs_semantic`` on an AVSBench-Semantics test split
    written to disk (24 videos, 8 each of v1s, v1m and v2: 160 valid frames
    at 224x224, 71 classes; the masks rewritten with the plain path's
    confident predictions) and the seeded model saved as a reference
    ``.pth``, with every eval kernel flag
    on and with every flag off: once each as its own process (exit 0, both
    metric lines), then twice each in this process, where it checks that the
    strict load reports nothing missing or unexpected, that the kernel arm
    launched each of the four eval kernels on every eval step (layer1 once a
    bottleneck) and the plain arm none, that ``run_validation`` made one host
    sync (``torch.cuda.set_sync_debug_mode``), that the masks its eval steps
    predicted in the kernel arm agree with the plain arm's on 99.5% of the
    pixels (``VALIDATION_MASK_AGREEMENT``), and that the two arms' ten
    metrics agree within phase 11's mel-arm limit; it prints frames/s
    (decode included), the share of the loop spent waiting on the loader
    and the decoder (PIL) with its distance from PIL's decode;
13. runs the training entry point ``python -m
    cavp_tpu_torch.main_avss_resize`` at the avss setup's own size (512x512
    under ``--resize_flag`` from 224x224 files, batch 16, bf16, 71 classes)
    on a train split of 48 videos (16 each of v1s, v1m and v2: 3 steps an
    epoch) and a test split of 24, with every kernel flag: once as its own
    process in a working directory of its own (2 epochs, 6 steps, the
    validation at epoch 0; 8 loader threads; exit 0), then in this process,
    with one loader thread so that both arms draw the same batches: the
    kernel arm is preempted after its third step by a SIGTERM to ``PreemptionSignal``,
    where it checks the launches (K2's forward and its three backward
    kernels and K3 once a train step, K1, K3, K4 and K5 on every eval step,
    K5 once a bottleneck), the host syncs under
    ``torch.cuda.set_sync_debug_mode`` (none in a train step or its batch
    upload; the lagged metric read waits on the previous display point's
    event only; the process's first step at the size fills the caches),
    finite losses with CoroCL above 0, that every optimizer
    group and the sound bank moved, and that the ``preempt`` file is
    bit-equal to the live state; then it resumes from that file (epoch 1 at
    step 3, the schedule's lr, exit normal) and runs the plain arm (no
    launch; its first step's loss, cross-entropy and CoroCL terms within
    phase 7's limit of the kernel arm's, on the same batch from the same
    state); it prints steps/s and frames/s with the loader, the loader's
    wait share, peak memory, the checkpoints' sizes and times and the
    process wall time;
14. runs the binary setup and the AVSBench-Object J&F test at their own
    sizes: ``avss_binary`` (224x224, 2 classes, batch 16, bf16, every kernel
    flag) through ``python -m cavp_tpu_torch.main_avss_resize --setup
    avss_binary --resize_flag`` (one epoch of 3 steps and a validation) and
    ``python -m cavp_tpu_torch.test_avss_resize`` on S4 (v1s) and MS3 (v1m)
    test splits of 8 videos (4 a batch), the seeded 2-class model saved as a
    reference ``.pth`` and the masks rewritten from its own predictions:
    three processes side by side (exit 0, the metric lines, no load
    warnings), then in this process: the training kernel arm (K2's forward
    and backward kernels and K3 once a train step, K1, K3, K4 at 2 classes
    and K5 on every eval step; no host sync in a train step after the first;
    finite losses; every optimizer group moved, the sound bank not), the
    plain arm (no launch; its first step within phase 7's limit), the J&F
    test with every eval kernel flag given (no launch, as in the JAX
    package; the strict load clean; finite mIoU, F and J&F), and both entry
    points with ``--use_baseline`` (K3 on each eval step, nothing else);
    it prints steps/s, frames/s with the loader, the J&F videos/s and the
    peak memory;
15. runs the VPO training entry points at the setups' own size (512x512
    COCO crops, batch 16, bf16, ResNet-101 at output stride 8, the ResNet-18
    audio tower on 3 s of audio, 22 classes, every kernel flag) on synthetic
    VPO trees (48 train images of mixed sizes, 32 test images at 512x512):
    first K5, K1 and K2 (forward and backward) against their plain versions
    on the features of those towers; then ``python -m
    cavp_tpu_torch.main_vpo_mono --setup vpo_ss`` and ``python -m
    cavp_tpu_torch.main_vpo_stereo --setup vpo_ms`` (multi-source mixtures,
    flip-mirrored panning), one epoch of 3 steps and a validation of 2 steps
    each, as processes (exit 0, the metric lines) and in this process: the
    kernel arm (K2's forward and backward kernels and K3 once a train step,
    K1, K3, K4 at 22 classes and K5 on every eval step; no host sync in a
    train step after the first; every optimizer group moved; the sound bank
    moved under vpo_mono and not under vpo_stereo) and the plain arm (no
    launch, its first step within phase 7's limit); it prints the steps on
    the stream (CUDA events), steps/s and frames/s with the loader, the
    loader's wait share, the peak memory and the validation's frames/s;
16. runs the seg-model zoo at full width (``--seg_model HRNet``: HRNet-W48,
    latent 720; ``OCR`` on HRNet-W48, 512; ``PVT``: PVT-v2 b5, 112) at
    224x224, bf16, 71 classes: for each head K1 at [120, 3136, C] on the
    head's own features against its plain version (phase 3's limits, two
    launches bit-equal; timed beside the plain version and the module path,
    with its bound), K4 on the head's own logits bit-equal to the separable
    arm, the eval step with every kernel flag (K1, K3 and K4 once a step, K5
    and K2 never: they are for DeepLabV3+ on ResNet) and its frames/s, the
    all-flags masks against the plain arm's; then ``python -m
    cavp_tpu_torch.test_avs_semantic --seg_model HRNet`` with every eval
    kernel flag on a synthetic test split and the HRNet model's ``.pth``, a
    process (exit 0, the metric line, a clean strict load); then two train
    steps of ``main_avss_resize --seg_model OCR`` (224x224, batch 16, every
    kernel flag) in this process: the module arm (no K2 launch), K3 on every
    step, K1 at C = 512 and K4 on the validation's eval steps, every
    optimizer group moved, the peak memory.

The weights are random, drawn from a seed, and made non-degenerate (see
``random_weights``) so the comparisons are not empty. The numbers printed
are measurements of the port on this card, not a benchmark. With
``--profile`` it also prints a ``torch.profiler`` table of one train step,
and of one eval step at batch 120 with every kernel flag on, with that
step's device time split by kernel group and the device's idle share.
Every phase fails loudly; the last line is ``{"ok": true, "device":
{...}}`` only when all of them passed.
Without a CUDA device, or without the package beside it, it exits 1.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
BENCH_SHAPE = (120, 3136, 304)  # eval batch x 56*56 tokens x DeepLab feature
TRAIN_SHAPE = (32, 3136, 304)   # train batch x 56*56 tokens x DeepLab feature
TRAIN_BATCH = 32
# phase 13's shapes, which phases 3, 6 and 8-10 also hold the kernels at:
# 512x512 images under --resize_flag (128*128 tokens, logits upsampled
# 128 -> 512), the avss setup's train batch of 16, and eval steps of 8
# videos x 10 frame slots
RESIZE_SIDE = 512
RESIZE_TOKENS = (RESIZE_SIDE // 4) ** 2
RESIZE_TRAIN_BATCH = 16
RESIZE_EVAL_FRAMES = 80
# H100 SXM data sheet: dense bf16 tensor rate, float32 rate outside the
# tensor cores, dense TF32 tensor rate, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
# gradients, float32 kernels against plain: the tests' 1e-4 x max|grad|.
# bf16: both round at the same points, so they differ where another float
# summation order flips a bf16 rounding of an intermediate; that error is
# then carried through the later products
GRAD_F32_REL = 1e-4
GRAD_BF16_REL = 3e-2
# first train step, kernel arm against module arm, bf16: the two round the
# fusion stage at different points
LOSS_REL = 2e-2
F32_TOL = dict(rtol=1e-4, atol=5e-5)  # tests/test_pallas_fusion.py's
# bf16: both versions round at the same points, so they differ only where
# a different f32 summation order flips a bf16 rounding; outputs of the
# final LayerNorm reach |y| ~ 5-8, where one bf16 ulp is 0.03-0.06
BF16_MAX_ABS = 0.125
BF16_MEAN_ABS = 0.005
MASK_AGREEMENT = 0.99
REQUEST_SIZES = (1, 5, 8, 11)
EVAL_BATCH = 120
# log-mel kernel against the function in float64, on the [-1, 1] output
# scale (a dB is 0.01): within MEL_ATOL, or within twice the plain version's
# distance plus 1e-7 where the plain float32 version is itself further. The
# kernel sums on the tensor cores, in another order than the float32 matrix
# products of the plain version, and where a band's power comes from the
# cancellation of large terms (noise near a bin's null, a tone's leakage)
# each float32 order is more than MEL_ATOL from the exact function
MEL_ATOL = 2e-6
# the mel kernel's 1e-7 differences move a few bf16 roundings of the audio
# tower's input, and the seeded random model turns those into flipped
# pixels (measured 0.08%): the masks behind it are nearly, not bitwise, the
# same, and the metrics move in the third decimal
MEL_MASK_AGREEMENT = 0.995
MEL_METRIC_ATOL = 5e-3
# phase 12, the masks of every eval step of the entry point with every
# kernel flag against every flag off: phase 11's mel-arm limit, the
# stricter of its two (its all-flags arm against plain read 99.814%)
VALIDATION_MASK_AGREEMENT = MEL_MASK_AGREEMENT
# layer1, float32 kernel against plain (TF32 off): other summation orders
L1_F32_TOL = dict(rtol=1e-5, atol=1e-5)
# layer1, bf16: both round at the same points and differ where another
# float32 summation order flips a rounding, carried through three blocks;
# limits relative to the largest output (tests/test_layer1_kernel.py's 0.02)
L1_BF16_MAX_REL = 0.02
L1_BF16_MEAN_REL = 1e-3


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def random_weights(model, config, device) -> None:
    """Make the seeded random model a non-degenerate one to compare on.

    LayerNorm and BatchNorm affines move off 1/0 (the Conv and Linear
    biases are random from the init). Every BatchNorm's running
    statistics are then set, layer by layer, to those of its input on
    one seeded batch, so activations stay normalized through the towers;
    without this the logits are near-constant and any rounding flips
    most argmaxes. Last, each bottleneck's final BatchNorm scale is cut
    10x, so every residual branch adds a tenth of the identity path, as
    zero-init-residual schemes start: an undamped random 50-layer tower
    is chaotic, and bf16 rounding alone then changes most masks."""
    import numpy as np
    import torch
    import torch.nn as nn

    from cavp_tpu_torch.engine.loops import preprocess_audio

    g = torch.Generator().manual_seed(SEED)
    bns = []
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                n = m.weight.shape
                m.weight.copy_(1.0 + 0.2 * torch.randn(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
            if isinstance(m, nn.BatchNorm2d):
                bns.append((name, m))

        def calibrate(m, args):
            x = args[0].float()
            m.running_mean.copy_(x.mean((0, 2, 3)))
            m.running_var.copy_(x.var((0, 2, 3), unbiased=False) + 1e-3)

        rng = np.random.RandomState(SEED + 3)
        n, h, w = 8, config.image_height, config.image_width
        img = torch.from_numpy(rng.randint(0, 256, (n, h, w, 3)).astype(np.float32))
        mean = torch.tensor(config.image_mean)
        std = torch.tensor(config.image_std)
        img = ((img / 255.0 - mean) / std).to(device).permute(0, 3, 1, 2)
        wave = ((rng.rand(n, config.in_plane, config.audio_samples) - 0.5) * 0.2)
        audio = preprocess_audio(torch.from_numpy(wave.astype(np.float32)).to(device),
                                 n_frames=config.mel_frames).permute(0, 3, 1, 2)
        hooks = [m.register_forward_pre_hook(calibrate) for _, m in bns]
        try:
            model(img, audio)
        finally:
            for hk in hooks:
                hk.remove()
        for name, m in bns:
            if name.endswith(".bn3"):
                m.weight.mul_(0.1)


def cuda_ms(fn, iters: int) -> float:
    """Median milliseconds of ``fn()`` over ``iters`` CUDA-event-timed runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(fn, launches: int = 50, repeats: int = 3) -> float:
    """Median over ``repeats`` of the mean milliseconds of ``fn()`` in a row
    of ``launches`` calls between two CUDA events: the device's time, with
    the host's work of each call overlapped by the launches before it
    (``cuda_ms`` times one call at a time, host work included, which shows
    for a kernel of tens of microseconds)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> tuple:
    """The least time the card could take: (ms, what bounds it)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def chain_flops_per_token(C: int, hidden: int, mlp_hidden: int, heads: int):
    """(shared prefix with fc2 and patch_embed_v apart, one gated half):
    two operations per multiply-add of every product of the token chain."""
    prefix = 2 * (C * hidden + hidden * C + C * C)
    half = 2 * (2 * C * heads + 2 * C * mlp_hidden)
    return prefix, half


def kernel_phase(model, device) -> dict:
    """Phase 3: the fusion kernel against its plain version."""
    import torch

    from cavp_tpu_torch.models.cavp import tokens_to_map
    from cavp_tpu_torch.ops.kernels.fusion import (
        TILE_TOKENS, _launch as fusion_launch, fused_visual_fusion,
        fused_visual_fusion_reference, fusion_operands, tile_walk)

    g = torch.Generator().manual_seed(SEED + 1)
    C = BENCH_SHAPE[2]

    def inputs(b, n, dtype):
        x = torch.randn(b, n, C, generator=g).to(device, dtype)
        a = torch.randn(b, C, generator=g).to(device, dtype)
        return x, a

    def compare(b, n, dtype):
        x, a = inputs(b, n, dtype)
        got = fused_visual_fusion(model, x, a)
        again = fused_visual_fusion(model, x, a)
        ref = fused_visual_fusion_reference(model, x, a)
        torch.cuda.synchronize()
        require(got.shape == ref.shape and got.dtype == ref.dtype == dtype,
                f"kernel output {got.shape} {got.dtype} vs {ref.shape} {ref.dtype}")
        require(bool(torch.equal(got, again)), f"two launches differ at [{b},{n},{C}]")
        require(bool(torch.isfinite(got).all()), "non-finite kernel output")
        err = (got.float() - ref.float()).abs()
        return got, ref, float(err.max()), float(err.mean())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for name, (b, n) in (("f32", (2, 3136)), ("f32_ragged", (3, 7 * 9 + 3136))):
        got, ref, mx, mean = compare(b, n, torch.float32)
        torch.testing.assert_close(got, ref, **F32_TOL)
        print(f"[kernel] {name} [{b},{n},{C}]: max_abs_err {mx:.3e} "
              f"mean_abs_err {mean:.3e} (rtol 1e-4, atol 5e-5: ok)")
        results[name] = mx
    for name, (b, n) in (("bf16_ragged", (3, 7 * 9)), ("bf16_ragged_3199", (3, 3199)),
                         ("bf16_b1", (1, BENCH_SHAPE[1])),
                         ("bf16_bucket8", (8, BENCH_SHAPE[1])),
                         ("bf16_resize_eval", (RESIZE_EVAL_FRAMES, RESIZE_TOKENS)),
                         ("bf16", BENCH_SHAPE[:2])):
        _, _, mx, mean = compare(b, n, torch.bfloat16)
        ok = mx <= BF16_MAX_ABS and mean <= BF16_MEAN_ABS
        print(f"[kernel] {name} [{b},{n},{C}]: max_abs_err {mx:.3e} "
              f"mean_abs_err {mean:.3e} (max {BF16_MAX_ABS}, mean "
              f"{BF16_MEAN_ABS}: {'ok' if ok else 'FAIL'}; two launches bit-equal)")
        require(ok, f"bf16 kernel disagrees with the plain version ({name})")
        results[name] = mx

    x, a = inputs(*BENCH_SHAPE[:2], torch.bfloat16)
    side = int(BENCH_SHAPE[1] ** 0.5)

    @torch.inference_mode()
    def module_path():  # what the eval step runs with use_pallas_fusion off
        return model.forward_fusion(tokens_to_map(x, side, side), a)

    ops = fusion_operands(model, a, torch.bfloat16)
    arms = {"kernel": lambda: fused_visual_fusion(model, x, a),
            "plain": lambda: fused_visual_fusion_reference(model, x, a),
            "module": module_path, "launch": lambda: fusion_launch(x, ops, 4)}
    launches = fused_visual_fusion.launches
    iters, times = 10, {k: [] for k in arms}
    for arm in ("plain", "kernel", "launch", "module", "module", "launch", "kernel", "plain"):
        times[arm].append(cuda_ms(arms[arm], iters))
    fused_visual_fusion.launches = launches
    results["ms"] = statistics.median(times["kernel"])
    results["launch_ms"] = statistics.median(times["launch"])
    results["plain_ms"] = statistics.median(times["plain"])
    results["module_ms"] = statistics.median(times["module"])
    tokens = BENCH_SHAPE[0] * BENCH_SHAPE[1]
    # the eval chain folds fc2 with patch_embed_v: one C x C product fewer
    flops = tokens * 2 * (C * 256 + 256 * C + 2 * C * 4 + 2 * C * 4 * C)
    results["bound_ms"], results["bound_by"] = bound_ms(flops, 2 * tokens * C * 2)
    fmt = lambda k: " / ".join(f"{t:.3f}" for t in times[k])
    walk = tile_walk(BENCH_SHAPE[0], BENCH_SHAPE[1],
                     torch.cuda.get_device_properties(device).multi_processor_count)
    print(f"[kernel] time at {list(BENCH_SHAPE)} bf16, median of {iters} "
          f"(plain, kernel, launch, module, module, launch, kernel, plain): wrapper "
          f"{fmt('kernel')} ms, launch alone {fmt('launch')} ms, plain {fmt('plain')} ms, "
          f"module path {fmt('module')} ms ({tokens / results['ms'] / 1e3:.1f} M tokens/s with "
          f"the wrapper; {flops / results['launch_ms'] / 1e9:.1f} TFLOP/s in the launch; "
          f"{len(walk)} blocks walk {sum(map(len, walk))} tiles of {TILE_TOKENS} tokens)")
    return results


def serving_requests(config) -> list:
    """Seeded requests of ``REQUEST_SIZES`` frames: (uint8 images, waveforms)."""
    import numpy as np

    rng = np.random.RandomState(SEED + 2)
    h, w = config.image_height, config.image_width
    cin, length = config.in_plane, config.audio_samples
    return [(rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8),
             ((rng.rand(n, cin, length) - 0.5) * 0.2).astype(np.float32))
            for n in REQUEST_SIZES]


def serving_phase(config, state_dict, device) -> int:
    """Phase 4: Predictor requests through the kernel, against the plain
    fusion path. Returns the kernel's launches while serving."""
    import numpy as np
    import torch

    from cavp_tpu_torch.engine.predictor import Predictor
    from cavp_tpu_torch.ops.kernels.fusion import fused_visual_fusion

    requests = serving_requests(config)
    fused = Predictor(config, device=device, batch_sizes=(8,),
                      state_dict=state_dict).warmup()
    fused_visual_fusion.launches = 0
    masks, times = [], []
    for images, waves in requests:
        t0 = time.perf_counter()
        out = fused.predict(images, waves)["mask"]  # ends in a device->host copy
        times.append((time.perf_counter() - t0) * 1e3)
        require(out.shape == images.shape[:3] and out.dtype == np.int32,
                f"mask {out.shape} {out.dtype} for {images.shape}")
        require(0 <= out.min() and out.max() < config.num_classes, "mask range")
        masks.append(out)
    launches = fused_visual_fusion.launches
    require(launches > 0, "the serving path never launched the fusion kernel")
    del fused

    plain = Predictor(config.replace(use_pallas_fusion=False), device=device,
                      batch_sizes=(8,), state_dict=state_dict)
    for (images, waves), mask, ms in zip(requests, masks, times):
        agree = float((plain.predict(images, waves)["mask"] == mask).mean())
        print(f"[serve] request of {len(images)}: {ms:.1f} ms, masks agree "
              f"with the plain fusion path on {100 * agree:.3f}% of pixels")
        require(agree >= MASK_AGREEMENT, f"masks agree on only {agree:.4f}")
    del plain
    torch.cuda.empty_cache()
    print(f"[serve] kernel launches while serving: {launches}; median latency "
          f"per request {statistics.median(times):.1f} ms "
          f"(sizes {list(REQUEST_SIZES)}, bucket 8)")
    return launches


ALL_FLAGS = dict(use_pallas_fusion=True, use_pallas_mel=True, use_pallas_layer1=True,
                 use_pallas_argmax=True)


def eval_phase(config, model, device, batch: int = EVAL_BATCH, iters: int = 5) -> dict:
    """Phase 5: eval-step frames/s with the fusion kernel, with every
    kernel flag on, and on the plain path."""
    import torch

    from cavp_tpu_torch.data.synthetic import synthetic_eval_batch
    from cavp_tpu_torch.engine.loops import (
        eval_metrics_init, eval_metrics_result, make_eval_step)

    data = {k: torch.from_numpy(v).to(device)
            for k, v in synthetic_eval_batch(config, batch, seed=SEED).items()}
    steps = {"kernel": make_eval_step(model, config),
             "all": make_eval_step(model, config.replace(**ALL_FLAGS)),
             "plain": make_eval_step(model, config.replace(use_pallas_fusion=False))}
    fps = {k: [] for k in steps}
    for arm in ("all", "kernel", "plain", "plain", "kernel", "all"):
        metrics = steps[arm](eval_metrics_init(config.num_classes, device), data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            metrics = steps[arm](metrics, data)
        torch.cuda.synchronize()
        fps[arm].append(batch * iters / (time.perf_counter() - t0))
        pixels = (iters + 1) * batch * config.image_height * config.image_width
        require(float(metrics.miou_all.labeled) == pixels, "lost pixels")
        res = {k: float(v) for k, v in eval_metrics_result(metrics).items()}
        require(all(v == v for v in res.values()), f"NaN metric: {res}")
    fmt = lambda k: " / ".join(f"{v:.1f}" for v in fps[k])
    print(f"[eval] make_eval_step at batch {batch}, {iters} steps per window "
          f"(all, kernel, plain, plain, kernel, all): every kernel flag on {fmt('all')} "
          f"frames/s, fusion kernel only {fmt('kernel')} frames/s, plain {fmt('plain')} "
          "frames/s (measurements of the port on this card)")
    return {k: statistics.median(v) for k, v in fps.items()}


# kernel-name pieces of each group of the eval step's device time
KERNEL_GROUPS = (("K1 fusion", ("chain_kernel",)), ("K5 layer1", ("bottleneck_kernel",)),
                 ("K3 mel", ("log_mel_kernel",)), ("K4 upsample+argmax", ("upsample_argmax",)),
                 ("convolutions and matrix products",
                  ("conv", "xmma", "implicit", "cudnn", "fprop", "dgrad", "wgrad", "winograd",
                   "gemm", "cutlass")),
                 ("elementwise", ("elementwise", "vectorized")), ("reductions", ("reduce",)))


def profile_eval_step(config, model, device) -> None:
    """``--profile``: one eval step at batch 120 with every kernel flag on
    under ``torch.profiler``; its device time by kernel group, and the
    device's idle share against the unprofiled step's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from cavp_tpu_torch.data.synthetic import synthetic_eval_batch
    from cavp_tpu_torch.engine.loops import eval_metrics_init, make_eval_step

    data = {k: torch.from_numpy(v).to(device)
            for k, v in synthetic_eval_batch(config, EVAL_BATCH, seed=SEED + 25).items()}
    step = make_eval_step(model, config.replace(**ALL_FLAGS))
    metrics = eval_metrics_init(config.num_classes, device)
    for _ in range(2):
        metrics = step(metrics, data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        metrics = step(metrics, data)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3 * 1e3
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        metrics = step(metrics, data)
        torch.cuda.synchronize()
    events = prof.key_averages()
    print(events.table(sort_by="cuda_time_total", row_limit=30, max_name_column_width=70))
    device_ms = lambda e: (getattr(e, "self_device_time_total", None)
                           or getattr(e, "self_cuda_time_total", 0)) / 1e3
    kernels = [e for e in events if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(device_ms(e) for e in kernels)
    split = dict.fromkeys([g for g, _ in KERNEL_GROUPS] + ["other"], 0.0)
    for e in kernels:
        name = e.key.lower()
        group = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)), "other")
        split[group] += device_ms(e)
    print(f"[profile-eval] one eval step at batch {EVAL_BATCH}, every kernel flag on: "
          f"{busy:.2f} ms of device time in {sum(e.count for e in kernels)} kernel launches; "
          f"unprofiled step {wall:.2f} ms, so the device idles {100 * (1 - busy / wall):.1f}%")
    print("[profile-eval] device time by group: " + "; ".join(
        f"{g} {ms:.2f} ms ({100 * ms / busy:.1f}%)"
        for g, ms in sorted(split.items(), key=lambda kv: -kv[1])))
    other = sorted((e for e in kernels if not any(
        k in e.key.lower() for _, keys in KERNEL_GROUPS for k in keys)), key=lambda e: -device_ms(e))
    print("[profile-eval] largest in other: " + "; ".join(
        f"{e.key[:60]} {device_ms(e):.2f} ms x{e.count}" for e in other[:5]))


def plain_split_products(plan, reduce: bool = True) -> dict:
    """Stage B's plain version on a backward plan's own operands: float32
    products over ``SPLIT_TOKENS``-token ranges, summed in split order (or
    left as the list of partials)."""
    import torch

    from cavp_tpu_torch.ops.kernels import fusion_train as ft

    out = {}
    for k, a, b in ft.PRODUCTS:
        xa, xb = plan.operands[a], plan.operands[b]
        parts = [pa.float().t() @ pb.float() for pa, pb in
                 zip(torch.split(xa, ft.SPLIT_TOKENS), torch.split(xb, ft.SPLIT_TOKENS))]
        out[k] = sum(parts[1:], parts[0]) if reduce else parts
    return out


def train_kernel_phase(model, small_model, device) -> dict:
    """Phase 6: the train fusion kernels against their plain versions."""
    import torch

    from cavp_tpu_torch.models.cavp import tokens_to_map
    from cavp_tpu_torch.ops.kernels import fusion_train as ft

    g = torch.Generator().manual_seed(SEED + 4)
    names = ("dx", "dwqk", "dm") + ft.WEIGHT_NAMES

    def operands(mdl, b, n, dtype):
        C = mdl.latent_dim
        x = torch.randn(b, n, C, generator=g).to(device, dtype)
        fea_a = torch.randn(2 * b, C, generator=g).to(device, dtype)
        dy = torch.randn(2 * b, n, C, generator=g).to(device, dtype)
        with torch.no_grad():
            wqk2, m2, ws = ft.train_operands(mdl, fea_a, b, dtype)
        return x, fea_a, dy, wqk2, m2, ws

    def flat(result):
        dx, dwqk, dm, dws = result
        return [dx, dwqk, dm, *dws]

    @torch.no_grad()
    def compare(name, mdl, b, n, dtype):
        x, _, dy, wqk2, m2, ws = operands(mdl, b, n, dtype)
        y = ft.token_chain_train(x, wqk2, m2, ws)
        require(bool(torch.equal(y, ft.token_chain_train(x, wqk2, m2, ws))),
                f"{name}: two forward launches differ")
        got = flat(ft.token_chain_train_backward(x, wqk2, m2, ws, dy))
        again = flat(ft.token_chain_train_backward(x, wqk2, m2, ws, dy))
        torch.cuda.synchronize()
        ref = ft.token_chain_train_reference(x, wqk2, m2, ws)
        ref_g = flat(ft.token_chain_train_backward_reference(x, wqk2, m2, ws, dy))
        torch.cuda.synchronize()
        shape = [b, n, mdl.latent_dim]
        require(y.shape == ref.shape and y.dtype == ref.dtype == dtype,
                f"{name}: forward output {y.shape} {y.dtype}")
        require(bool(torch.isfinite(y).all()), f"{name}: non-finite forward output")
        err = (y.float() - ref.float()).abs()
        fwd_max, fwd_mean = float(err.max()), float(err.mean())
        if dtype == torch.float32:
            torch.testing.assert_close(y, ref, **F32_TOL)
            print(f"[train-kernel] {name} {shape} forward: max_abs_err {fwd_max:.3e} "
                  f"mean_abs_err {fwd_mean:.3e} (rtol 1e-4, atol 5e-5: ok)")
        else:
            ok = fwd_max <= BF16_MAX_ABS and fwd_mean <= BF16_MEAN_ABS
            print(f"[train-kernel] {name} {shape} forward: max_abs_err {fwd_max:.3e} "
                  f"mean_abs_err {fwd_mean:.3e} (max {BF16_MAX_ABS}, mean "
                  f"{BF16_MEAN_ABS}: {'ok' if ok else 'FAIL'})")
            require(ok, f"{name}: the bf16 forward kernel disagrees with the plain version")
        limit = GRAD_F32_REL if dtype == torch.float32 else GRAD_BF16_REL
        worst_rel, worst_abs, report = 0.0, 0.0, []
        for k, a, a2, r in zip(names, got, again, ref_g):
            require(a.shape == r.shape and a.dtype == r.dtype,
                    f"{name}: gradient {k} is {a.shape} {a.dtype}, plain {r.shape} {r.dtype}")
            require(bool(torch.isfinite(a).all()), f"{name}: non-finite gradient {k}")
            require(bool(torch.equal(a, a2)),
                    f"{name}: two backward launches differ in gradient {k}")
            abs_err = float((a.float() - r.float()).abs().max())
            rel = abs_err / (float(r.float().abs().max()) + 1e-30)
            report.append(f"{k} {rel:.1e}")
            require(rel <= limit, f"{name}: gradient {k} is off by {rel:.3e} of its "
                                  f"largest entry (limit {limit})")
            worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, abs_err)
        print(f"[train-kernel] {name} {shape} backward, max error over max|grad| of "
              f"each of the {len(names)} gradients (limit {limit}; two launches "
              f"bit-equal): {', '.join(report)}")
        return fwd_max, worst_abs, worst_rel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, N, C = TRAIN_SHAPE
    results = {}
    compare("f32", model, B, N, torch.float32)
    compare("f32_ragged", model, 3, N + 7 * 9, torch.float32)
    compare("f32_c112", small_model, 3, 7 * 9, torch.float32)
    compare("bf16_ragged", model, 3, N + 7 * 9, torch.bfloat16)
    for fname, fb in (("bf16_b1", 1), ("bf16_bucket8", 8)):  # the forward alone
        with torch.no_grad():
            x, _, _, wqk2, m2, ws = operands(model, fb, N, torch.bfloat16)
            y = ft.token_chain_train(x, wqk2, m2, ws)
            again = ft.token_chain_train(x, wqk2, m2, ws)
            ref = ft.token_chain_train_reference(x, wqk2, m2, ws)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs()
        ok = (bool(torch.equal(y, again)) and bool(torch.isfinite(y).all())
              and float(err.max()) <= BF16_MAX_ABS and float(err.mean()) <= BF16_MEAN_ABS)
        print(f"[train-kernel] {fname} [{fb}, {N}, {C}] forward: max_abs_err "
              f"{float(err.max()):.3e} mean_abs_err {float(err.mean()):.3e} (max {BF16_MAX_ABS}, "
              f"mean {BF16_MEAN_ABS}; two launches bit-equal: {'ok' if ok else 'FAIL'})")
        require(ok, f"{fname}: the bf16 forward kernel disagrees with the plain version")
    compare("bf16_c112", small_model, 3, 7 * 9 + 16, torch.bfloat16)
    compare("bf16_resize_train", model, RESIZE_TRAIN_BATCH, RESIZE_TOKENS, torch.bfloat16)
    torch.cuda.empty_cache()
    results["fwd_err"], results["bwd_err"], _ = compare("bf16", model, B, N, torch.bfloat16)

    # the bf16 backward's stages at the train step's shape, each against its
    # plain version: stage A's operands against the plain backward's, stage
    # B + the reduction against float32 products of stage A's own operands
    # (the same bf16 inputs: only the float summation order differs)
    x, fea_a, dy, wqk2, m2, ws = operands(model, B, N, torch.bfloat16)
    saved = dict(ft.token_chain_train_backward.launches)
    plan = ft._BackwardPlan(x, wqk2, m2, ws, dy, 4)
    with torch.no_grad():
        plan.stage_a()
        plan.stage_b()
        plan.reduce()
        torch.cuda.synchronize()
        *_, plain_vec, plain_ops = ft._backward_parts(x, wqk2, m2, ws, dy, 4)
        stage_a_rel, stage_a_abs = {}, 0.0
        for k, r in plain_ops.items():
            err = float((plan.operands[k].float() - r.float()).abs().max())
            stage_a_rel[k] = err / (float(r.float().abs().max()) + 1e-30)
            stage_a_abs = max(stage_a_abs, err)
        dws = dict(zip(ft.WEIGHT_NAMES, plan.dws))
        stage_b_rel, stage_b_abs = {}, 0.0
        for k, ref in plain_split_products(plan).items():
            err = float((dws[k] - ref).abs().max())
            stage_b_rel[k] = err / float(ref.abs().max())
            stage_b_abs = max(stage_b_abs, err)
        del plain_vec, plain_ops, ref
    print(f"[train-kernel] bf16 {list(TRAIN_SHAPE)} stage A's operands against the plain "
          f"backward's, max error over max|operand| (limit {GRAD_BF16_REL}): "
          + ", ".join(f"{k} {v:.1e}" for k, v in stage_a_rel.items()))
    print(f"[train-kernel] bf16 {list(TRAIN_SHAPE)} stage B + reduction against float32 "
          f"products of stage A's operands in {ft.SPLIT_TOKENS}-token splits (limit "
          f"{GRAD_F32_REL}): " + ", ".join(f"{k} {v:.1e}" for k, v in stage_b_rel.items()))
    require(max(stage_a_rel.values()) <= GRAD_BF16_REL, "stage A's operands disagree")
    require(max(stage_b_rel.values()) <= GRAD_F32_REL, "stage B's products disagree")
    results["stage_a_err"], results["stage_b_err"] = stage_a_abs, stage_b_abs

    # times at the train step's shape, bf16
    side = int(N ** 0.5)
    dy_map = tokens_to_map(dy, side, side)

    def module_fwd_bwd():  # what the train step runs with the kernels off
        xm = x.detach().requires_grad_()
        fused, _ = model.forward_fusion(tokens_to_map(xm, side, side), fea_a, dup=2)
        fused.backward(dy_map)
        model.zero_grad(set_to_none=True)

    def wrapper_fwd_bwd():  # the same through the kernels, audio side included
        xm = x.detach().requires_grad_()
        ft.fusion_train(model, xm, fea_a).backward(dy)
        model.zero_grad(set_to_none=True)

    @torch.no_grad()
    def module_fwd():
        return model.forward_fusion(tokens_to_map(x, side, side), fea_a, dup=2)

    arms = {
        "fwd": lambda: ft.token_chain_train(x, wqk2, m2, ws),
        "bwd": lambda: ft.token_chain_train_backward(x, wqk2, m2, ws, dy),
        "stage_a": plan.stage_a, "stage_b": plan.stage_b, "reduce": plan.reduce,
        "plain_stage_a": lambda: ft._backward_parts(x, wqk2, m2, ws, dy, 4),
        "plain_stage_b": lambda: plain_split_products(plan, reduce=False),
        "plain_reduce": lambda: [p.sum(0) for p in plan.parts.values()],
        "plain_fwd": lambda: ft.token_chain_train_reference(x, wqk2, m2, ws),
        "plain_bwd": lambda: ft.token_chain_train_backward_reference(x, wqk2, m2, ws, dy),
        "module_fwd": module_fwd, "module_fwd_bwd": module_fwd_bwd,
        "wrapper_fwd_bwd": wrapper_fwd_bwd,
    }
    fwd_launches = ft.token_chain_train.launches
    iters, times = 5, {k: [] for k in arms}
    order = list(arms) + list(reversed(arms))
    for arm in order:
        times[arm].append(cuda_ms(arms[arm], iters))
    ft.token_chain_train.launches = fwd_launches
    ft.token_chain_train_backward.launches.update(saved)
    for k in arms:
        results[f"{k}_ms"] = statistics.median(times[k])
    print(f"[train-kernel] time at {list(TRAIN_SHAPE)} bf16, median of {iters}, each arm "
          f"twice (forward order, then reversed): "
          + "; ".join(f"{k} {' / '.join(f'{t:.3f}' for t in times[k])} ms" for k in arms))
    print(f"[train-kernel] bf16 backward: stage A {results['stage_a_ms']:.3f} ms, stage B "
          f"{results['stage_b_ms']:.3f} ms, reduction {results['reduce_ms']:.3f} ms (one "
          f"launch each per backward); whole wrapper {results['bwd_ms']:.3f} ms")

    tokens = B * N
    hidden, mlp_hidden = ws[0].shape[1], ws[11].shape[1]
    prefix, half = chain_flops_per_token(C, hidden, mlp_hidden, 4)
    fwd_flops = tokens * (prefix + 2 * half)
    weight_bytes = sum(w.numel() for w in ws) * 2
    io = tokens * C * 2  # one [B, N, C] bf16 tensor
    results["fwd_bound"] = bound_ms(fwd_flops, 3 * io + weight_bytes)
    # recompute, the products for dx, the products for the weight gradients;
    # reads x and both dy halves, writes dx and the float weight gradients
    results["bwd_bound"] = bound_ms(3 * fwd_flops, 4 * io + weight_bytes * 3)
    # stage A: the forward's products and their mirrors for dx; reads x, dy,
    # writes dx and the bf16 operands of stage B
    op_bytes = sum(t.numel() * 2 for k, t in plan.operands.items() if k != "x")
    results["stage_a_bound"] = bound_ms(2 * fwd_flops, 4 * io + weight_bytes + op_bytes)
    # stage B: reads its operands once, writes the float partials
    wgrad_flops = sum(2 * plan.operands[a].shape[0] * plan.operands[a].shape[1]
                      * plan.operands[b].shape[1] for _, a, b in ft.PRODUCTS)
    part_bytes = sum(p.numel() * 4 for p in plan.parts.values())
    results["stage_b_bound"] = bound_ms(wgrad_flops, io + op_bytes + part_bytes)
    # the reduction: reads every partial set, writes the gradients
    red_bytes = (part_bytes + 4 * (plan.vec_part.numel() + plan.dwqk_part.numel()
                                   + plan.dm_part.numel() + plan.dw.numel()
                                   + plan.dwqk2.numel() + plan.dm2.numel()))
    results["reduce_bound"] = bound_ms(red_bytes / 4, red_bytes)
    print(f"[train-kernel] bounds at 989 TFLOP/s bf16 and 3.35 TB/s: forward "
          f"{results['fwd_bound'][0]:.3f} ms, backward {results['bwd_bound'][0]:.3f} ms "
          f"(both by {results['fwd_bound'][1]}); stage A {results['stage_a_bound'][0]:.3f} "
          f"ms by {results['stage_a_bound'][1]}, stage B {results['stage_b_bound'][0]:.3f} ms "
          f"by {results['stage_b_bound'][1]}, reduction {results['reduce_bound'][0]:.4f} ms "
          f"by {results['reduce_bound'][1]}")
    del plan
    return results


def train_phase(config, device, profile: bool) -> dict:
    """Phase 7: train steps through the kernels, then on the module path."""
    import numpy as np
    import torch

    from cavp_tpu_torch.data.synthetic import synthetic_train_batch
    from cavp_tpu_torch.engine.loops import make_train_step
    from cavp_tpu_torch.engine.optim import GROUPS, label_params
    from cavp_tpu_torch.engine.runner import init_state
    from cavp_tpu_torch.ops.kernels import fusion_train as ft

    cfg = config.replace(batch_size=TRAIN_BATCH, use_pallas_fusion=False,
                         use_pallas_fusion_train=True)
    state = init_state(cfg, device)
    labels = label_params(state.model)
    epochs = (0, 1, 1, 1)
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in synthetic_train_batch(cfg, seed=SEED + 10 + i).items()}
               for i in range(len(epochs))]
    start = state.state_dict()
    before = {k: v.clone() for k, v in state.model.named_parameters()}
    bank_before = state.sound_bank.clone()

    def run(arm_cfg, name):
        step = make_train_step(state.model, state.optimizers, arm_cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ctr, times = [], [], []
        for batch, epoch in zip(batches, epochs):
            t0 = time.perf_counter()
            _, metrics = step(state, batch, epoch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss/loss"]))
            ctr.append(float(metrics["loss/l_ctr_av"]))
            require(np.isfinite(losses[-1]), f"{name}: loss {losses[-1]} at step {len(losses)}")
            require(ctr[-1] > 0, f"{name}: loss/l_ctr_av {ctr[-1]} at step {len(losses)}")
            require(float(metrics["corocl/eligible_classes"]) >= 1,
                    f"{name}: no eligible CoroCL class")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steady = statistics.median(times[1:])
        print(f"[train] {name}: loss {' '.join(f'{v:.4f}' for v in losses)}; l_ctr_av "
              f"{' '.join(f'{v:.4f}' for v in ctr)}; step ms "
              f"{' '.join(f'{t:.1f}' for t in times)} (first step warms up; median of the "
              f"rest {steady:.1f} ms, {TRAIN_BATCH / steady * 1e3:.1f} frames/s); peak "
              f"memory {peak:.2f} GiB")
        return losses, steady, peak

    # the main path: the counts are read from these steps only
    ft.token_chain_train.launches = 0
    ft.token_chain_train_backward.launches.update(dict.fromkeys(
        ft.token_chain_train_backward.launches, 0))
    k_losses, k_ms, k_peak = run(cfg, "kernel arm")
    launches = dict(fwd=ft.token_chain_train.launches, **ft.token_chain_train_backward.launches)
    expected = dict(fwd=len(epochs), stage_a=len(epochs), stage_b=len(epochs),
                    reduce=len(epochs), f32=0)
    require(launches == expected,
            f"train kernels launched {launches} times in {len(epochs)} steps")
    require(state.step == len(epochs), f"step count {state.step}")
    moved = {g: False for g in GROUPS}
    for name, p in state.model.named_parameters():
        if not torch.equal(p, before[name]):
            moved[labels[name]] = True
    require(all(moved.values()), f"optimizer groups that did not move: "
            f"{[g for g, m in moved.items() if not m]}")
    require(not torch.equal(state.sound_bank, bank_before), "the sound bank did not change")
    require(all(bool(torch.isfinite(p).all()) for p in state.model.parameters()),
            "non-finite parameter after the steps")
    print(f"[train] kernel arm: {len(epochs)} steps (epochs {list(epochs)}), forward and "
          f"backward kernel launches {launches}, all {len(GROUPS)} optimizer groups and "
          f"the sound bank moved")

    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile
        step = make_train_step(state.model, state.optimizers, cfg)
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(state, batches[-1], 1)
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40,
                                          max_name_column_width=70)
        print(table)

    # the same steps from the same state on the module path
    state.load_state_dict(start)
    m_losses, m_ms, m_peak = run(cfg.replace(use_pallas_fusion_train=False), "module arm")
    rel = abs(k_losses[0] - m_losses[0]) / abs(m_losses[0])
    print(f"[train] first step's loss: kernel arm {k_losses[0]:.5f}, module arm "
          f"{m_losses[0]:.5f}, relative difference {rel:.2e} (limit {LOSS_REL})")
    require(rel <= LOSS_REL, "the kernel arm's first loss is off the module arm's")
    print(f"[train] batch {TRAIN_BATCH}, one run: kernel arm {k_ms:.1f} ms a step, peak "
          f"{k_peak:.2f} GiB; module arm {m_ms:.1f} ms a step, peak {m_peak:.2f} GiB")
    del state, start, before
    torch.cuda.empty_cache()
    return {"launches": launches, "kernel_ms": k_ms, "module_ms": m_ms,
            "kernel_gib": k_peak, "module_gib": m_peak}


def interleaved_ms(arms: dict, iters: int) -> dict:
    """Median ms of each arm, every arm timed twice: forward order, then
    reversed."""
    times = {k: [] for k in arms}
    for arm in list(arms) + list(reversed(arms)):
        times[arm].append(cuda_ms(arms[arm], iters))
    return {k: statistics.median(v) for k, v in times.items()}


def mel_kernel_phase(config, device) -> dict:
    """Phase 8: the log-mel kernel against the function in float64, beside
    its plain version and the unfused frontend."""
    import numpy as np
    import torch

    from cavp_tpu_torch.audio.functional import db_from_amp, normalize_spec
    from cavp_tpu_torch.audio.mel import mel_spectrogram, periodic_hann, preprocess_audio
    from cavp_tpu_torch.ops.kernels.mel import (
        _device_bases, fused_log_mel, fused_log_mel_reference, log_mel_float64, mel_plan)

    rng = np.random.RandomState(SEED + 20)
    L, T = config.audio_samples, config.mel_frames
    rows = EVAL_BATCH * config.in_plane

    def wave(n):
        return torch.from_numpy(((rng.rand(n, L) - 0.5) * 0.2).astype(np.float32)).to(device)

    def unfused(w, frames, f_min=125.0, f_max=3800.0):
        if (f_min, f_max) == (125.0, 3800.0):
            return preprocess_audio(w[:, None], n_frames=frames)[:, 0]
        mel = mel_spectrogram(w, f_min=f_min, f_max=f_max)[:, :, :frames]
        return normalize_spec(db_from_amp(mel.transpose(-1, -2)), -100.0, 100.0)

    # a 1 kHz tone at 0.5 over noise at 1e-4: 100 dB between the tone's bins
    # and the floor, and leakage bands near the 1e-5 clamp
    tone = (0.5 * np.sin(2 * np.pi * 1000.0 * np.arange(L) / 16000.0)[None]
            + 1e-4 * rng.randn(rows, L)).astype(np.float32)
    band = dict(f_min=60.0, f_max=7000.0)
    # 3 rows x 101 frames (every frame the waveform has): the last tile is
    # ragged and the last frames reflect at the end
    cases = (("eval", wave(rows), T, {}), ("bucket8", wave(8 * config.in_plane), T, {}),
             ("resize_train", wave(RESIZE_TRAIN_BATCH * config.in_plane), T, {}),
             ("resize_eval", wave(RESIZE_EVAL_FRAMES * config.in_plane), T, {}),
             ("ragged", wave(3), 1 + L // 160, {}),
             ("tone", torch.from_numpy(tone).to(device), T, {}),
             ("band 60-7000 Hz", wave(rows), T, band))
    # the VPO setups: 3 s clips, 300 frames; 2B = 32 mono clips (vpo_mono's
    # matched and shuffled halves) or B = 16 stereo clips of 2 channels
    vpo_L, vpo_T = 48000, 300
    vpo_wave = torch.from_numpy(((rng.rand(2 * RESIZE_TRAIN_BATCH, vpo_L) - 0.5) * 0.2
                                 ).astype(np.float32)).to(device)
    cases += (("vpo", vpo_wave, vpo_T, {}),)
    results = {}
    for name, w, frames, kw in cases:
        L = w.shape[1]  # wave() reads it: set back below
        got = fused_log_mel(w, frames, **kw)
        again = fused_log_mel(w, frames, **kw)
        ref = fused_log_mel_reference(w, frames, **kw)
        unf = unfused(w, frames, **kw)
        f64 = log_mel_float64(w, frames, **kw)
        torch.cuda.synchronize()
        require(got.shape == (w.shape[0], frames, 64) and got.dtype == torch.float32,
                f"mel kernel output {got.shape} {got.dtype}")
        require(bool(torch.isfinite(got).all()), "non-finite mel kernel output")
        dist = lambda a: float((a.double() - f64).abs().max())
        e_k, e_p, e_u = dist(got), dist(ref), dist(unf)
        limit = max(MEL_ATOL, 2 * e_p + 1e-7)
        same = bool(torch.equal(got, again))
        ok = e_k <= limit and same
        print(f"[mel-kernel] {name} [{w.shape[0]}, {L}] -> {frames} frames: max_abs_err on the "
              f"[-1, 1] scale against float64: kernel {e_k:.3e}, plain {e_p:.3e}, unfused "
              f"{e_u:.3e} (kernel limit {limit:.3e}: {'ok' if ok else 'FAIL'}); kernel against "
              f"plain {float((got - ref).abs().max()):.3e}, against unfused "
              f"{float((got - unf).abs().max()):.3e}; two launches "
              f"{'bit-equal' if same else 'DIFFER'}; output range "
              f"{float(got.min()):.3f} .. {float(got.max()):.3f}")
        require(ok, f"the mel kernel disagrees ({name})")
        results[name] = float((got - ref).abs().max())
        if name.startswith("vpo"):
            results["vpo_f64"] = e_k
    L = config.audio_samples

    # the stereo row layout: [16, 2, 48000] through preprocess_audio's kernel
    # path gives clip i's channel c from row 2i + c, each as the plain
    # frontend gives that channel alone
    stereo = vpo_wave.reshape(RESIZE_TRAIN_BATCH, 2, vpo_L)
    got = preprocess_audio(stereo, n_frames=vpo_T, use_pallas=True)
    rows_k = fused_log_mel(vpo_wave, vpo_T)
    require(tuple(got.shape) == (RESIZE_TRAIN_BATCH, 2, vpo_T, 64)
            and torch.equal(got.reshape(2 * RESIZE_TRAIN_BATCH, vpo_T, 64), rows_k),
            f"the stereo mel layout {list(got.shape)}")
    plain = torch.stack([preprocess_audio(stereo[:, c:c + 1], n_frames=vpo_T)[:, 0]
                         for c in range(2)], 1)
    f64 = log_mel_float64(vpo_wave, vpo_T).reshape(RESIZE_TRAIN_BATCH, 2, vpo_T, 64)
    e_k, e_p = float((got.double() - f64).abs().max()), float((plain.double() - f64).abs().max())
    limit = max(MEL_ATOL, 2 * e_p + 1e-7)
    print(f"[mel-kernel] vpo_stereo [16, 2, 48000] through preprocess_audio: rows 2i + c are "
          f"clip i's channel c; against float64 kernel {e_k:.3e}, the unfused frontend channel "
          f"by channel {e_p:.3e} (limit {limit:.3e}: {'ok' if e_k <= limit else 'FAIL'})")
    require(e_k <= limit, "the stereo mel rows disagree")

    launches = fused_log_mel.launches
    vpo_ms = interleaved_ms({
        "kernel": lambda: fused_log_mel(vpo_wave, vpo_T),
        "plain": lambda: fused_log_mel_reference(vpo_wave, vpo_T),
        "library": lambda: preprocess_audio(vpo_wave[:, None], n_frames=vpo_T)}, 10)
    vpo_b2b = back_to_back_ms(lambda: fused_log_mel(vpo_wave, vpo_T))
    fused_log_mel.launches = launches
    plan = mel_plan(125.0, 3800.0)
    cols = plan.chunks * plan.chunk_cols
    vpo_frames = 2 * RESIZE_TRAIN_BATCH * vpo_T
    vpo_bound = bound_ms(3 * 2 * vpo_frames * 400 * cols,
                         4 * (2 * RESIZE_TRAIN_BATCH * vpo_L + vpo_frames * 64 + 2 * 400 * cols),
                         PEAK_TF32_FLOPS)
    results.update({f"vpo_{k}": v for k, v in vpo_ms.items()})
    results["vpo_b2b"], results["vpo_bound"] = vpo_b2b, vpo_bound
    print(f"[mel-kernel] time at the VPO shape [32, 48000] -> 300 frames, float32, one call at "
          f"a time: kernel {vpo_ms['kernel']:.4f} ms, plain {vpo_ms['plain']:.4f} ms, unfused "
          f"preprocess_audio {vpo_ms['library']:.4f} ms; in a row of launches: kernel "
          f"{vpo_b2b:.4f} ms; bound {vpo_bound[0]:.4f} ms by {vpo_bound[1]}; {card_line()}")

    w = wave(rows)
    _, _, fb = _device_bases(125.0, 3800.0, device)
    hann = torch.from_numpy(periodic_hann(400).astype(np.float32)).to(device)

    def fft_composition():  # a yardstick: the library's FFT, power, filterbank, log
        pad = torch.nn.functional.pad(w[:, None], (256, 256), mode="reflect")[:, 0]
        spec = torch.fft.rfft(pad.unfold(-1, 512, 160)[:, :T, 56:456] * hann, n=512)
        mel = (spec.real.square() + spec.imag.square()) @ fb
        return normalize_spec(db_from_amp(mel), -100.0, 100.0)

    e_fft = float((fft_composition().double() - log_mel_float64(w, T)).abs().max())
    launches = fused_log_mel.launches
    ms = interleaved_ms({
        "kernel": lambda: fused_log_mel(w, T),
        "plain": lambda: fused_log_mel_reference(w, T),
        "library": lambda: preprocess_audio(w[:, None], n_frames=T),
        "fft": fft_composition}, 10)
    b2b = {"kernel": back_to_back_ms(lambda: fused_log_mel(w, T)),
           "fft": back_to_back_ms(fft_composition)}
    fused_log_mel.launches = launches
    frames = rows * T
    plan = mel_plan(125.0, 3800.0)
    cols = plan.chunks * plan.chunk_cols
    # the kernel: three TF32 products over the plan's columns; the bytes are
    # the waveform, the output and the TF32 bases (hi and lo)
    flops = 3 * 2 * frames * 400 * cols
    nbytes = 4 * (rows * L + frames * 64 + 2 * 400 * cols)
    # the old design's work: the dense float32 DFT of 257 bins and mel
    old_flops = frames * 2 * (2 * 400 * 257 + 257 * 64)
    old_bytes = 4 * (rows * L + frames * 64 + 2 * 400 * 257 + 257 * 64)
    results.update(ms)
    results["kernel_b2b"], results["fft_b2b"] = b2b["kernel"], b2b["fft"]
    results["bound"] = bound_ms(flops, nbytes, PEAK_TF32_FLOPS)
    old = bound_ms(old_flops, old_bytes, PEAK_F32_FLOPS)
    print(f"[mel-kernel] time at [{rows}, {L}] -> {T} frames, float32, one call at a time: "
          f"kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, unfused preprocess_audio "
          f"{ms['library']:.4f} ms, composition of torch.fft.rfft + power + filterbank + log "
          f"{ms['fft']:.4f} ms (its max_abs_err against float64 {e_fft:.3e}); in a row of "
          f"launches: kernel {b2b['kernel']:.4f} ms, the composition {b2b['fft']:.4f} ms; bound "
          f"{results['bound'][0]:.4f} ms by {results['bound'][1]} ({flops / 1e9:.2f} GFLOP of "
          f"TF32 products over {cols} columns at 495 TFLOP/s, {nbytes / 1e6:.1f} MB at 3.35 "
          f"TB/s); the dense float32 design's bound {old[0]:.4f} ms by {old[1]} (67 TFLOP/s)")
    return results


def argmax_kernel_phase(config, device) -> dict:
    """Phase 9: the upsample + argmax kernel against its plain version."""
    import torch
    import torch.nn.functional as F

    from cavp_tpu_torch.ops.interp import interpolate_bilinear_separable
    from cavp_tpu_torch.ops.kernels.upsample_argmax import (
        upsample_argmax, upsample_argmax_reference)

    g = torch.Generator().manual_seed(SEED + 21)
    C = config.num_classes
    hw = (config.image_height, config.image_width)
    low = (hw[0] // 4, hw[1] // 4)

    def logits(shape, dtype):
        """Random logits with exact ties: two class pairs equal over whole
        regions (the first must win), and one constant patch."""
        B, h, w, c = shape
        x = torch.randn(*shape, generator=g).to(device, dtype)
        x[:, : h // 2, :, c - 1] = x[:, : h // 2, :, 0]
        if c > 2:
            x[:, :, : w // 3, 1] = x[:, :, : w // 3, 2]
        else:  # 2 classes: a tie column band as well
            x[:, :, : w // 3, 1] = x[:, :, : w // 3, 0]
        x[0, h // 2:, w // 2:, :] = 0.25
        return x

    def tie_heavy(shape, dtype):
        """Logits of five values: most classes tie at most pixels."""
        return (torch.randint(-2, 3, shape, generator=g) * 0.5).to(device, dtype)

    results = {}
    cases = (("bf16", (EVAL_BATCH, *low, C), hw, torch.bfloat16),
             ("bf16_tie_heavy", (EVAL_BATCH, *low, C), hw, torch.bfloat16),
             ("bf16_bucket8", (8, *low, C), hw, torch.bfloat16),
             ("bf16_resize_eval", (RESIZE_EVAL_FRAMES, RESIZE_SIDE // 4, RESIZE_SIDE // 4, C),
              (RESIZE_SIDE, RESIZE_SIDE), torch.bfloat16),
             ("bf16_ragged", (3, 30, 40, 5), (120, 160), torch.bfloat16),
             ("bf16_odd_ratio", (3, 30, 40, 5), (97, 131), torch.bfloat16),
             ("f32", (8, *low, C), hw, torch.float32),
             ("f32_ragged", (3, 30, 40, 5), (120, 160), torch.float32),
             # the avss_binary setup's 2 classes: the whole class row is
             # the remainder of the kernel's 8-class vector
             ("bf16_2class", (EVAL_BATCH, *low, 2), hw, torch.bfloat16),
             ("bf16_2class_batch16", (16, *low, 2), hw, torch.bfloat16),
             ("bf16_2class_ragged", (3, 30, 41, 2), (97, 131), torch.bfloat16),
             ("bf16_2class_tie_heavy", (16, *low, 2), hw, torch.bfloat16),
             # the VPO setups' validation: 22 classes (the entry points pin
             # vpo_num_classes) and the setups' own 24, at 512x512, batch 16
             ("bf16_vpo22", (RESIZE_TRAIN_BATCH, RESIZE_SIDE // 4, RESIZE_SIDE // 4, 22),
              (RESIZE_SIDE, RESIZE_SIDE), torch.bfloat16),
             ("bf16_vpo24", (RESIZE_TRAIN_BATCH, RESIZE_SIDE // 4, RESIZE_SIDE // 4, 24),
              (RESIZE_SIDE, RESIZE_SIDE), torch.bfloat16),
             ("bf16_vpo22_tie_heavy", (RESIZE_TRAIN_BATCH, RESIZE_SIDE // 4,
                                       RESIZE_SIDE // 4, 22), (RESIZE_SIDE, RESIZE_SIDE),
              torch.bfloat16),
             ("bf16_vpo22_ragged", (3, 30, 41, 22), (97, 131), torch.bfloat16))
    for name, shape, out_hw, dtype in cases:
        x = (tie_heavy if name.endswith("tie_heavy") else logits)(shape, dtype)
        got = upsample_argmax(x, out_hw)
        ref = upsample_argmax_reference(x, out_hw)
        torch.cuda.synchronize()
        require(got.shape == (shape[0], *out_hw) and got.dtype == torch.int32,
                f"argmax kernel output {got.shape} {got.dtype}")
        require(0 <= int(got.min()) and int(got.max()) < shape[3], "argmax kernel range")
        if not name.endswith("tie_heavy"):
            require(int(got[0, -1, -1]) == 0, "a full tie did not go to the first class")
        differ = got != ref
        n_diff = int(differ.sum())
        if dtype == torch.float32 and n_diff:
            top2 = interpolate_bilinear_separable(x, out_hw).topk(2, dim=-1).values
            clear = (top2[..., 0] - top2[..., 1]) > 1e-5
            n_clear = int((differ & clear).sum())
            require(n_clear == 0, f"{name}: {n_clear} float32 masks differ away from near-ties")
        else:
            require(n_diff == 0, f"{name}: {n_diff} mask entries differ from the plain version")
        print(f"[argmax-kernel] {name} {list(shape)} -> {list(out_hw)}: {n_diff} of "
              f"{got.numel()} mask entries differ from the plain version "
              f"({'bit-equal' if n_diff == 0 else 'near-ties only'}; ties planted)")
        results[name] = float(n_diff)
        if name in ("bf16", "bf16_2class", "bf16_vpo22", "bf16_vpo24"):
            again = upsample_argmax(x, out_hw)
            require(bool(torch.equal(got, again)), f"two {name} argmax launches differ")
            print(f"[argmax-kernel] two {name} launches at the eval shape: bit-equal")

    vpo_low, vpo_hw = (RESIZE_SIDE // 4,) * 2, (RESIZE_SIDE,) * 2
    for classes, suffix, B, low, hw in ((C, "", EVAL_BATCH, low, hw),
                                        (2, "_2", EVAL_BATCH, low, hw),
                                        (22, "_22", RESIZE_TRAIN_BATCH, vpo_low, vpo_hw)):
        (h, w), (H, W) = low, hw
        x = logits((B, *low, classes), torch.bfloat16)
        x_nchw = x.permute(0, 3, 1, 2)   # the head's own layout: channels_last
        launches = upsample_argmax.launches
        ms = interleaved_ms({
            "kernel": lambda: upsample_argmax(x, hw),
            "plain": lambda: upsample_argmax_reference(x, hw),
            "library": lambda: F.interpolate(x_nchw, size=hw, mode="bilinear",
                                             align_corners=False).argmax(1)}, 5)
        upsample_argmax.launches = launches
        # per class: 3 operations an H-pass value, 3 and the comparison a W-pass one
        flops = B * classes * (3 * H * w + 4 * H * W)
        nbytes = x.numel() * 2 + B * H * W * 4
        results.update({k + suffix: v for k, v in ms.items()})
        results["bound" + suffix] = bound_ms(flops, nbytes)
        print(f"[argmax-kernel] time at {list(x.shape)} bf16 -> {list(hw)}: kernel "
              f"{ms['kernel']:.3f} ms, plain {ms['plain']:.3f} ms, F.interpolate + argmax "
              f"{ms['library']:.3f} ms; bound {results['bound' + suffix][0]:.4f} ms by "
              f"{results['bound' + suffix][1]} (989 TFLOP/s bf16, 3.35 TB/s); {card_line()}")
    return results


def layer1_kernel_phase(config, model, device) -> dict:
    """Phase 10: the fused layer1 kernels against their plain version, on
    the stem output of seeded batches."""
    import torch

    from cavp_tpu_torch.data.synthetic import synthetic_eval_batch
    from cavp_tpu_torch.ops.kernels.layer1 import fused_layer1, fused_layer1_reference

    resnet = model.backbone.backbone
    image = torch.from_numpy(
        synthetic_eval_batch(config, EVAL_BATCH, seed=SEED + 22)["image"]).to(device)
    with torch.inference_mode():
        stem = resnet.stem_forward(image.permute(0, 3, 1, 2).to(model.dtype))
        stem = stem.permute(0, 2, 3, 1).contiguous()   # [B, 56, 56, 128]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def stem_of(n, height, width, seed):
        """The stem output [n, height / 4, width / 4, 128] of seeded images."""
        img = torch.randn(n, 3, height, width, generator=torch.Generator().manual_seed(seed))
        with torch.inference_mode():
            out = resnet.stem_forward(img.to(device, model.dtype))
        return out.permute(0, 2, 3, 1).contiguous()

    # the eval batch, the serving bucket, a ragged map (neither side a
    # multiple of a tile), the 128-wide map of 512-square images and a
    # 200-wide one (both wider than the earlier row-tile kernel took)
    cases = [("f32", stem[:EVAL_BATCH], torch.float32),
             ("f32_bucket8", stem[:8], torch.float32),
             ("bf16_bucket8", stem[:8], torch.bfloat16),
             ("bf16", stem[:EVAL_BATCH], torch.bfloat16),
             ("bf16_ragged", stem_of(3, 148, 180, SEED + 25), torch.bfloat16),
             ("bf16_wide", stem_of(2, 512, 512, SEED + 24), torch.bfloat16),
             ("f32_wide", stem_of(2, 512, 512, SEED + 24), torch.float32),
             ("bf16_200_wide", stem_of(2, 160, 800, SEED + 26), torch.bfloat16),
             ("bf16_resize_eval", stem_of(RESIZE_EVAL_FRAMES, RESIZE_SIDE, RESIZE_SIDE,
                                          SEED + 27), torch.bfloat16)]
    results = {}
    for name, x, dtype in cases:
        x = x.to(dtype)
        got = fused_layer1(resnet, x)
        ref = fused_layer1_reference(resnet, x)
        torch.cuda.synchronize()
        require(got.shape == ref.shape == (*x.shape[:3], 256) and got.dtype == dtype,
                f"layer1 kernel output {got.shape} {got.dtype}")
        require(bool(torch.isfinite(got).all()), "non-finite layer1 kernel output")
        err = (got.float() - ref.float()).abs()
        mx, mean, scale = float(err.max()), float(err.mean()), float(ref.float().abs().max())
        require(scale > 0.1 and float((ref > 0).float().mean()) > 0.05,
                "degenerate layer1 comparison")
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, **L1_F32_TOL)
            print(f"[layer1-kernel] {name} {list(x.shape)}: max_abs_err {mx:.3e} mean_abs_err "
                  f"{mean:.3e}, largest output {scale:.3f} (rtol 1e-5, atol 1e-5: ok)")
        else:
            ok = mx <= L1_BF16_MAX_REL * scale and mean <= L1_BF16_MEAN_REL * scale
            print(f"[layer1-kernel] {name} {list(x.shape)}: max_abs_err {mx:.3e} mean_abs_err "
                  f"{mean:.3e}, largest output {scale:.3f} (max {L1_BF16_MAX_REL} and mean "
                  f"{L1_BF16_MEAN_REL} of it: {'ok' if ok else 'FAIL'})")
            require(ok, f"the bf16 layer1 kernel disagrees with the plain version ({name})")
        if name == "bf16":
            again = fused_layer1(resnet, x)
            require(bool(torch.equal(got, again)), "two bf16 layer1 launches differ")
            print(f"[layer1-kernel] two bf16 launches at {list(x.shape)}: bit-equal")
        results[name] = mx
    del cases, got, ref, err

    x = stem.to(torch.bfloat16)
    x_nchw = x.permute(0, 3, 1, 2)

    @torch.inference_mode()
    def module_path():  # what the eval step runs with use_pallas_layer1 off
        return resnet.layer1(x_nchw)

    launches = fused_layer1.launches
    ms = interleaved_ms({"kernel": lambda: fused_layer1(resnet, x),
                         "plain": lambda: fused_layer1_reference(resnet, x),
                         "library": module_path}, 5)
    fused_layer1.launches = launches
    B, H, W, cin = x.shape
    planes, cout, blocks = 64, 256, len(resnet.layer1)
    macs = (cin * planes + 9 * planes * planes + planes * cout + cin * cout
            + (blocks - 1) * (cout * planes + 9 * planes * planes + planes * cout))
    weights = 2 * macs
    results.update(ms)
    results["bound"] = bound_ms(2.0 * B * H * W * macs, 2 * B * H * W * (cin + cout) + weights)
    print(f"[layer1-kernel] time at {list(x.shape)} bf16 -> 256 channels: kernel "
          f"{ms['kernel']:.3f} ms, plain {ms['plain']:.3f} ms, layer1 modules "
          f"{ms['library']:.3f} ms; bound {results['bound'][0]:.4f} ms by "
          f"{results['bound'][1]} (989 TFLOP/s bf16, 3.35 TB/s)")
    return results


def all_flags_phase(config, model, state_dict, device) -> dict:
    """Phase 11: the eval step and the Predictor with every kernel flag on.
    Returns each eval kernel's launches in the eval steps."""
    import torch

    from cavp_tpu_torch.data.synthetic import synthetic_eval_batch
    from cavp_tpu_torch.engine.loops import (
        eval_metrics_init, eval_metrics_result, make_eval_pred_forward, make_eval_step,
        preprocess_audio)
    from cavp_tpu_torch.engine.predictor import Predictor
    from cavp_tpu_torch.ops.kernels.fusion import fused_visual_fusion
    from cavp_tpu_torch.ops.kernels.layer1 import fused_layer1
    from cavp_tpu_torch.ops.kernels.mel import fused_log_mel
    from cavp_tpu_torch.ops.kernels.upsample_argmax import upsample_argmax

    wrappers = {"mel": fused_log_mel, "layer1": fused_layer1, "fusion": fused_visual_fusion,
                "argmax": upsample_argmax}

    def reset():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in wrappers.items()}

    data = {k: torch.from_numpy(v).to(device)
            for k, v in synthetic_eval_batch(config, EVAL_BATCH, seed=SEED + 23).items()}
    off = dict.fromkeys(ALL_FLAGS, False)
    arms = {"all": ALL_FLAGS, "plain": off,
            "fusion": dict(off, use_pallas_fusion=True),
            "fusion+argmax": dict(off, use_pallas_fusion=True, use_pallas_argmax=True),
            "fusion+mel+argmax": dict(ALL_FLAGS, use_pallas_layer1=False)}

    # the main path of this slice: the eval step with every flag on
    steps = 2
    step = make_eval_step(model, config.replace(**ALL_FLAGS))
    reset()
    metrics = eval_metrics_init(config.num_classes, device)
    for _ in range(steps):
        metrics = step(metrics, data)
    torch.cuda.synchronize()
    launches = counts()
    # one launch a step, and one for each of layer1's bottlenecks
    per_step = dict.fromkeys(wrappers, 1)
    per_step["layer1"] = len(model.backbone.backbone.layer1)
    require(launches == {k: n * steps for k, n in per_step.items()},
            f"{steps} eval steps with every flag on launched {launches}")
    pixels = steps * EVAL_BATCH * config.image_height * config.image_width
    require(float(metrics.miou_all.labeled) == pixels, "lost pixels")
    print(f"[all-flags] {steps} eval steps at batch {EVAL_BATCH} with every kernel flag on "
          f"launched {launches}")

    masks, accs = {}, {}
    for name, flags in arms.items():
        cfg = config.replace(**flags)
        audio = preprocess_audio(data["waveform"], n_frames=cfg.mel_frames,
                                 spec_min=cfg.spec_min, spec_max=cfg.spec_max,
                                 use_pallas=cfg.use_pallas_mel)
        masks[name] = make_eval_pred_forward(model, cfg)(data["image"], audio)
        accs[name] = make_eval_step(model, cfg)(
            eval_metrics_init(config.num_classes, device), data)
    torch.cuda.synchronize()
    for name, m in masks.items():
        require(m.shape == data["pix_label"].shape and m.dtype == torch.int32,
                f"{name}: mask {m.shape} {m.dtype}")
        require(len(torch.unique(m)) > 1, f"{name}: constant mask")
    agree = lambda a, b: float((masks[a] == masks[b]).float().mean())

    def same_accumulators(a, b):
        flat = lambda m: [*m.miou_all, *m.miou_ms, m.fg_all, m.fg_ms]
        return all(bool(torch.equal(x, y)) for x, y in zip(flat(accs[a]), flat(accs[b])))

    a_all = agree("all", "plain")
    print(f"[all-flags] masks with every flag on agree with the all-plain arm on "
          f"{100 * a_all:.3f}% of pixels (limit {100 * MASK_AGREEMENT}%)")
    require(a_all >= MASK_AGREEMENT, f"all-flags masks agree on only {a_all:.4f}")
    require(bool(torch.equal(masks["fusion+argmax"], masks["fusion"]))
            and same_accumulators("fusion+argmax", "fusion"),
            "the argmax kernel changed the fusion-kernel arm's masks or accumulators")
    a_mel = agree("fusion+mel+argmax", "fusion")
    res = {k: {n: float(v) for n, v in eval_metrics_result(accs[k]).items()}
           for k in ("fusion", "fusion+mel+argmax", "all", "plain")}
    d_mel = max(abs(res["fusion+mel+argmax"][n] - v) for n, v in res["fusion"].items()
                if v == v)
    print(f"[all-flags] fusion + argmax kernels: masks and accumulators bit-equal to the "
          f"fusion-kernel arm; with the mel kernel too: masks agree on {100 * a_mel:.4f}% "
          f"(limit {100 * MEL_MASK_AGREEMENT}%), accumulators "
          f"{'equal' if same_accumulators('fusion+mel+argmax', 'fusion') else 'not equal'}, "
          f"largest metric difference {d_mel:.2e} (limit {MEL_METRIC_ATOL})")
    require(a_mel >= MEL_MASK_AGREEMENT and d_mel <= MEL_METRIC_ATOL,
            "the mel kernel moved the masks behind it")
    print(f"[all-flags] miou: all flags {res['all']['miou']:.6f}, fusion kernel "
          f"{res['fusion']['miou']:.6f}, plain {res['plain']['miou']:.6f}")
    del masks, accs

    # serving: layer1 and the fusion kernel are reached from Predictor; its
    # mel stays the plain one and its argmax runs over the full logits
    requests = serving_requests(config)
    fused = Predictor(config.replace(**ALL_FLAGS), device=device, batch_sizes=(8,),
                      state_dict=state_dict).warmup()
    reset()
    served = [fused.predict(images, waves)["mask"] for images, waves in requests]
    serve_counts = counts()
    chunks = sum(-(-n // 8) for n in REQUEST_SIZES)
    require(serve_counts == {"mel": 0, "layer1": per_step["layer1"] * chunks,
                             "fusion": chunks, "argmax": 0},
            f"serving {chunks} chunks launched {serve_counts}")
    del fused
    plain = Predictor(config.replace(**off), device=device, batch_sizes=(8,),
                      state_dict=state_dict)
    worst = min(float((plain.predict(images, waves)["mask"] == mask).mean())
                for (images, waves), mask in zip(requests, served))
    del plain
    torch.cuda.empty_cache()
    print(f"[all-flags] Predictor with every flag on: {chunks} chunks launched "
          f"{serve_counts}; masks agree with the plain Predictor on at least "
          f"{100 * worst:.3f}% of a request's pixels (limit {100 * MASK_AGREEMENT}%)")
    require(worst >= MASK_AGREEMENT, f"served masks agree on only {worst:.4f}")
    return launches


def profile_validation(entry, argv, device, unprofiled_s: float) -> None:
    """``--profile``: ``torch.profiler`` over one ``run_validation`` of the
    entry point (the loop only): host time by operation, device time, and
    the device's idle share of the loop, against the profiled loop and
    against ``unprofiled_s``, the same loop's wall time without it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    real_run = entry.run_validation
    wall = {}

    def profiled_run(*a, **kw):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = real_run(*a, **kw)
            torch.cuda.synchronize()
            wall["s"] = time.perf_counter() - t0
        wall["prof"] = prof
        return res

    entry.run_validation = profiled_run
    try:
        entry.main(argv, device=device)
    finally:
        entry.run_validation = real_run
    events = wall["prof"].key_averages()
    busy = sum((getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0)) / 1e6
               for e in events if getattr(e, "device_type", None) == DeviceType.CUDA)
    print(f"[validation-profile] run_validation, every kernel flag: {1e3 * busy:.1f} ms of "
          f"device time in a loop of {1e3 * wall['s']:.1f} ms profiled, "
          f"{1e3 * unprofiled_s:.1f} ms unprofiled: the device idles "
          f"{100 * (1 - busy / wall['s']):.1f}% / {100 * (1 - busy / unprofiled_s):.1f}%")
    print(events.table(sort_by="self_cpu_time_total", row_limit=25, max_name_column_width=60))


VALIDATION_VIDEOS = 24  # 8 each of v1s, v1m, v2: 160 valid frames in 240 slots
METRICS = ("miou", "acc", "fdr", "f_1", "f_0.3", "miou_ms", "acc_ms", "fdr_ms", "f_1_ms",
           "f_0.3_ms")


# phase 12 labels each pixel with the plain path's class, but leaves this
# share of the pixels, those where the top logit leads the second by the
# least, unlabeled (255): there the arms' bf16 summation orders can flip
# the argmax
UNLABELED_SHARE = 0.05


def relabel_with_the_model(model, config, dataset, base: Path, device) -> float:
    """Rewrite every mask of the synthetic split with the plain path's
    predictions, the least confident ``UNLABELED_SHARE`` of the pixels
    unlabeled: the seeded random model predicts none of the writer's
    classes, so every metric would be 0 in both arms. Returns the margin
    below which pixels are unlabeled."""
    import numpy as np
    import torch

    from cavp_tpu_torch.data.imageio import write_index_png
    from cavp_tpu_torch.engine.loops import make_inference_forward, preprocess_audio

    fwd = make_inference_forward(model, config.replace(**dict.fromkeys(ALL_FLAGS, False)))
    labels, margins = [], []
    for i in range(len(dataset)):
        item = dataset[i]
        n = int(item["mask_available"].sum())
        image = torch.from_numpy(item["image"][:n]).to(device)
        wave = torch.from_numpy(item["waveform"][:n, None]).to(device)
        top2 = fwd(image, preprocess_audio(wave, n_frames=config.mel_frames)).float().topk(2, -1)
        labels.append(top2.indices[..., 0].to(torch.uint8).cpu().numpy())
        margins.append((top2.values[..., 0] - top2.values[..., 1]).cpu().numpy())
    cut = float(np.quantile(np.concatenate([m.ravel() for m in margins]), UNLABELED_SHARE))
    for row, label, margin in zip(dataset.rows, labels, margins):
        label[margin < cut] = 255
        for f in range(len(label)):
            write_index_png(str(base / row["label"] / row["uid"] / "labels_semantic" / f"{f}.png"),
                            label[f])
    return cut


def validation_phase(config, model, state_dict, device, repo: Path,
                     profile: bool = False) -> dict:
    """Phase 12: the evaluation entry point, ``python -m
    cavp_tpu_torch.test_avs_semantic``, on an AVSBench-Semantics test split
    written to disk (224x224 frames, 71 classes, masks from the model's
    confident predictions) and the seeded model saved as a reference
    ``.pth``, with every eval kernel flag on and with every
    flag off: twice as a user runs it (a process each), then in this
    process (plain, kernels, kernels, plain) for the launch counts, the
    masks its eval steps predict, the metrics, frames/s and the host syncs.
    Returns the warm runs' numbers."""
    import shutil
    import warnings

    import numpy as np
    import torch

    from cavp_tpu_torch import test_avs_semantic
    from cavp_tpu_torch.config import load_args_and_config
    from cavp_tpu_torch.data.avss import AVSSDataset
    from cavp_tpu_torch.data.imageio import decoder_name, open_rgb
    from cavp_tpu_torch.data.synthetic import make_synthetic_avss
    from cavp_tpu_torch.engine import loops
    from cavp_tpu_torch.ops.kernels.fusion import fused_visual_fusion
    from cavp_tpu_torch.ops.kernels.layer1 import fused_layer1
    from cavp_tpu_torch.ops.kernels.mel import fused_log_mel
    from cavp_tpu_torch.ops.kernels.upsample_argmax import upsample_argmax

    wrappers = {"mel": fused_log_mel, "layer1": fused_layer1, "fusion": fused_visual_fusion,
                "argmax": upsample_argmax}

    root = repo / "build" / "chip_smoke_validation"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    base = Path(make_synthetic_avss(str(root), num_videos=VALIDATION_VIDEOS,
                                    image_size=config.image_height,
                                    num_classes=config.num_classes, splits=("test",)))
    pth = root / "avss_224.pth"
    torch.save({"model": state_dict}, pth)
    argv = ["--setup", "avss", "--root_dataset_dir", str(root), "--ckpt_path", str(pth)]
    arms = {"kernels": argv + [f"--{f}" for f in ALL_FLAGS], "plain": argv}
    cfg = load_args_and_config(arms["kernels"])
    require(cfg.num_classes == config.num_classes and cfg.compute_dtype == "bfloat16"
            and all(getattr(cfg, f) for f in ALL_FLAGS), f"entry point config {cfg}")
    cut = relabel_with_the_model(model, config, AVSSDataset(cfg, "test"), base, device)
    print(f"[validation] wrote {VALIDATION_VIDEOS} test videos at {config.image_height}x"
          f"{config.image_width} and {pth.name} ({pth.stat().st_size / 1e6:.0f} MB) in "
          f"{time.perf_counter() - t0:.1f} s; the masks are the plain path's predictions, "
          f"unlabeled where the top logit leads by less than {cut:.4f} "
          f"({100 * UNLABELED_SHARE:.0f}% of the pixels)")
    item = AVSSDataset(cfg, "test")[2]  # a v2 video: 10 frames

    # the decoder: PIL, the JAX package's; the frames are its decode
    frame = base / "v2" / "test_vid2" / "frames" / "0.jpg"
    ref = (np.asarray(open_rgb(str(frame)), np.float32) / 255.0
           - np.float32(cfg.image_mean)) / np.float32(cfg.image_std)
    decode_err = float(np.abs(item["image"][0] - ref).max())
    require(decode_err == 0.0, f"frame differs from PIL's decode by {decode_err}")
    print(f"[validation] decoder {decoder_name()} (the JAX package's); frames equal to "
          f"PIL's decode, largest difference {decode_err} (0 levels of 255)")

    # as a user runs it, one process each
    for name, args in arms.items():
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "cavp_tpu_torch.test_avs_semantic", *args],
                             cwd=repo, capture_output=True, text=True, timeout=600)
        lines = [ln.split(" | INFO | ")[-1] for ln in out.stderr.splitlines()
                 if "|ALL|" in ln or "|MS|" in ln]
        require(out.returncode == 0 and len(lines) == 2,
                f"{name}: exit {out.returncode}\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
        print(f"[validation] python -m cavp_tpu_torch.test_avs_semantic ({name}) exit 0 in "
              f"{time.perf_counter() - t0:.1f} s: {lines[0]} || {lines[1]}")

    # in this process: the launches, the report, the metrics, the syncs
    reports = []
    real_load = test_avs_semantic.load_model_variables
    test_avs_semantic.load_model_variables = lambda *a: reports.append(real_load(*a)) or reports[-1]
    real_run = test_avs_semantic.run_validation
    syncs = []

    def counted_run(*a, **kw):
        # every operation that makes the host wait for the device warns
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res = real_run(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs.append(sum("synchroniz" in str(w.message) for w in caught))
        return res

    # the masks each eval step of the loop predicts, kept on the card
    real_pred = loops.make_eval_pred_forward
    masks = []

    def recording_pred_forward(*a, **kw):
        pred_fn = real_pred(*a, **kw)

        def recorded(image, audio):
            pred = pred_fn(image, audio)
            masks[-1].append(pred.clone())
            return pred
        return recorded

    test_avs_semantic.run_validation = counted_run
    loops.make_eval_pred_forward = recording_pred_forward
    runs = []
    try:
        for name in ("plain", "kernels", "kernels", "plain"):
            for fn in wrappers.values():
                fn.launches = 0
            stats = {}
            masks.append([])
            res = test_avs_semantic.main(arms[name], device=device, stats=stats)
            torch.cuda.synchronize()
            runs.append((name, res, stats, {k: fn.launches for k, fn in wrappers.items()}))
    finally:
        test_avs_semantic.load_model_variables = real_load
        test_avs_semantic.run_validation = real_run
        loops.make_eval_pred_forward = real_pred
    for report in reports:
        require(not report["missing"] and not report["unexpected"],
                f"the strict load reported {report['missing'][:5]} {report['unexpected'][:5]}")
    print(f"[validation] strict .pth load: {len(reports[0]['converted'])} tensors, nothing "
          "missing, nothing unexpected")

    layer1_blocks = 3  # ResNet-50's layer1
    warm = {}
    for (name, res, stats, launches), n_sync in zip(runs, syncs):
        steps = stats["steps"]
        want = ({"mel": steps, "layer1": layer1_blocks * steps, "fusion": steps,
                 "argmax": steps} if name == "kernels" else dict.fromkeys(wrappers, 0))
        require(launches == want, f"{name}: {steps} eval steps launched {launches}")
        require(stats["frames"] == 20 * VALIDATION_VIDEOS // 3,
                f"{name}: {stats['frames']} valid frames")
        require(all(0.0 <= v <= 1.0 for v in res.values() if v == v), f"{name}: {res}")
        fps = stats["frames"] / stats["wall_s"]
        wait = stats["loader_wait_s"] / stats["wall_s"]
        print(f"[validation] {name}: {steps} eval steps of 10 frames launched {launches}; "
              f"{stats['frames']} frames in {stats['wall_s']:.3f} s, {fps:.1f} frames/s "
              f"(decode included), loader wait {100 * wait:.1f}% of the loop, "
              f"{n_sync} host syncs in run_validation")
        warm[name] = dict(res=res, fps=fps, wait=wait, syncs=n_sync, launches=launches)
    if profile:
        profile_validation(test_avs_semantic, arms["kernels"], device,
                           runs[2][2]["wall_s"])
    require(warm["kernels"]["syncs"] == 1,
            f"run_validation with every kernel flag made {warm['kernels']['syncs']} host syncs, "
            "not one")
    # the kernel arm's masks against the plain arm's, step by step: both
    # loops see the same frames in the same order
    pairs = ((1, 0), (2, 3))
    agree = []
    for k, p in pairs:
        require(len(masks[k]) == len(masks[p]) == runs[k][2]["steps"],
                f"recorded {len(masks[k])} and {len(masks[p])} steps' masks")
        mk, mp = torch.cat(masks[k]), torch.cat(masks[p])
        require(mk.shape == mp.shape == (runs[k][2]["frames"], config.image_height,
                                         config.image_width) and mk.dtype == torch.int32,
                f"masks {tuple(mk.shape)} {mk.dtype}")
        require(len(torch.unique(mp)) > 1, "the plain arm predicted one class everywhere")
        agree.append(float((mk == mp).double().mean()))
    same_kernel_runs = all(bool(torch.equal(a, b)) for a, b in zip(masks[1], masks[2]))
    del masks
    print(f"[validation] the masks of the kernel arm's eval steps agree with the plain arm's "
          f"on {100 * agree[0]:.4f}% / {100 * agree[1]:.4f}% of the pixels (limit "
          f"{100 * VALIDATION_MASK_AGREEMENT}%); the two kernel runs' masks "
          f"{'bit-equal' if same_kernel_runs else 'not bit-equal'}")
    require(min(agree) >= VALIDATION_MASK_AGREEMENT,
            f"the kernel arm's masks agree with the plain arm's on only {min(agree):.4f}")
    kern, plain = warm["kernels"]["res"], warm["plain"]["res"]
    require(all((kern[k] == kern[k]) == (plain[k] == plain[k]) for k in METRICS),
            f"NaN in one arm only: {kern} {plain}")
    diff = max((abs(kern[k] - plain[k]) for k in METRICS if kern[k] == kern[k]), default=0.0)
    require(0 < kern["miou"], f"no class found: {kern}")
    print(f"[validation] every kernel flag against every flag off: the ten metrics within "
          f"{diff:.2e} (limit {MEL_METRIC_ATOL}, phase 11's for its mel arm); miou "
          f"{kern['miou']:.6f} / {plain['miou']:.6f}, miou_ms {kern['miou_ms']:.6f} / "
          f"{plain['miou_ms']:.6f}")
    require(diff <= MEL_METRIC_ATOL, f"the arms' metrics differ by {diff}")
    shutil.rmtree(root, ignore_errors=True)
    return warm


TRAIN_VIDEOS = 48  # 16 each of v1s, v1m, v2: 3 steps an epoch at batch 16
TRAIN_TEST_VIDEOS = 24
TRAIN_FLAGS = ("use_pallas_fusion_train", "use_pallas_mel", "use_pallas_fusion",
               "use_pallas_argmax", "use_pallas_layer1")


def write_train_tree(root: Path, image_size: int, num_classes: int) -> None:
    """A train split of TRAIN_VIDEOS and a test split of TRAIN_TEST_VIDEOS
    under ``root`` (the writer makes one size for every split it writes;
    the two metadata files are joined)."""
    from cavp_tpu_torch.data.synthetic import make_synthetic_avss

    base = Path(make_synthetic_avss(str(root), num_videos=TRAIN_VIDEOS, image_size=image_size,
                                    num_classes=num_classes, splits=("train",)))
    train_rows = (base / "metadata.csv").read_text().splitlines()[1:]
    make_synthetic_avss(str(root), num_videos=TRAIN_TEST_VIDEOS, image_size=image_size,
                        num_classes=num_classes, splits=("test",))
    rows = (base / "metadata.csv").read_text().splitlines()
    (base / "metadata.csv").write_text("\n".join(rows + train_rows) + "\n")


def _wrappers() -> dict:
    """Every kernel wrapper of the main paths, by name; K2's backward
    keeps one count per launch of its stages (and of its float32 kernel)."""
    from cavp_tpu_torch.ops.kernels import fusion_train as ft
    from cavp_tpu_torch.ops.kernels.fusion import fused_visual_fusion
    from cavp_tpu_torch.ops.kernels.layer1 import fused_layer1
    from cavp_tpu_torch.ops.kernels.mel import fused_log_mel
    from cavp_tpu_torch.ops.kernels.upsample_argmax import upsample_argmax

    return {"mel": fused_log_mel, "layer1": fused_layer1, "fusion": fused_visual_fusion,
            "argmax": upsample_argmax, "fwd": ft.token_chain_train,
            "bwd": ft.token_chain_train_backward}


def reset_launches() -> None:
    for name, fn in _wrappers().items():
        if name == "bwd":
            fn.launches.update(dict.fromkeys(fn.launches, 0))
        else:
            fn.launches = 0


def read_launches() -> dict:
    """{mel, layer1, fusion, argmax, fwd, stage_a, stage_b, reduce, f32}."""
    w = _wrappers()
    bwd = w.pop("bwd")
    return dict({k: fn.launches for k, fn in w.items()}, **bwd.launches)


def training_phase(config, device, repo: Path) -> dict:
    """Phase 13: the training entry point, ``python -m
    cavp_tpu_torch.main_avss_resize``, at the avss setup's own size (512x512
    under ``--resize_flag`` from 224x224 files, batch 16, bf16, 71 classes)
    with every kernel flag: once as a user runs it (2 epochs, 6 steps, the
    validation at epoch 0), then in this process: the kernel arm preempted
    after its third step (launch counts, host syncs, the groups and the bank
    moved, the ``preempt`` file against the live state), the resume from
    that file, and the plain arm (1 epoch, no launch, its first step against
    the kernel arm's). The kernels are held against their plain versions at
    this phase's shapes in phases 3, 6 and 8-10. Returns its numbers."""
    import os
    import shutil
    import signal
    import warnings

    import numpy as np
    import torch

    from cavp_tpu_torch import main_avss_resize
    from cavp_tpu_torch.engine import checkpoint, runner
    from cavp_tpu_torch.engine.optim import GROUPS, label_params

    root = repo / "build" / "chip_smoke_training"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_train_tree(root / "data", config.image_height, config.num_classes)
    base = ["--setup", "avss", "--resize_flag", "--root_dataset_dir", str(root / "data")]
    flags = [f"--{f}" for f in TRAIN_FLAGS]
    cli = base + ["--num_workers", "8", "--epochs", "2"] + flags
    # in this process one loader thread: the items' random draws then come
    # in one order, and the kernel and plain arms get the same batches
    kernels = base + ["--num_workers", "1", "--epochs", "2"] + flags
    print(f"[training] wrote {TRAIN_VIDEOS} train and {TRAIN_TEST_VIDEOS} test videos at "
          f"{config.image_height}x{config.image_width} in {time.perf_counter() - t0:.1f} s")

    # as a user runs it, in a working directory of its own
    cwd = root / "cli"
    cwd.mkdir(parents=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "cavp_tpu_torch.main_avss_resize", *cli],
                         cwd=cwd, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(repo)))
    wall = time.perf_counter() - t0
    lines = [ln.split(" | INFO | ")[-1] for ln in out.stderr.splitlines()
             if " | INFO | " in ln and ("epoch " in ln or "|ALL|" in ln)]
    require(out.returncode == 0 and len(lines) == 3,
            f"main_avss_resize: exit {out.returncode}\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    written = sorted(p.name for p in (cwd / "checkpoints").iterdir())
    print(f"[training] python -m cavp_tpu_torch.main_avss_resize (every kernel flag) exit 0 in "
          f"{wall:.1f} s of process wall time: {' || '.join(lines)}; checkpoints {written}")

    # in this process: the kernel arm, preempted after its third step
    real = dict(init_state=runner.init_state, make_train_step=runner.make_train_step,
                run_validation=runner.run_validation, to_device=runner._to_device,
                read=runner.MetricReader.read, save=checkpoint.save_checkpoint,
                atomic=checkpoint._atomic_save)
    rec = dict(states=[], steps=[], events=[], syncs=[], upload_syncs=[], read_syncs=[],
               eval_steps=[], saves=[], writes=[], preempt_after=None)

    def counted(fn, into):
        """fn under torch.cuda.set_sync_debug_mode("warn"), its syncs counted"""
        def run(*a, **kw):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    res = fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            rec[into].append(sum("synchroniz" in str(w.message) for w in caught))
            return res
        return run

    def init_state(*a, **kw):
        state = real["init_state"](*a, **kw)
        rec["states"].append(state)
        rec["start"] = ({k: v.clone() for k, v in state.model.named_parameters()},
                        state.sound_bank.clone())
        return state

    def make_train_step(*a, **kw):
        step = counted(real["make_train_step"](*a, **kw), "syncs")

        def recorded(state, batch, epoch):
            before = state.step
            # the step on the stream, from its first kernel's turn to its
            # last: events, no sync
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
            state, metrics = step(state, batch, epoch)
            events[1].record()
            rec["events"].append(events)
            bkb = next(g for g in state.optimizers.sgd.param_groups if g["name"] == "bkb_decay")
            rec["steps"].append((before, int(epoch), bkb["lr"], metrics))
            if rec["preempt_after"] == len(rec["steps"]):
                os.kill(os.getpid(), signal.SIGTERM)  # PreemptionSignal's flag
            return state, metrics
        return recorded

    def run_validation(*a, **kw):
        stats = {}
        res = real["run_validation"](*a, stats=stats, **kw)
        rec["eval_steps"].append(stats["steps"])
        return res

    in_validation = []

    def to_device(batch, dev):
        if in_validation:
            return real["to_device"](batch, dev)
        return counted(real["to_device"], "upload_syncs")(batch, dev)

    def save_checkpoint(path, state, extra=None, blocking=True):
        t = time.perf_counter()
        out_path = real["save"](path, state, extra, blocking)
        rec["saves"].append((Path(path).name, time.perf_counter() - t, blocking))
        return out_path

    def atomic_save(path, payload):
        t = time.perf_counter()
        real["atomic"](path, payload)
        rec["writes"].append((Path(path).name, time.perf_counter() - t, os.path.getsize(path)))

    def validation_flagged(*a, **kw):
        in_validation.append(True)
        try:
            return run_validation(*a, **kw)
        finally:
            in_validation.pop()

    runner.init_state, runner.make_train_step = init_state, make_train_step
    runner.run_validation, runner._to_device = validation_flagged, to_device
    runner.MetricReader.read = counted(real["read"], "read_syncs")
    checkpoint.save_checkpoint, checkpoint._atomic_save = save_checkpoint, atomic_save
    here = os.getcwd()
    os.chdir(root)
    try:
        # the kernel arm: the counts are read from this run only
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec["preempt_after"] = 3
        stats = {}
        try:
            main_avss_resize.main(kernels, device=device, stats=stats)
            require(False, "the kernel arm was not preempted")
        except runner.PreemptedError as exc:
            message = str(exc)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = read_launches()
        live = rec["states"][-1]
        steps, syncs = list(rec["steps"]), list(rec["syncs"])
        uploads, reads, eval_steps = list(rec["upload_syncs"]), list(rec["read_syncs"]), \
            list(rec["eval_steps"])

        n_eval = sum(eval_steps)
        want = {"mel": len(steps) + n_eval, "layer1": 3 * n_eval, "fusion": n_eval,
                "argmax": n_eval, "fwd": len(steps), "stage_a": len(steps),
                "stage_b": len(steps), "reduce": len(steps), "f32": 0}
        require(len(steps) == 3 and [e for _, e, _, _ in steps] == [0, 0, 0],
                f"the kernel arm took {[(s, e) for s, e, _, _ in steps]}")
        require(launches == want, f"the kernel arm's {len(steps)} train steps and {n_eval} eval "
                f"steps launched {launches}, not {want}")
        losses = [float(m["loss/loss"]) for _, _, _, m in steps]
        first_metrics = steps[0][3]
        ctr = [float(m["loss/l_ctr_av"]) for _, _, _, m in steps]
        require(all(np.isfinite(losses)) and all(c > 0 for c in ctr),
                f"losses {losses}, l_ctr_av {ctr}")
        params0, bank0 = rec.pop("start")
        labels = label_params(live.model)
        moved = {labels[n] for n, p in live.model.named_parameters()
                 if not torch.equal(p, params0[n])}
        require(moved == set(GROUPS), f"groups that did not move: {set(GROUPS) - moved}")
        require(not torch.equal(live.sound_bank, bank0), "the sound bank did not move")
        del params0, bank0
        # the process's first train step at this size fills the caches (the
        # label resize's index tables, the mel's bases): copies that wait
        require(syncs[1:] == [0] * 2 and uploads == [0] * 3,
                f"host syncs: in the train steps {syncs}, in their batch uploads {uploads}")
        require(stats["metric_waits"] == len(reads) == 3 and reads == [0] * 3,
                f"metric reads: {stats['metric_waits']} event waits, syncs {reads}")
        print(f"[training] kernel arm: {len(steps)} train steps (epoch 0) launched K2 forward "
              f"{launches['fwd']}, backward stages {launches['stage_a']}/{launches['stage_b']}/"
              f"{launches['reduce']}, K3 mel {launches['mel']} ({len(steps)} train + {n_eval} "
              f"eval), K1 {launches['fusion']}, K4 {launches['argmax']}, K5 {launches['layer1']} "
              f"over {n_eval} eval steps; losses {' '.join(f'{v:.4f}' for v in losses)}, "
              f"l_ctr_av {' '.join(f'{v:.4f}' for v in ctr)}; all {len(GROUPS)} optimizer "
              f"groups and the sound bank moved")
        print(f"[training] host syncs: {syncs} inside the train steps (the first fills the "
              f"caches), {uploads} in their batch uploads, {reads} in the lagged metric reads, "
              f"which waited on {stats['metric_waits']} events (the previous display point's)")

        # the preempt file against the live state
        path = Path(message.split("--ckpt_path ")[-1])
        require(path.name == "preempt.pth" and path.is_file(), f"preemption: {message}")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        unequal = []
        parts = {"model": live.model.state_dict(),
                 "visual_optimizer": live.optimizers.sgd.state_dict(),
                 "audio_optimizer": live.optimizers.adam.state_dict()}
        for part, sd in parts.items():
            saved = payload[part]
            if part == "model":
                pairs = [(k, saved[k], v) for k, v in sd.items()]
            else:
                pairs = [(f"{i}/{k}", saved["state"][i][k], v) for i, st in sd["state"].items()
                         for k, v in st.items()]
                if saved["param_groups"] != sd["param_groups"]:
                    unequal.append(f"{part}/param_groups")
            for name, a, b in pairs:
                if a.dtype != b.dtype or not torch.equal(a.to(b.device), b):
                    unequal.append(f"{part}/{name}")
        if not torch.equal(payload["sound_bank"].to(device), live.sound_bank):
            unequal.append("sound_bank")
        if not torch.equal(payload["generator"], live.generator.get_state()):
            unequal.append("generator")
        counters = {k: payload[k] for k in ("step", "epoch", "iteration", "best_iou")}
        require(unequal == [] and counters["step"] == live.step == 3
                and (counters["epoch"], counters["iteration"]) == (0, 2),
                f"the preempt file differs from the live state: {unequal[:10]} {counters}")
        n_tensors = sum(len(p) for p in parts.values())
        del payload, parts, live
        rec["states"].clear()
        print(f"[training] preempted after step 3: {path.name} "
              f"({path.stat().st_size / 1e9:.3f} GB) bit-equal to the live state ({n_tensors} "
              f"tensors of the model and both optimizers, the sound bank, the generator), "
              f"counters {counters}")
        saves = list(rec["saves"])
        writes = list(rec["writes"])

        # the resume, from the file, with the kernels
        rec["steps"].clear()
        rec["events"].clear()
        rec["preempt_after"] = None
        t = time.perf_counter()
        warm = {}
        state, best = main_avss_resize.main(kernels + ["--ckpt_path", str(path)], device=device,
                                            stats=warm)
        resume_s = time.perf_counter() - t
        torch.cuda.synchronize()
        step_ms = [a.elapsed_time(b) for a, b in rec["events"]]
        first, epoch, lr, _ = rec["steps"][0]
        sched = state.optimizers.schedule  # step i runs at schedule(i - 1)
        require(first == 3 and epoch == 1 and state.step == 6
                and [e for _, e, _, _ in rec["steps"]] == [1, 1, 1],
                f"resumed at step {first}, epoch {epoch}; steps {rec['steps']}")
        want_lr = state.optimizers.lr_at(first)
        require(lr == want_lr and want_lr == sched(first - 1),
                f"resumed lr {lr}, the schedule's {want_lr}")
        require(best == counters["best_iou"], f"best_iou {best} against {counters['best_iou']}")
        print(f"[training] resumed from {path.name}: epoch 1 from step {first} at the "
              f"backbone lr {lr:.6g} (the schedule's at that step), 3 steps, exit normal in "
              f"{resume_s:.1f} s; best_iou {best:.6f} restored")
        del state
        rec["states"].clear()

        # the plain arm: no launch; its first step takes the kernel arm's
        # first batch from the same state, so the two first steps' losses
        # agree within phase 7's limit
        reset_launches()
        rec["steps"].clear()
        main_avss_resize.main(base + ["--num_workers", "1", "--epochs", "1"], device=device)
        require(all(v == 0 for v in read_launches().values()) and len(rec["steps"]) == 3,
                f"the plain arm launched {read_launches()}")
        report = []
        for k in ("loss/loss", "loss/cross_entropy", "loss/l_ctr_av"):
            got, ref = float(first_metrics[k]), float(rec["steps"][0][3][k])
            rel = abs(got - ref) / abs(ref)
            report.append(f"{k} {got:.5f} against {ref:.5f} ({rel:.2e})")
            require(rel <= LOSS_REL, f"the kernel arm's first {k} is off the plain arm's: "
                                     + report[-1])
        print(f"[training] plain arm: 3 steps and a validation, no kernel launched; the first "
              f"step, kernel arm against plain on the same batch (relative difference, limit "
              f"{LOSS_REL}): " + ", ".join(report))
        rec["states"].clear()
    finally:
        os.chdir(here)
        runner.init_state, runner.make_train_step = real["init_state"], real["make_train_step"]
        runner.run_validation, runner._to_device = real["run_validation"], real["to_device"]
        runner.MetricReader.read = real["read"]
        checkpoint.save_checkpoint, checkpoint._atomic_save = real["save"], real["atomic"]

    res = dict(launches=launches, n_eval=n_eval, peak=peak, cli_s=wall, saves=saves,
               writes=writes, step_ms=step_ms)
    for name, st in (("cold", stats), ("warm", warm)):
        res[name] = dict(steps_per_s=st["steps"] / st["wall_s"],
                         frames_per_s=st["frames"] / st["wall_s"],
                         wait=st["loader_wait_s"] / st["wall_s"])
    print(f"[training] kernel arm, epoch 0 (the process's first steps at this size): "
          f"{stats['steps']} steps of 16 frames in {stats['wall_s']:.3f} s (one loader "
          f"thread), "
          f"{res['cold']['steps_per_s']:.3f} steps/s, {res['cold']['frames_per_s']:.1f} frames/s "
          f"with the loader, loader wait {100 * res['cold']['wait']:.1f}%; the resumed epoch 1 "
          f"(warm): {warm['steps']} steps in {warm['wall_s']:.3f} s, "
          f"{res['warm']['steps_per_s']:.3f} steps/s, {res['warm']['frames_per_s']:.1f} "
          f"frames/s, loader wait {100 * res['warm']['wait']:.1f}%, the steps on the stream "
          f"{' / '.join(f'{v:.1f}' for v in step_ms)} ms (CUDA events); validation "
          f"{stats['validation_s']:.2f} s; peak memory {peak:.2f} GiB; checkpoints: "
          + "; ".join(f"{n} host copies and hand-off {s:.2f} s ({'blocking' if b else 'async'})"
                      for n, s, b in saves) + "; writes: "
          + "; ".join(f"{n} {sz / 1e9:.3f} GB in {s:.2f} s" for n, s, sz in writes)
          + f"; process wall time {wall:.1f} s; {card_line()}")
    shutil.rmtree(root, ignore_errors=True)
    return res


BINARY_JF_VIDEOS = 8  # S4 and MS3 test videos each: 2 J&F steps of 4 videos


def relabel_binary(model, config, device) -> None:
    """Rewrite the S4 and MS3 test masks from the model's own view: a pixel
    is an object where the class-1 logit leads class 0 by more than that
    frame's median lead, so half of every frame is foreground and J and F
    measure how well the argmax and the softmax find it (the writer's
    squares mean nothing to the random model, and J would sit at chance)."""
    import numpy as np
    import torch

    from cavp_tpu_torch.data.avsbench import MS3Dataset, S4Dataset, s4_paths
    from cavp_tpu_torch.data.imageio import write_png
    from cavp_tpu_torch.engine.loops import make_inference_forward, preprocess_audio

    fwd = make_inference_forward(model, config.replace(**dict.fromkeys(ALL_FLAGS, False)))
    s4 = S4Dataset(config, "test")
    ms3 = MS3Dataset(config, "test")
    for ds in (s4, ms3):
        for i in range(len(ds)):
            item = ds[i]
            wave = torch.from_numpy(item["waveform"][:5, None]).to(device)
            logits = fwd(torch.from_numpy(item["image"][:5]).to(device),
                         preprocess_audio(wave, n_frames=config.mel_frames)).float()
            lead = logits[..., 1] - logits[..., 0]
            masks = (lead > lead.flatten(1).median(1).values[:, None, None]).cpu().numpy()
            for f in range(5):
                if ds is s4:
                    video, _, category = ds.rows[i][:3]
                    path = Path(s4_paths(config.data_root)["dir_mask"]) / "test" / category \
                        / video / f"{video}_{f + 1}.png"
                else:
                    path = Path(ds._mask(ds.videos[i], f + 1))
                write_png(str(path), (masks[f] * 255).astype(np.uint8))


def binary_phase(device, repo: Path) -> dict:
    """Phase 14: the binary setup and the J&F test at their own sizes.
    ``avss_binary`` (224x224, 2 classes, 71-wide one-hot labels, batch 16,
    bf16) trains through ``python -m cavp_tpu_torch.main_avss_resize
    --resize_flag`` with every kernel flag, and ``python -m
    cavp_tpu_torch.test_avss_resize`` runs the J&F test on S4 (v1s) and MS3
    (v1m) test splits of BINARY_JF_VIDEOS videos whose masks are the model's
    (``relabel_binary``), loading the seeded model as a reference ``.pth``:
    (a) and (b) as a user runs them, three processes side by side, then in
    this process for the launch counts, the host syncs, the strict loads and
    the numbers; (c) both entry points with ``--use_baseline``. Returns its
    numbers."""
    import math
    import os
    import re
    import shutil
    import warnings

    import numpy as np
    import torch

    from cavp_tpu_torch import main_avss_resize, test_avss_resize
    from cavp_tpu_torch.config import get_config
    from cavp_tpu_torch.data.synthetic import make_synthetic_avsbench
    from cavp_tpu_torch.engine import runner
    from cavp_tpu_torch.engine.optim import GROUPS, label_params

    root = repo / "build" / "chip_smoke_binary"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    data, objects = root / "data", root / "objects"
    write_train_tree(data, 224, 71)  # class masks, collapsed to binary by the setup
    make_synthetic_avsbench(str(objects), num_videos=BINARY_JF_VIDEOS, image_size=224,
                            splits=("test",))
    config = get_config("avss_binary").replace(data_root=str(objects), resize_flag=True)
    require(config.num_classes == 2 and config.image_height == 224, f"avss_binary {config}")
    model = runner.build_model(config, device)
    random_weights(model, config, device)
    state_dict = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    pth, visual_pth = root / "cavp_avsobj_ss.pth", root / "visual_baseline.pth"
    torch.save({"model": state_dict}, pth)
    torch.save({"model": {k: v for k, v in state_dict.items()
                          if k.startswith(("backbone.", "segment."))}}, visual_pth)
    relabel_binary(model, config, device)
    del model, state_dict
    torch.cuda.empty_cache()
    print(f"[binary] wrote the avss_binary tree ({TRAIN_VIDEOS} train, {TRAIN_TEST_VIDEOS} test "
          f"videos), S4 and MS3 test splits of {BINARY_JF_VIDEOS} videos at 224x224 (masks from "
          f"the model, half of each frame) and the 2-class model as {pth.name} in "
          f"{time.perf_counter() - t0:.1f} s")

    flags = [f"--{f}" for f in TRAIN_FLAGS]
    train = ["--setup", "avss_binary", "--resize_flag", "--root_dataset_dir", str(data),
             "--epochs", "1"]

    def jf_argv(split, ckpt=pth):
        return ["--setup", "avss_binary", "--resize_flag", "--data_root", str(objects),
                "--avsbench_split", split, "--ckpt_path", str(ckpt)]

    # (a) and (b) as a user runs them: three processes side by side
    cwd = root / "cli"
    cwd.mkdir(parents=True)
    commands = {
        "main_avss_resize": (["cavp_tpu_torch.main_avss_resize", *train, "--num_workers", "8",
                              *flags], cwd),
        "test_avss_resize v1s": (["cavp_tpu_torch.test_avss_resize", *jf_argv("v1s")], repo),
        "test_avss_resize v1m": (["cavp_tpu_torch.test_avss_resize", *jf_argv("v1m")], repo)}
    t0 = time.perf_counter()
    procs = {}
    for name, (args, where) in commands.items():
        log = open(root / f"{name.replace(' ', '_')}.log", "w+")
        procs[name] = (subprocess.Popen([sys.executable, "-m", *args], cwd=where, stdout=log,
                                        stderr=subprocess.STDOUT,
                                        env=dict(os.environ, PYTHONPATH=str(repo))), log)
    for name, (proc, log) in procs.items():
        code = proc.wait(timeout=600)
        log.seek(0)
        text = log.read()
        log.close()
        lines = [ln.split(" | INFO | ")[-1] for ln in text.splitlines() if " | INFO | " in ln
                 and ("epoch " in ln or "|ALL|" in ln or "J&F:" in ln)]
        if name == "main_avss_resize":
            ok = code == 0 and len(lines) == 2 and (cwd / "checkpoints").is_dir()
        else:
            nums = [float(v) for v in re.findall(r"(?:mIoU|F|J&F): ([-\w.]+)", lines[-1])] \
                if lines else []
            ok = (code == 0 and len(nums) == 3 and all(math.isfinite(v) for v in nums)
                  and "with no place" not in text and "did not fill" not in text)
        require(ok, f"{name}: exit {code}\n{text[-4000:]}")
        print(f"[binary] python -m cavp_tpu_torch.{name} exit 0: {' || '.join(lines)}")
    print(f"[binary] the three processes side by side in {time.perf_counter() - t0:.1f} s "
          f"of wall time")

    # in this process: the train steps and the eval steps, counted
    real = dict(init_state=runner.init_state, make_train_step=runner.make_train_step,
                run_validation=runner.run_validation)
    rec = dict(steps=[], syncs=[], events=[], eval_steps=[], start=None, state=None)

    def init_state(*a, **kw):
        state = real["init_state"](*a, **kw)
        rec["state"] = state
        rec["start"] = ({k: v.clone() for k, v in state.model.named_parameters()},
                        state.sound_bank.clone())
        return state

    def make_train_step(*a, **kw):
        step = real["make_train_step"](*a, **kw)

        def counted(state, batch, epoch):
            # the step on the stream, from its first kernel's turn to its
            # last: events, no sync
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    events[0].record()
                    state, metrics = step(state, batch, epoch)
                    events[1].record()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            rec["events"].append(events)
            rec["syncs"].append(sum("synchroniz" in str(w.message) for w in caught))
            rec["steps"].append({k: float(v) for k, v in metrics.items()})
            return state, metrics
        return counted

    def run_validation(*a, **kw):
        stats = {}
        res = real["run_validation"](*a, stats=stats, **kw)
        rec["eval_steps"].append(stats["steps"])
        return res

    def train_arm(argv):
        """One epoch in this process; returns (launches, stats, moved groups,
        whether the sound bank moved, peak GiB)."""
        for k in ("steps", "syncs", "events", "eval_steps"):
            rec[k] = []
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        main_avss_resize.main(argv, device=device, stats=stats)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        state, (params0, bank0) = rec.pop("state"), rec.pop("start")
        labels = label_params(state.model)
        moved = {labels[n] for n, p in state.model.named_parameters()
                 if not torch.equal(p, params0[n])}
        bank_moved = not torch.equal(state.sound_bank, bank0)
        rec["state"] = rec["start"] = None
        del state, params0, bank0
        return read_launches(), stats, moved, bank_moved, peak

    def jf_arm(argv):
        reset_launches()
        stats, report = {}, {}
        res = test_avss_resize.main(argv, device=device, stats=stats, report=report)
        torch.cuda.synchronize()
        launched = {k: v for k, v in read_launches().items() if v}
        require(not launched, f"the J&F test launched {launched}")
        require(not report["missing"] and not report["unexpected"],
                f"the strict load reported {report['missing'][:5]} {report['unexpected'][:5]}")
        require(all(math.isfinite(v) for v in res.values()) and 0 < res["miou"] < 1,
                f"J&F results {res}")
        require(stats["videos"] == BINARY_JF_VIDEOS and stats["steps"] == 2,
                f"J&F loop {stats}")
        return res, stats

    runner.init_state, runner.make_train_step = init_state, make_train_step
    runner.run_validation = run_validation
    here = os.getcwd()
    os.chdir(root)
    out = {}
    try:
        # (a) the kernel arm, one loader thread so that the plain arm draws
        # the same batches; no best_model written
        argv = train + ["--num_workers", "1", "--ignore_ckpt"]
        launches, stats, moved, bank_moved, peak = train_arm(argv + flags)
        steps, syncs, n_eval = list(rec["steps"]), list(rec["syncs"]), sum(rec["eval_steps"])
        step_ms = [a.elapsed_time(b) for a, b in rec["events"]]
        want = {"mel": len(steps) + n_eval, "layer1": 3 * n_eval, "fusion": n_eval,
                "argmax": n_eval, "fwd": len(steps), "stage_a": len(steps),
                "stage_b": len(steps), "reduce": len(steps), "f32": 0}
        require(len(steps) == 3 and n_eval > 0 and launches == want,
                f"avss_binary: {len(steps)} train steps and {n_eval} eval steps launched "
                f"{launches}, not {want}")
        losses = [m["loss/loss"] for m in steps]
        require(all(np.isfinite(losses)), f"losses {losses}")
        require(syncs[1:] == [0, 0], f"host syncs in the train steps: {syncs}")
        require(moved == set(GROUPS) and not bank_moved,
                f"groups moved {sorted(moved)}; the sound bank moved: {bank_moved}")
        first = steps[0]
        print(f"[binary] avss_binary kernel arm: {len(steps)} train steps launched K2 forward "
              f"{launches['fwd']}, backward stages {launches['stage_a']}/{launches['stage_b']}/"
              f"{launches['reduce']}, K3 {launches['mel']} ({len(steps)} train + {n_eval} eval), "
              f"K1 {launches['fusion']}, K4 {launches['argmax']} (2 classes), K5 "
              f"{launches['layer1']} over {n_eval} eval steps; losses "
              f"{' '.join(f'{v:.4f}' for v in losses)}, l_ctr_av "
              f"{' '.join(f'{m['loss/l_ctr_av']:.4f}' for m in steps)}; host syncs {syncs} "
              f"(the first step fills the caches); all {len(GROUPS)} groups moved, the sound "
              f"bank not (no bank in the binary setup); the steps on the stream "
              f"{' / '.join(f'{v:.1f}' for v in step_ms)} ms (CUDA events; the first cold)")
        out["train"] = dict(step_ms=step_ms, steps_per_s=stats["steps"] / stats["wall_s"],
                            frames_per_s=stats["frames"] / stats["wall_s"],
                            wait=stats["loader_wait_s"] / stats["wall_s"], peak=peak,
                            launches=launches)

        launches, _, _, _, _ = train_arm(argv)
        require(all(v == 0 for v in launches.values()), f"the plain arm launched {launches}")
        report = []
        for k in ("loss/loss", "loss/cross_entropy", "loss/l_ctr_av"):
            got, ref = first[k], rec["steps"][0][k]
            rel = abs(got - ref) / max(abs(ref), 1e-12)
            report.append(f"{k} {got:.5f} against {ref:.5f} ({rel:.2e})")
            require(rel <= LOSS_REL, "the binary kernel arm's first step is off the plain "
                                     "arm's: " + report[-1])
        print(f"[binary] plain arm: no kernel launched; its first step against the kernel "
              f"arm's on the same batch (relative, limit {LOSS_REL}): " + ", ".join(report))

        # (b) the J&F test with every eval kernel flag given: none launches
        eval_flags = [f"--{f}" for f in ALL_FLAGS]
        for split in ("v1s", "v1m"):
            res, stats = jf_arm(jf_argv(split) + eval_flags)
            out[split] = dict(res=res, videos_per_s=stats["videos"] / stats["wall_s"],
                              wait=stats["loader_wait_s"] / stats["wall_s"])
            print(f"[binary] J&F test {split}: mIoU {res['miou']:.4f}, F {res['F_score']:.4f}, "
                  f"J&F {res['J&F']:.4f}; {stats['videos']} videos in {stats['steps']} steps of "
                  f"4 ({stats['wall_s']:.3f} s, {out[split]['videos_per_s']:.1f} videos/s with "
                  f"the loader, wait {100 * out[split]['wait']:.1f}%); strict load clean; no "
                  f"kernel launched, as in the JAX package, with every kernel flag given")

        # (c) --use_baseline: only K3, on the eval steps
        launches, stats, moved, _, _ = train_arm(argv + flags + ["--use_baseline"])
        n_eval = sum(rec["eval_steps"])
        want = dict.fromkeys(launches, 0)
        want["mel"] = n_eval
        require(launches == want and n_eval > 0,
                f"the baseline launched {launches} over {n_eval} eval steps")
        require(all(set(m) == {"loss/loss", "loss/cross_entropy"} and np.isfinite(m["loss/loss"])
                    for m in rec["steps"]) and moved == {"seg_decay", "seg_nodecay",
                                                         "bkb_decay", "bkb_nodecay"},
                f"baseline steps {rec['steps']}, groups moved {sorted(moved)}")
        base_jf = {}
        for split in ("v1s", "v1m"):
            base_jf[split], _ = jf_arm(jf_argv(split, visual_pth) + ["--use_baseline",
                                                                     *eval_flags])
        print(f"[binary] --use_baseline: {len(rec['steps'])} CE train steps (losses "
              f"{' '.join(f'{m['loss/loss']:.4f}' for m in rec['steps'])}) launched nothing, "
              f"its {n_eval} eval steps K3 {launches['mel']} and no K1, K2, K4 or K5; the J&F "
              f"test (strict load of the visual weights, no launch): v1s J&F "
              f"{base_jf['v1s']['J&F']:.4f}, v1m {base_jf['v1m']['J&F']:.4f}")
    finally:
        os.chdir(here)
        runner.init_state, runner.make_train_step = real["init_state"], real["make_train_step"]
        runner.run_validation = real["run_validation"]
    shutil.rmtree(root, ignore_errors=True)
    return out


VPO_TRAIN_IMAGES = 48  # 3 steps an epoch at batch 16
VPO_TEST_IMAGES = 32   # 2 validation steps of 16 single frames
VPO_SIDE = 512


def vpo_kernel_check(device) -> dict:
    """Phase 15 (a): K5, K1 and K2 (forward and backward) against their plain
    versions on the features of the VPO setups' own towers: ResNet-101 at
    output stride 8 (dilation [False, True, True]) and the ResNet-18 audio
    tower on 3 s of audio, 16 seeded 512x512 images, bf16, the limits of
    phases 3, 6 and 10. Its launches are not counted: each main path's run
    sets the counts to 0 first."""
    import numpy as np
    import torch

    from cavp_tpu_torch.config import get_config
    from cavp_tpu_torch.engine.loops import preprocess_audio
    from cavp_tpu_torch.engine.runner import build_model
    from cavp_tpu_torch.models.cavp import map_to_tokens
    from cavp_tpu_torch.ops.kernels import fusion_train as ft
    from cavp_tpu_torch.ops.kernels.fusion import (
        fused_visual_fusion, fused_visual_fusion_reference)
    from cavp_tpu_torch.ops.kernels.layer1 import fused_layer1, fused_layer1_reference

    config = get_config("vpo_ss").replace(num_classes=22)
    require(config.visual_backbone == 101 and config.image_height == VPO_SIDE
            and list(config.last_three_dilation_stride) == [False, True, True],
            f"the vpo_ss setup: {config}")
    model = build_model(config, device)
    random_weights(model, config, device)
    B = RESIZE_TRAIN_BATCH
    rng = np.random.RandomState(SEED + 40)
    img = rng.randint(0, 256, (B, VPO_SIDE, VPO_SIDE, 3)).astype(np.float32)
    img = (img / 255.0 - np.asarray(config.image_mean)) / np.asarray(config.image_std)
    image = torch.from_numpy(img.astype(np.float32)).to(device).permute(0, 3, 1, 2)
    wave = torch.from_numpy(((rng.rand(B, 1, config.audio_samples) - 0.5) * 0.2
                             ).astype(np.float32)).to(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    with torch.no_grad():
        resnet = model.backbone.backbone
        stem = resnet.stem_forward(image.to(model.dtype)).permute(0, 2, 3, 1).contiguous()
        got, ref = fused_layer1(resnet, stem), fused_layer1_reference(resnet, stem)
        err = (got.float() - ref.float()).abs()
        scale = float(ref.float().abs().max())
        ok = (float(err.max()) <= L1_BF16_MAX_REL * scale
              and float(err.mean()) <= L1_BF16_MEAN_REL * scale)
        print(f"[vpo] K5 on ResNet-101's stem output {list(stem.shape)} bf16: max_abs_err "
              f"{float(err.max()):.3e} mean {float(err.mean()):.3e}, largest output "
              f"{scale:.3f} (max {L1_BF16_MAX_REL} and mean {L1_BF16_MEAN_REL} of it: "
              f"{'ok' if ok else 'FAIL'})")
        require(ok, "K5 disagrees with its plain version behind ResNet-101")
        out["layer1"] = float(err.max())
        fea_v = model.forward_visual_feature(image)
        audio = preprocess_audio(wave, n_frames=config.mel_frames).permute(0, 3, 1, 2)
        fea_a = model.forward_audio_feature(audio)
        x = map_to_tokens(fea_v).contiguous()
        require(tuple(x.shape) == (B, RESIZE_TOKENS, 304) and tuple(fea_a.shape) == (B, 304),
                f"the VPO towers gave {list(x.shape)} and {list(fea_a.shape)}")
        got = fused_visual_fusion(model, x, fea_a)
        ref = fused_visual_fusion_reference(model, x, fea_a)
        err = (got.float() - ref.float()).abs()
        ok = float(err.max()) <= BF16_MAX_ABS and float(err.mean()) <= BF16_MEAN_ABS
        print(f"[vpo] K1 on the ResNet-101 OS8 features {list(x.shape)} and the ResNet-18 "
              f"audio features bf16: max_abs_err {float(err.max()):.3e} mean "
              f"{float(err.mean()):.3e} (max {BF16_MAX_ABS}, mean {BF16_MEAN_ABS}: "
              f"{'ok' if ok else 'FAIL'})")
        require(ok, "K1 disagrees with its plain version behind ResNet-101")
        out["fusion"] = float(err.max())
        fea_a2 = torch.cat([fea_a, fea_a[torch.arange(B, device=device).roll(1)]])
        wqk2, m2, ws = ft.train_operands(model, fea_a2, B, torch.bfloat16)
        y = ft.token_chain_train(x, wqk2, m2, ws)
        ref = ft.token_chain_train_reference(x, wqk2, m2, ws)
        err = (y.float() - ref.float()).abs()
        ok = float(err.max()) <= BF16_MAX_ABS and float(err.mean()) <= BF16_MEAN_ABS
        dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(SEED + 41)
                         ).to(device, torch.bfloat16)
        got = ft.token_chain_train_backward(x, wqk2, m2, ws, dy)
        ref_g = ft.token_chain_train_backward_reference(x, wqk2, m2, ws, dy)
        names = ("dx", "dwqk", "dm") + ft.WEIGHT_NAMES
        flat = lambda r: [r[0], r[1], r[2], *r[3]]
        rels = {k: float((a.float() - r.float()).abs().max()) / (float(r.float().abs().max())
                                                                   + 1e-30)
                for k, a, r in zip(names, flat(got), flat(ref_g))}
        worst = max(rels, key=rels.get)
        print(f"[vpo] K2 on the same features, dup 2 {list(y.shape)} bf16: forward max_abs_err "
              f"{float(err.max()):.3e} mean {float(err.mean()):.3e} (max {BF16_MAX_ABS}, mean "
              f"{BF16_MEAN_ABS}: {'ok' if ok else 'FAIL'}); backward, the worst of "
              f"{len(names)} gradients {worst} {rels[worst]:.2e} of its largest entry (limit "
              f"{GRAD_BF16_REL})")
        require(ok and rels[worst] <= GRAD_BF16_REL,
                "K2 disagrees with its plain version behind ResNet-101")
        out["fwd"], out["bwd"] = float(err.max()), rels[worst]
    del model
    torch.cuda.empty_cache()
    return out


def vpo_phase(device, repo: Path) -> dict:
    """Phase 15: the VPO training entry points at the setups' own size
    (512x512 COCO crops, batch 16, bf16, ResNet-101 at output stride 8, the
    ResNet-18 audio tower on 3 s of audio, 22 classes, every kernel flag) on
    a synthetic VPO tree: ``python -m cavp_tpu_torch.main_vpo_mono --setup
    vpo_ss`` and ``python -m cavp_tpu_torch.main_vpo_stereo --setup vpo_ms``
    (multi-source mixtures, flip-mirrored panning), one epoch of 3 steps and
    a validation of 2 steps of single frames. First K1, K2 and K5 behind the
    setups' towers (``vpo_kernel_check``); then each entry point as its own
    process; then each in this process, the kernel arm (launch counts, no host
    sync after the first train step, every optimizer group moved, the sound
    bank moved under vpo_mono only) and the plain arm (no launch, its first
    step within phase 7's limit). Returns its numbers."""
    import os
    import shutil
    import warnings

    import numpy as np
    import torch

    from cavp_tpu_torch import main_vpo_mono, main_vpo_stereo
    from cavp_tpu_torch.data.synthetic import make_synthetic_vpo
    from cavp_tpu_torch.engine import runner
    from cavp_tpu_torch.engine.optim import GROUPS, label_params

    root = repo / "build" / "chip_smoke_vpo"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    data = root / "data"
    make_synthetic_vpo(str(data), num_train=VPO_TRAIN_IMAGES, num_test=VPO_TEST_IMAGES,
                       image_size=VPO_SIDE, seed=SEED)
    print(f"[vpo] wrote VPO-SS, VPO-MS and VPO-MSMI trees ({VPO_TRAIN_IMAGES} train images of "
          f"mixed sizes, {VPO_TEST_IMAGES} test images at {VPO_SIDE}x{VPO_SIDE} each) and "
          f"3.5 s VGGSound clips in {time.perf_counter() - t0:.1f} s")
    out = {"kernels": vpo_kernel_check(device)}

    flags = [f"--{f}" for f in TRAIN_FLAGS]
    runs = (("main_vpo_mono", main_vpo_mono, "vpo_ss", "vpo_mono"),
            ("main_vpo_stereo", main_vpo_stereo, "vpo_ms", "vpo_stereo"))

    def argv(setup, *more):
        return ["--setup", setup, "--root_dataset_dir", str(data), "--epochs", "1", *more]

    # as a user runs them, each a process of its own in a directory of its own
    for name, _, setup, _ in runs:
        cwd = root / name
        cwd.mkdir(parents=True)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"cavp_tpu_torch.{name}",
                               *argv(setup, "--num_workers", "8", *flags)], cwd=cwd,
                              capture_output=True, text=True, timeout=600,
                              env=dict(os.environ, PYTHONPATH=str(repo)))
        lines = [ln.split(" | INFO | ")[-1] for ln in proc.stderr.splitlines()
                 if " | INFO | " in ln and ("epoch " in ln or "|ALL|" in ln)]
        require(proc.returncode == 0 and len(lines) == 2 and (cwd / "checkpoints").is_dir(),
                f"{name}: exit {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        print(f"[vpo] python -m cavp_tpu_torch.{name} --setup {setup} (every kernel flag) exit 0 "
              f"in {time.perf_counter() - t0:.1f} s: {' || '.join(lines)}")

    # in this process: the train steps and the eval steps, counted
    real = dict(init_state=runner.init_state, make_train_step=runner.make_train_step,
                run_validation=runner.run_validation)
    rec = dict(steps=[], syncs=[], events=[], eval_stats=[], start=None, state=None)

    def init_state(*a, **kw):
        state = real["init_state"](*a, **kw)
        rec["state"] = state
        rec["start"] = ({k: v.clone() for k, v in state.model.named_parameters()},
                        state.sound_bank.clone())
        return state

    def make_train_step(*a, **kw):
        step = real["make_train_step"](*a, **kw)

        def counted(state, batch, epoch):
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    events[0].record()
                    state, metrics = step(state, batch, epoch)
                    events[1].record()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            rec["events"].append(events)
            rec["syncs"].append(sum("synchroniz" in str(w.message) for w in caught))
            rec["steps"].append({k: float(v) for k, v in metrics.items()})
            return state, metrics
        return counted

    def run_validation(*a, **kw):
        stats = {}
        res = real["run_validation"](*a, stats=stats, **kw)
        rec["eval_stats"].append(stats)
        return res

    def train_arm(entry, args):
        for k in ("steps", "syncs", "events", "eval_stats"):
            rec[k] = []
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        entry.main(args, device=device, stats=stats)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        state, (params0, bank0) = rec.pop("state"), rec.pop("start")
        labels = label_params(state.model)
        moved = {labels[n] for n, p in state.model.named_parameters()
                 if not torch.equal(p, params0[n])}
        bank_moved = not torch.equal(state.sound_bank, bank0)
        rec["state"] = rec["start"] = None
        del state, params0, bank0
        torch.cuda.empty_cache()
        return read_launches(), stats, moved, bank_moved, peak

    runner.init_state, runner.make_train_step = init_state, make_train_step
    runner.run_validation = run_validation
    here = os.getcwd()
    os.chdir(root)
    try:
        for name, entry, setup, variant in runs:
            # one loader thread, so that the plain arm draws the same batches
            args = argv(setup, "--num_workers", "1", "--ignore_ckpt")
            launches, stats, moved, bank_moved, peak = train_arm(entry, args + flags)
            steps, syncs = list(rec["steps"]), list(rec["syncs"])
            evals = list(rec["eval_stats"])
            n_eval = sum(e["steps"] for e in evals)
            step_ms = [a.elapsed_time(b) for a, b in rec["events"]]
            want = {"mel": len(steps) + n_eval, "layer1": 3 * n_eval, "fusion": n_eval,
                    "argmax": n_eval, "fwd": len(steps), "stage_a": len(steps),
                    "stage_b": len(steps), "reduce": len(steps), "f32": 0}
            require(len(steps) == 3 and n_eval == 2 and launches == want,
                    f"{variant}: {len(steps)} train steps and {n_eval} eval steps launched "
                    f"{launches}, not {want}")
            require(evals[0]["frames"] == VPO_TEST_IMAGES, f"{variant} validation {evals}")
            losses = [m["loss/loss"] for m in steps]
            ctr = [m["loss/l_ctr_av"] for m in steps]
            require(all(np.isfinite(losses)) and all(c > 0 for c in ctr),
                    f"{variant}: losses {losses}, l_ctr_av {ctr}")
            require(syncs[1:] == [0, 0], f"{variant}: host syncs in the train steps {syncs}")
            require(moved == set(GROUPS), f"{variant}: groups that did not move "
                                          f"{set(GROUPS) - moved}")
            require(bank_moved == (variant == "vpo_mono"),
                    f"{variant}: the sound bank moved: {bank_moved}")
            first = steps[0]
            val = evals[0]
            res = dict(step_ms=step_ms, steps_per_s=stats["steps"] / stats["wall_s"],
                       frames_per_s=stats["frames"] / stats["wall_s"],
                       wait=stats["loader_wait_s"] / stats["wall_s"], peak=peak,
                       launches=launches, val_fps=val["frames"] / val["wall_s"],
                       val_wait=val["loader_wait_s"] / val["wall_s"], losses=losses)
            print(f"[vpo] {name} --setup {setup} kernel arm: {len(steps)} train steps launched "
                  f"K2 forward {launches['fwd']}, backward stages {launches['stage_a']}/"
                  f"{launches['stage_b']}/{launches['reduce']}, K3 {launches['mel']} "
                  f"({len(steps)} train + {n_eval} eval, [32, 48000] -> 300 frames), K1 "
                  f"{launches['fusion']}, K4 {launches['argmax']} (22 classes), K5 "
                  f"{launches['layer1']} over {n_eval} eval steps; losses "
                  f"{' '.join(f'{v:.4f}' for v in losses)}, l_ctr_av "
                  f"{' '.join(f'{v:.4f}' for v in ctr)}; host syncs {syncs} (the first step "
                  f"fills the caches); all {len(GROUPS)} optimizer groups moved, the sound bank "
                  f"{'moved' if bank_moved else 'not (no bank in vpo_stereo)'}")

            # the plain arm: no launch; its first step from the same state on
            # the same batch within phase 7's limit of the kernel arm's
            launches, _, _, _, _ = train_arm(entry, args)
            require(all(v == 0 for v in launches.values()),
                    f"{variant}: the plain arm launched {launches}")
            report = []
            for k in ("loss/loss", "loss/cross_entropy", "loss/l_ctr_av"):
                got, ref = first[k], rec["steps"][0][k]
                rel = abs(got - ref) / max(abs(ref), 1e-12)
                report.append(f"{k} {got:.5f} against {ref:.5f} ({rel:.2e})")
                require(rel <= LOSS_REL, f"{variant}: the kernel arm's first step is off the "
                                         "plain arm's: " + report[-1])
            print(f"[vpo] {variant} plain arm: no kernel launched; its first step against the "
                  f"kernel arm's on the same batch (relative, limit {LOSS_REL}): "
                  + ", ".join(report))
            print(f"[vpo] {variant} at {VPO_SIDE}x{VPO_SIDE}, batch 16, bf16, every kernel flag, "
                  f"one 3-step epoch on one loader thread (smoke readings): the steps on the "
                  f"stream {' / '.join(f'{v:.1f}' for v in step_ms)} ms (CUDA events; the first "
                  f"cold), {res['steps_per_s']:.3f} steps/s, {res['frames_per_s']:.1f} frames/s "
                  f"with the loader, loader wait {100 * res['wait']:.1f}%, peak memory "
                  f"{peak:.2f} GiB; the validation {val['frames']} frames in {val['steps']} "
                  f"steps, {res['val_fps']:.1f} frames/s with the loader (wait "
                  f"{100 * res['val_wait']:.1f}%); {card_line()}")
            out[variant] = res
    finally:
        os.chdir(here)
        runner.init_state, runner.make_train_step = real["init_state"], real["make_train_step"]
        runner.run_validation = real["run_validation"]
    shutil.rmtree(root, ignore_errors=True)
    return out


ZOO_HEADS = (("HRNet", 720), ("OCR", 512), ("PVT", 112))  # seg_model, its fusion width
# the zoo's all-flags masks against the plain arm's: the seeded random heads
# leave the top two of the 71 logits closer than the ResNet-50 model does,
# so the bf16 fusion stage's rounding (K1's chain against the module path's)
# flips more pixels (HRNet: 1.5%, measured) than phase 11's 0.2%
ZOO_MASK_AGREEMENT = 0.97
ZOO_TRAIN_VIDEOS = 32  # 2 steps an epoch at batch 16
ZOO_TEST_VIDEOS = 8


def zoo_head_check(seg: str, width: int, device) -> dict:
    """Phase 16 (a), one head of the seg-model zoo at full width (HRNet-W48,
    OCR on HRNet-W48, PVT-v2 b5), 224x224, bf16, 71 classes, seeded random
    weights: K1 at [120, 3136, C] on the head's own features against its
    plain version (phase 3's contract), two launches bit-equal, timed beside
    the plain version and the module path; K4 at 71 classes on the head's
    own classifier logits, bit-equal to the separable arm; the eval step
    with every kernel flag on (launches: K1, K3 and K4 once a step, K5
    never, since it is for the DeepLabV3+ ResNet tower) and its frames/s;
    the masks of the all-flags arm against the plain arm's."""
    import torch

    from cavp_tpu_torch.config import get_config
    from cavp_tpu_torch.data.synthetic import synthetic_eval_batch
    from cavp_tpu_torch.engine.loops import (
        eval_metrics_init, make_eval_pred_forward, make_eval_step, preprocess_audio)
    from cavp_tpu_torch.engine.runner import build_model
    from cavp_tpu_torch.models.cavp import map_to_tokens, tokens_to_map
    from cavp_tpu_torch.ops.interp import interpolate_bilinear_separable
    from cavp_tpu_torch.ops.kernels.fusion import (
        _launch as fusion_launch, fused_visual_fusion, fused_visual_fusion_reference,
        fusion_operands)
    from cavp_tpu_torch.ops.kernels.upsample_argmax import upsample_argmax

    config = get_config("avss").replace(image_width=224, image_height=224,
                                        compute_dtype="bfloat16", seg_model=seg)
    model = build_model(config, device)
    random_weights(model, config, device)
    require(model.latent_dim == width, f"{seg}: latent {model.latent_dim}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = {k: torch.from_numpy(v).to(device)
            for k, v in synthetic_eval_batch(config, EVAL_BATCH, seed=SEED + 60).items()}
    out = {}
    with torch.inference_mode():
        audio = preprocess_audio(data["waveform"], n_frames=config.mel_frames)
        image = data["image"].permute(0, 3, 1, 2)
        fea_v = model.forward_visual_feature(image)
        fea_a = model.forward_audio_feature(audio.permute(0, 3, 1, 2))
        x = map_to_tokens(fea_v).contiguous()
        require(tuple(x.shape) == (EVAL_BATCH, 3136, width), f"{seg}: tokens {list(x.shape)}")
        got = fused_visual_fusion(model, x, fea_a)
        again = fused_visual_fusion(model, x, fea_a)
        ref = fused_visual_fusion_reference(model, x, fea_a)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        ok = (float(err.max()) <= BF16_MAX_ABS and float(err.mean()) <= BF16_MEAN_ABS
              and bool(torch.equal(got, again)) and bool(torch.isfinite(got).all()))
        print(f"[zoo] {seg}: K1 on the head's features {list(x.shape)} bf16: max_abs_err "
              f"{float(err.max()):.3e} mean {float(err.mean()):.3e} (max {BF16_MAX_ABS}, mean "
              f"{BF16_MEAN_ABS}: {'ok' if ok else 'FAIL'}); two launches bit-equal")
        require(ok, f"{seg}: K1 disagrees with its plain version")
        out["err"] = float(err.max())
        side = 56
        ops = fusion_operands(model, fea_a, torch.bfloat16)
        arms = {"kernel": lambda: fused_visual_fusion(model, x, fea_a),
                "launch": lambda: fusion_launch(x, ops, 4),
                "plain": lambda: fused_visual_fusion_reference(model, x, fea_a),
                "module": lambda: model.forward_fusion(tokens_to_map(x, side, side), fea_a)}
        times = {k: [] for k in arms}
        for arm in ("plain", "kernel", "launch", "module", "module", "launch", "kernel", "plain"):
            times[arm].append(cuda_ms(arms[arm], 3))
        for k, v in times.items():
            out[f"{k}_ms"] = statistics.median(v)
        pre, half = chain_flops_per_token(width, 256, 4 * width, 4)
        tokens = EVAL_BATCH * 3136
        flops = tokens * (pre - 2 * width * width + half)  # fc2 folded: one C x C fewer
        out["bound_ms"], out["bound_by"] = bound_ms(flops, 2 * tokens * width * 2)
        fmt = lambda k: " / ".join(f"{t:.2f}" for t in times[k])
        print(f"[zoo] {seg}: K1 at [{EVAL_BATCH},3136,{width}] bf16, median of 3 (plain, "
              f"kernel, launch, module, module, launch, kernel, plain): wrapper {fmt('kernel')} "
              f"ms, launch {fmt('launch')} ms, plain {fmt('plain')} ms, module path "
              f"{fmt('module')} ms; bound {out['bound_ms']:.3f} ms ({out['bound_by']}; "
              f"{flops / out['launch_ms'] / 1e9:.1f} TFLOP/s in the launch); {card_line()}")

        head = model.segment.upsample(tokens_to_map(got, side, side))
        head = head.permute(0, 2, 3, 1).contiguous()
        require(head.shape[-1] == config.num_classes, f"{seg}: head {list(head.shape)}")
        mask = upsample_argmax(head, (224, 224))
        sep = interpolate_bilinear_separable(head, (224, 224)).argmax(-1).to(torch.int32)
        require(bool(torch.equal(mask, sep)), f"{seg}: K4 differs from the separable arm")
        out["argmax_ms"] = cuda_ms(lambda: upsample_argmax(head, (224, 224)), 5)
        print(f"[zoo] {seg}: K4 on the head's logits {list(head.shape)} -> 224x224 bf16: "
              f"bit-equal to the separable arm, {out['argmax_ms']:.3f} ms")
        del got, again, ref, x, fea_v, fea_a, head

    # the eval step with every flag on: its launches and frames/s
    step = make_eval_step(model, config.replace(**ALL_FLAGS))
    metrics = step(eval_metrics_init(config.num_classes, device), data)
    torch.cuda.synchronize()
    reset_launches()
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        metrics = step(metrics, data)
    torch.cuda.synchronize()
    out["fps"] = EVAL_BATCH * iters / (time.perf_counter() - t0)
    launches = read_launches()
    want = dict.fromkeys(launches, 0)
    want.update(mel=iters, fusion=iters, argmax=iters)
    require(launches == want, f"{seg}: {iters} eval steps launched {launches}")
    pixels = (iters + 1) * EVAL_BATCH * 224 * 224
    require(float(metrics.miou_all.labeled) == pixels, f"{seg}: lost pixels")
    out["launches"] = iters
    with torch.inference_mode():
        audio = preprocess_audio(data["waveform"], n_frames=config.mel_frames,
                                 use_pallas=True)
        m_all = make_eval_pred_forward(model, config.replace(**ALL_FLAGS))(data["image"], audio)
        audio = preprocess_audio(data["waveform"], n_frames=config.mel_frames)
        m_plain = make_eval_pred_forward(model, config.replace(use_pallas_fusion=False))(
            data["image"], audio)
    agree = float((m_all == m_plain).float().mean())
    out["agree"] = agree
    print(f"[zoo] {seg}: {iters} eval steps at batch {EVAL_BATCH}, every kernel flag, launched "
          f"{ {k: v for k, v in launches.items() if v} } (K2 and K5 none): "
          f"{out['fps']:.1f} frames/s; masks agree with the plain arm on {100 * agree:.3f}% "
          f"(limit {100 * ZOO_MASK_AGREEMENT}%); {card_line()}")
    require(agree >= ZOO_MASK_AGREEMENT, f"{seg}: all-flags masks agree on only {agree:.4f}")
    out["state_dict"] = ({k: v.detach().cpu() for k, v in model.state_dict().items()}
                         if seg == "HRNet" else None)
    del model, step, metrics, data
    torch.cuda.empty_cache()
    return out


def zoo_phase(device, repo: Path) -> dict:
    """Phase 16: the seg-model zoo. Each head through ``zoo_head_check``;
    then ``python -m cavp_tpu_torch.test_avs_semantic --seg_model HRNet``
    with every eval kernel flag, a process on a synthetic test split of
    ZOO_TEST_VIDEOS videos at 224x224 and the HRNet model's ``.pth``; then
    ``main_avss_resize --seg_model OCR`` in this process, 224x224, batch 16,
    bf16, every kernel flag, one epoch of 2 steps and the validation at
    epoch 0: the module arm of the train step (K2 is for DeepLabV3+ only: no
    launch), K3 on every step, K1 and K4 on every eval step, K5 never, every
    optimizer group moved, peak memory. Returns its numbers."""
    import os
    import shutil

    import torch

    from cavp_tpu_torch import main_avss_resize
    from cavp_tpu_torch.data.synthetic import make_synthetic_avss
    from cavp_tpu_torch.engine import runner
    from cavp_tpu_torch.engine.optim import GROUPS, label_params

    t0 = time.perf_counter()
    out = {seg: zoo_head_check(seg, width, device) for seg, width in ZOO_HEADS}
    print(f"[zoo] the three heads' checks took {time.perf_counter() - t0:.1f} s")
    root = repo / "build" / "chip_smoke_zoo"
    shutil.rmtree(root, ignore_errors=True)
    data = root / "data"
    base = Path(make_synthetic_avss(str(data), num_videos=ZOO_TRAIN_VIDEOS, image_size=224,
                                    num_classes=71, splits=("train",)))
    train_rows = (base / "metadata.csv").read_text().splitlines()[1:]
    make_synthetic_avss(str(data), num_videos=ZOO_TEST_VIDEOS, image_size=224, num_classes=71,
                        splits=("test",))
    rows = (base / "metadata.csv").read_text().splitlines()
    (base / "metadata.csv").write_text("\n".join(rows + train_rows) + "\n")
    pth = root / "hrnet.pth"
    torch.save({"model": out["HRNet"].pop("state_dict")}, pth)
    for seg, _ in ZOO_HEADS:
        out[seg].pop("state_dict", None)

    t0 = time.perf_counter()
    args = ["--setup", "avss", "--seg_model", "HRNet", "--root_dataset_dir", str(data),
            "--ckpt_path", str(pth), *[f"--{f}" for f in ALL_FLAGS]]
    proc = subprocess.run([sys.executable, "-m", "cavp_tpu_torch.test_avs_semantic", *args],
                          cwd=repo, capture_output=True, text=True, timeout=600)
    lines = [ln.split(" | INFO | ")[-1] for ln in proc.stderr.splitlines() if "|ALL|" in ln]
    require(proc.returncode == 0 and len(lines) == 1 and "checkpoint tensors" not in proc.stderr
            and "did not fill" not in proc.stderr,
            f"test_avs_semantic --seg_model HRNet: exit {proc.returncode}\n"
            f"{proc.stderr[-4000:]}")
    print(f"[zoo] python -m cavp_tpu_torch.test_avs_semantic --seg_model HRNet (every eval "
          f"kernel flag, {ZOO_TEST_VIDEOS} test videos, the HRNet model's .pth loaded strictly) "
          f"exit 0 in {time.perf_counter() - t0:.1f} s: {lines[0]}")

    # two train steps of OCR through the training entry point, counted
    real = dict(init_state=runner.init_state, run_validation=runner.run_validation)
    rec = {}

    def init_state(*a, **kw):
        state = real["init_state"](*a, **kw)
        rec["state"] = state
        rec["start"] = {k: v.clone() for k, v in state.model.named_parameters()}
        return state

    def run_validation(*a, **kw):
        stats = {}
        res = real["run_validation"](*a, stats=stats, **kw)
        rec["eval"] = stats
        return res

    runner.init_state, runner.run_validation = init_state, run_validation
    here = os.getcwd()
    os.chdir(root)
    try:
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        t0 = time.perf_counter()
        main_avss_resize.main(["--setup", "avss", "--seg_model", "OCR", "--root_dataset_dir",
                               str(data), "--epochs", "1", "--num_workers", "4",
                               "--ignore_ckpt", *[f"--{f}" for f in TRAIN_FLAGS]],
                              device=device, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = read_launches()
        state = rec.pop("state")
        labels = label_params(state.model)
        moved = {labels[n] for n, p in state.model.named_parameters()
                 if not torch.equal(p, rec["start"][n])}
        require(state.model.seg_model == "OCR" and state.model.latent_dim == 512,
                "the entry point did not build OCR")
        del state, rec["start"]
    finally:
        os.chdir(here)
        runner.init_state, runner.run_validation = real["init_state"], real["run_validation"]
    n_eval = rec["eval"]["steps"]
    want = {"mel": stats["steps"] + n_eval, "layer1": 0, "fusion": n_eval, "argmax": n_eval,
            "fwd": 0, "stage_a": 0, "stage_b": 0, "reduce": 0, "f32": 0}
    require(stats["steps"] == 2 and launches == want,
            f"OCR training: {stats['steps']} train steps and {n_eval} eval steps launched "
            f"{launches}, not {want}")
    require(moved == set(GROUPS), f"OCR training: groups that did not move {set(GROUPS) - moved}")
    out["train"] = dict(launches=launches, peak=peak, wall=wall, steps=stats["steps"],
                        n_eval=n_eval)
    print(f"[zoo] main_avss_resize --seg_model OCR (224x224, batch 16, bf16, every kernel "
          f"flag), in process: {stats['steps']} train steps on the module arm (K2 launched "
          f"{launches['fwd']}, K3 {launches['mel']} = {stats['steps']} train + {n_eval} eval "
          f"steps), the validation's {n_eval} eval steps launched K1 {launches['fusion']} at "
          f"C = 512, K4 {launches['argmax']}, K5 {launches['layer1']}; all {len(GROUPS)} "
          f"optimizer groups moved; peak memory {peak:.2f} GiB; {wall:.1f} s with the model "
          f"build and the validation; {card_line()}")
    shutil.rmtree(root, ignore_errors=True)
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    if not (repo / "cavp_tpu_torch").is_dir():
        print(f"chip_smoke: no cavp_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))
    device = torch.device("cuda")

    from cavp_tpu_torch.ops._build import build_library, find_nvcc

    # 1. environment
    card = card_line()
    nvcc_v = subprocess.run([find_nvcc(), "--version"], capture_output=True, text=True,
                            timeout=60).stdout.strip().splitlines()[-1]
    print(f"[env] {card}")
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, nvcc: {nvcc_v}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    so, log = build_library()
    print(f"[build] {so.relative_to(repo)} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    from cavp_tpu_torch.config import get_config
    from cavp_tpu_torch.engine.runner import build_model
    config = get_config("avss").replace(
        image_width=224, image_height=224, compute_dtype="bfloat16",
        use_pallas_fusion=True)
    model = build_model(config, device)
    random_weights(model, config, device)
    state_dict = {k: v.detach().cpu() for k, v in model.state_dict().items()}

    # 3. kernel against plain
    kres = kernel_phase(model, device)
    # 4. serving, the main path: the launch count is read from this run only
    launches = serving_phase(config, state_dict, device)
    # 5. eval step
    fps = eval_phase(config, model, device)
    if "--profile" in sys.argv[1:]:
        profile_eval_step(config, model, device)
    # 6. train kernels against plain
    small = build_model(config.replace(visual_backbone=18), device)
    random_weights(small, config, device)
    tres = train_kernel_phase(model, small, device)
    del small
    torch.cuda.empty_cache()
    # 7. train steps: the launch counts are read from this run only
    train = train_phase(config, device, profile="--profile" in sys.argv[1:])
    # 8-10. the three eval-side kernels against plain
    mres = mel_kernel_phase(config, device)
    ares = argmax_kernel_phase(config, device)
    lres = layer1_kernel_phase(config, model, device)
    # 11. every flag on: the launch counts are read from its eval steps only
    eval_launches = all_flags_phase(config, model, state_dict, device)
    print(f"[eval] frames/s at batch {EVAL_BATCH}: every kernel flag on {fps['all']:.1f}, "
          f"fusion kernel only {fps['kernel']:.1f}, plain {fps['plain']:.1f}")
    # 12. the evaluation entry point on files: the counts are read from its runs only
    val = validation_phase(config, model, state_dict, device, repo,
                           profile="--profile" in sys.argv[1:])
    print(f"[validation] frames/s of the entry point, decode included: every kernel flag "
          f"{val['kernels']['fps']:.1f}, plain {val['plain']['fps']:.1f}; loader wait "
          f"{100 * val['kernels']['wait']:.1f}% / {100 * val['plain']['wait']:.1f}% of the "
          f"loop; {card_line()}")
    # 13. the training entry point on files: the counts are read from its runs only
    del model
    torch.cuda.empty_cache()
    trained = training_phase(config, device, repo)
    print(f"[training] the training entry point at 512x512, batch 16, bf16, every kernel flag, "
          f"smoke readings of one 3-step window (warm): "
          f"{trained['warm']['steps_per_s']:.3f} steps/s, {trained['warm']['frames_per_s']:.1f} "
          f"frames/s with the loader, loader wait {100 * trained['warm']['wait']:.1f}%, the steps "
          f"on the stream {statistics.median(trained['step_ms']):.1f} ms (median of "
          f"{len(trained['step_ms'])}; the first epoch "
          f"{trained['cold']['steps_per_s']:.3f} steps/s), peak "
          f"{trained['peak']:.2f} GiB, process wall time {trained['cli_s']:.1f} s; "
          f"{card_line()}")
    # 14. the binary setup and the J&F test: the counts are read from its runs only
    binary = binary_phase(device, repo)
    print(f"[binary] avss_binary training entry point at 224x224, batch 16, bf16, every kernel "
          f"flag, one 3-step epoch in this process (smoke readings): "
          f"{binary['train']['steps_per_s']:.3f} steps/s, {binary['train']['frames_per_s']:.1f} "
          f"frames/s with the loader (one thread, wait {100 * binary['train']['wait']:.1f}%), "
          f"peak {binary['train']['peak']:.2f} GiB, warm steps on the stream "
          f"{' / '.join(f'{v:.1f}' for v in binary['train']['step_ms'][1:])} ms; the J&F test "
          f"{binary['v1s']['videos_per_s']:.1f} (S4) / {binary['v1m']['videos_per_s']:.1f} "
          f"(MS3) videos/s with the loader; {card_line()}")

    # 15. the VPO training entry points: the counts are read from their runs only
    vpo = vpo_phase(device, repo)
    for variant in ("vpo_mono", "vpo_stereo"):
        r = vpo[variant]
        print(f"[vpo] {variant} training entry point at 512x512, batch 16, bf16, ResNet-101 OS8, "
              f"every kernel flag, one 3-step epoch in this process (smoke readings): warm "
              f"steps on the stream {' / '.join(f'{v:.1f}' for v in r['step_ms'][1:])} ms, "
              f"{r['steps_per_s']:.3f} steps/s, {r['frames_per_s']:.1f} frames/s with the "
              f"loader (one thread, wait {100 * r['wait']:.1f}%), peak {r['peak']:.2f} GiB, "
              f"validation {r['val_fps']:.1f} frames/s; {card_line()}")
    vpo_launches = {k: {v: vpo[v]["launches"][k] for v in ("vpo_mono", "vpo_stereo")}
                    for k in vpo["vpo_mono"]["launches"]}

    # 16. the seg-model zoo: the counts are read from its runs only
    zoo = zoo_phase(device, repo)
    heads = [seg for seg, _ in ZOO_HEADS]
    zoo_k1 = lambda key: {seg: zoo[seg][key] for seg in heads}
    print(f"[zoo] K1 at [{EVAL_BATCH},3136,C] bf16, launch ms: "
          + ", ".join(f"{seg} (C = {w}) {zoo[seg]['launch_ms']:.2f} (plain "
                      f"{zoo[seg]['plain_ms']:.2f}, module {zoo[seg]['module_ms']:.2f}, bound "
                      f"{zoo[seg]['bound_ms']:.3f})" for seg, w in ZOO_HEADS)
          + "; eval frames/s at batch 120, every flag: "
          + ", ".join(f"{seg} {zoo[seg]['fps']:.1f}" for seg in heads) + f"; {card_line()}")

    train_source = "cavp_tpu_torch/csrc/fusion_train_kernel.cu"
    print(json.dumps({"kernels": [
        {"name": "fused_visual_fusion", "route": "cuda",
         "source": "cavp_tpu_torch/csrc/fusion_kernel.cu",
         "replaces": "cavp_tpu/ops/pallas/fusion_kernel.py:119",
         "launches": launches, "max_abs_err": kres["bf16"],
         "ms": kres["ms"], "plain_ms": kres["plain_ms"],
         "bound_ms": kres["bound_ms"], "bound_by": kres["bound_by"],
         "library_ms": None, "launches_vpo": vpo_launches["fusion"],
         "max_abs_err_vpo": vpo["kernels"]["fusion"],
         "launches_zoo": zoo_k1("launches"),
         "launches_zoo_ocr_training": zoo["train"]["launches"]["fusion"],
         "max_abs_err_zoo": zoo_k1("err"), "ms_zoo": zoo_k1("kernel_ms"),
         "launch_ms_zoo": zoo_k1("launch_ms"), "plain_ms_zoo": zoo_k1("plain_ms"),
         "module_ms_zoo": zoo_k1("module_ms"), "bound_ms_zoo": zoo_k1("bound_ms"),
         "bound_by_zoo": zoo_k1("bound_by")},
        {"name": "fusion_train_fwd", "route": "cuda", "source": train_source,
         "replaces": "cavp_tpu/ops/pallas/fusion_train_kernel.py:280",
         "launches": train["launches"]["fwd"], "max_abs_err": tres["fwd_err"],
         "ms": tres["fwd_ms"], "plain_ms": tres["plain_fwd_ms"],
         "bound_ms": tres["fwd_bound"][0], "bound_by": tres["fwd_bound"][1],
         "library_ms": None, "launches_vpo": vpo_launches["fwd"],
         "max_abs_err_vpo": vpo["kernels"]["fwd"],
         "launches_zoo_ocr_training": zoo["train"]["launches"]["fwd"]},
        {"name": "fusion_train_bwd", "route": "cuda", "source": train_source,
         "replaces": "cavp_tpu/ops/pallas/fusion_train_kernel.py:312",
         "launches": train["launches"]["stage_a"], "max_abs_err": tres["bwd_err"],
         "ms": tres["bwd_ms"], "plain_ms": tres["plain_bwd_ms"],
         "bound_ms": tres["bwd_bound"][0], "bound_by": tres["bwd_bound"][1],
         "library_ms": None, "launches_vpo": vpo_launches["stage_a"],
         "max_rel_err_vpo": vpo["kernels"]["bwd"],
         "stages": ["fusion_train_bwd_stage_a", "fusion_train_bwd_stage_b",
                    "fusion_train_bwd_reduce"]},
        *({"name": f"fusion_train_bwd_{k}", "route": "cuda", "source": train_source,
           "replaces": "cavp_tpu/ops/pallas/fusion_train_kernel.py:341",
           "launches": train["launches"][k], "max_abs_err": err,
           "ms": tres[f"{k}_ms"], "plain_ms": tres[f"plain_{k}_ms"],
           "bound_ms": tres[f"{k}_bound"][0], "bound_by": tres[f"{k}_bound"][1],
           "library_ms": None, "launches_vpo": vpo_launches[k]}
          for k, err in (("stage_a", tres["stage_a_err"]), ("stage_b", tres["stage_b_err"]),
                         ("reduce", tres["stage_b_err"]))),
        {"name": "fused_log_mel", "route": "cuda",
         "source": "cavp_tpu_torch/csrc/mel_kernel.cu",
         "replaces": "cavp_tpu/ops/pallas/mel_kernel.py:66",
         "launches": eval_launches["mel"], "max_abs_err": mres["eval"],
         "ms": mres["kernel"], "plain_ms": mres["plain"],
         "bound_ms": mres["bound"][0], "bound_by": mres["bound"][1],
         "library_ms": mres["library"], "fft_composition_ms": mres["fft"],
         "ms_in_a_row": mres["kernel_b2b"], "launches_vpo": vpo_launches["mel"],
         "max_abs_err_f64_vpo_32x48000": mres["vpo_f64"], "ms_vpo_32x48000": mres["vpo_kernel"],
         "ms_in_a_row_vpo_32x48000": mres["vpo_b2b"],
         "plain_ms_vpo_32x48000": mres["vpo_plain"],
         "bound_ms_vpo_32x48000": mres["vpo_bound"][0],
         "library_ms_vpo_32x48000": mres["vpo_library"],
         "launches_zoo": zoo_k1("launches"),
         "launches_zoo_ocr_training": zoo["train"]["launches"]["mel"]},
        {"name": "upsample_argmax", "route": "cuda",
         "source": "cavp_tpu_torch/csrc/upsample_argmax_kernel.cu",
         "replaces": "cavp_tpu/ops/pallas/upsample_argmax_kernel.py:70",
         "launches": eval_launches["argmax"], "max_abs_err": ares["bf16"],
         "ms": ares["kernel"], "plain_ms": ares["plain"],
         "bound_ms": ares["bound"][0], "bound_by": ares["bound"][1],
         "library_ms": ares["library"],
         "launches_binary_setup": binary["train"]["launches"]["argmax"],
         "ms_2_classes": ares["kernel_2"], "plain_ms_2_classes": ares["plain_2"],
         "bound_ms_2_classes": ares["bound_2"][0],
         "library_ms_2_classes": ares["library_2"], "launches_vpo": vpo_launches["argmax"],
         "ms_22_classes": ares["kernel_22"], "plain_ms_22_classes": ares["plain_22"],
         "bound_ms_22_classes": ares["bound_22"][0],
         "library_ms_22_classes": ares["library_22"],
         "launches_zoo": zoo_k1("launches"), "ms_zoo": zoo_k1("argmax_ms"),
         "launches_zoo_ocr_training": zoo["train"]["launches"]["argmax"]},
        {"name": "fused_layer1", "route": "cuda",
         "source": "cavp_tpu_torch/csrc/layer1_kernel.cu",
         "replaces": "cavp_tpu/ops/pallas/layer1_kernel.py:153",
         "launches": eval_launches["layer1"], "max_abs_err": lres["bf16"],
         "ms": lres["kernel"], "plain_ms": lres["plain"],
         "bound_ms": lres["bound"][0], "bound_by": lres["bound"][1],
         "library_ms": None, "launches_vpo": vpo_launches["layer1"],
         "max_abs_err_vpo": vpo["kernels"]["layer1"],
         "launches_zoo": 0}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
