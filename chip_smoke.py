#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cavp_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

from the repository root, on a machine with a CUDA GPU and ``nvcc``. It:

1. prints the card (``nvidia-smi`` name and power limit) and the torch,
   CUDA and nvcc versions;
2. builds the CUDA kernels from ``cavp_tpu_torch/csrc`` and prints the
   build time and ptxas's register report;
3. holds the fusion kernel against its plain PyTorch version on the card
   (float32 with TF32 off; bf16 at the eval shape [120, 3136, 304] and the
   serving bucket's [8, 3136, 304]; token counts that are not a multiple
   of the kernel's tile) and times both at [120, 3136, 304] bf16, beside
   the module path (``CAVP.forward_fusion``) the plain eval step runs;
4. serves requests of 1, 5, 8 and 11 images through ``Predictor`` (avss,
   224x224, bf16, fusion kernel on, batch bucket 8), checks the masks,
   that the kernel ran, and that they agree with the same Predictor on
   the plain fusion path;
5. runs ``make_eval_step`` at batch 120 with the kernel and with the
   plain fusion path and prints frames/s for both;
6. holds the train fusion kernels (forward and backward) against their
   plain PyTorch versions: float32 with TF32 off and bf16 at
   [32, 3136, 304], float32 at a ragged token count (3199) and at C = 112;
   every one of dx, dwqk, dm and the 17 weight gradients is compared, two
   backward launches must give bit-equal gradients, and the kernels are
   timed beside the plain forward and autograd through the module path;
7. takes train steps through ``make_train_step`` (avss, batch 32, 224x224,
   bf16, ``use_pallas_fusion_train``): one at epoch 0 and three at epoch 1,
   checks the loss, the CoroCL term, that every optimizer group and the
   sound bank moved and that each step launched each train kernel once,
   then takes the same steps from the same state on the module path and
   prints step time, frames/s and peak memory of both.

The weights are random, drawn from a seed, and made non-degenerate (see
``random_weights``) so the comparisons are not empty. The numbers printed
are measurements of the port on this card, not a benchmark. With
``--profile`` it also prints a ``torch.profiler`` table of one train step.
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
# H100 SXM data sheet: dense bf16 tensor rate, float32 rate, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
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


def bound_ms(flops: float, nbytes: float) -> tuple:
    """The least time the card could take: (ms, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
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
        fused_visual_fusion, fused_visual_fusion_reference)

    g = torch.Generator().manual_seed(SEED + 1)
    C = BENCH_SHAPE[2]

    def inputs(b, n, dtype):
        x = torch.randn(b, n, C, generator=g).to(device, dtype)
        a = torch.randn(b, C, generator=g).to(device, dtype)
        return x, a

    def compare(b, n, dtype):
        x, a = inputs(b, n, dtype)
        got = fused_visual_fusion(model, x, a)
        ref = fused_visual_fusion_reference(model, x, a)
        torch.cuda.synchronize()
        require(got.shape == ref.shape and got.dtype == ref.dtype == dtype,
                f"kernel output {got.shape} {got.dtype} vs {ref.shape} {ref.dtype}")
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
    for name, (b, n) in (("bf16_ragged", (3, 7 * 9)), ("bf16_bucket8", (8, BENCH_SHAPE[1])),
                         ("bf16", BENCH_SHAPE[:2])):
        _, _, mx, mean = compare(b, n, torch.bfloat16)
        ok = mx <= BF16_MAX_ABS and mean <= BF16_MEAN_ABS
        print(f"[kernel] {name} [{b},{n},{C}]: max_abs_err {mx:.3e} "
              f"mean_abs_err {mean:.3e} (max {BF16_MAX_ABS}, mean "
              f"{BF16_MEAN_ABS}: {'ok' if ok else 'FAIL'})")
        require(ok, f"bf16 kernel disagrees with the plain version ({name})")
        results[name] = mx

    x, a = inputs(*BENCH_SHAPE[:2], torch.bfloat16)
    side = int(BENCH_SHAPE[1] ** 0.5)

    @torch.inference_mode()
    def module_path():  # what the eval step runs with use_pallas_fusion off
        return model.forward_fusion(tokens_to_map(x, side, side), a)

    arms = {"kernel": lambda: fused_visual_fusion(model, x, a),
            "plain": lambda: fused_visual_fusion_reference(model, x, a),
            "module": module_path}
    iters, times = 10, {k: [] for k in arms}
    for arm in ("plain", "kernel", "module", "module", "kernel", "plain"):
        times[arm].append(cuda_ms(arms[arm], iters))
    results["ms"] = statistics.median(times["kernel"])
    results["plain_ms"] = statistics.median(times["plain"])
    results["module_ms"] = statistics.median(times["module"])
    tokens = BENCH_SHAPE[0] * BENCH_SHAPE[1]
    # the eval chain folds fc2 with patch_embed_v: one C x C product fewer
    flops = tokens * 2 * (C * 256 + 256 * C + 2 * C * 4 + 2 * C * 4 * C)
    results["bound_ms"], results["bound_by"] = bound_ms(flops, 2 * tokens * C * 2)
    fmt = lambda k: " / ".join(f"{t:.3f}" for t in times[k])
    print(f"[kernel] time at {list(BENCH_SHAPE)} bf16, median of {iters} "
          f"(plain, kernel, module, module, kernel, plain): kernel {fmt('kernel')} ms, "
          f"plain {fmt('plain')} ms, module path {fmt('module')} ms "
          f"({tokens / results['ms'] / 1e3:.1f} M tokens/s with the kernel)")
    return results


def serving_phase(config, state_dict, device) -> int:
    """Phase 4: Predictor requests through the kernel, against the plain
    fusion path. Returns the kernel's launches while serving."""
    import numpy as np
    import torch

    from cavp_tpu_torch.engine.predictor import Predictor
    from cavp_tpu_torch.ops.kernels.fusion import fused_visual_fusion

    rng = np.random.RandomState(SEED + 2)
    (h, w, _), (cin, length) = (config.image_height, config.image_width, 3), \
        (config.in_plane, config.audio_samples)
    requests = [(rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8),
                 ((rng.rand(n, cin, length) - 0.5) * 0.2).astype(np.float32))
                for n in REQUEST_SIZES]

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


def eval_phase(config, model, device, batch: int = 120, iters: int = 5) -> None:
    """Phase 5: eval-step frames/s with the kernel and the plain path."""
    import torch

    from cavp_tpu_torch.data.synthetic import synthetic_eval_batch
    from cavp_tpu_torch.engine.loops import (
        eval_metrics_init, eval_metrics_result, make_eval_step)

    data = {k: torch.from_numpy(v).to(device)
            for k, v in synthetic_eval_batch(config, batch, seed=SEED).items()}
    steps = {"kernel": make_eval_step(model, config),
             "plain": make_eval_step(model, config.replace(use_pallas_fusion=False))}
    fps = {k: [] for k in steps}
    for arm in ("kernel", "plain", "plain", "kernel"):
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
    print(f"[eval] make_eval_step at batch {batch}, {iters} steps per window "
          f"(kernel, plain, plain, kernel): kernel "
          f"{' / '.join(f'{v:.1f}' for v in fps['kernel'])} frames/s, plain "
          f"{' / '.join(f'{v:.1f}' for v in fps['plain'])} frames/s "
          "(measurements of the port on this card)")


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
    compare("bf16_c112", small_model, 3, 7 * 9 + 16, torch.bfloat16)
    results["fwd_err"], results["bwd_err"], _ = compare("bf16", model, B, N, torch.bfloat16)

    # times at the train step's shape, bf16
    x, fea_a, dy, wqk2, m2, ws = operands(model, B, N, torch.bfloat16)
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
        "plain_fwd": lambda: ft.token_chain_train_reference(x, wqk2, m2, ws),
        "plain_bwd": lambda: ft.token_chain_train_backward_reference(x, wqk2, m2, ws, dy),
        "module_fwd": module_fwd, "module_fwd_bwd": module_fwd_bwd,
        "wrapper_fwd_bwd": wrapper_fwd_bwd,
    }
    launches = (ft.token_chain_train.launches, ft.token_chain_train_backward.launches)
    iters, times = 5, {k: [] for k in arms}
    order = list(arms) + list(reversed(arms))
    for arm in order:
        times[arm].append(cuda_ms(arms[arm], iters))
    ft.token_chain_train.launches, ft.token_chain_train_backward.launches = launches
    for k in arms:
        results[f"{k}_ms"] = statistics.median(times[k])
    print(f"[train-kernel] time at {list(TRAIN_SHAPE)} bf16, median of {iters}, each arm "
          f"twice (forward order, then reversed): "
          + "; ".join(f"{k} {' / '.join(f'{t:.3f}' for t in times[k])} ms" for k in arms))

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
    print(f"[train-kernel] bounds at 989 TFLOP/s bf16 and 3.35 TB/s: forward "
          f"{results['fwd_bound'][0]:.3f} ms, backward {results['bwd_bound'][0]:.3f} ms "
          f"(both by {results['fwd_bound'][1]})")
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
    ft.token_chain_train.launches = ft.token_chain_train_backward.launches = 0
    k_losses, k_ms, k_peak = run(cfg, "kernel arm")
    launches = (ft.token_chain_train.launches, ft.token_chain_train_backward.launches)
    require(launches == (len(epochs), len(epochs)),
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
    del state, start, before
    torch.cuda.empty_cache()
    return {"launches": launches, "kernel_ms": k_ms, "module_ms": m_ms,
            "kernel_gib": k_peak, "module_gib": m_peak}


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
    eval_phase(config, model, device)
    # 6. train kernels against plain
    small = build_model(config.replace(visual_backbone=18), device)
    random_weights(small, config, device)
    tres = train_kernel_phase(model, small, device)
    del small, model
    torch.cuda.empty_cache()
    # 7. train steps: the launch counts are read from this run only
    train = train_phase(config, device, profile="--profile" in sys.argv[1:])

    train_source = "cavp_tpu_torch/csrc/fusion_train_kernel.cu"
    print(json.dumps({"kernels": [
        {"name": "fused_visual_fusion", "route": "cuda",
         "source": "cavp_tpu_torch/csrc/fusion_kernel.cu",
         "replaces": "cavp_tpu/ops/pallas/fusion_kernel.py:119",
         "launches": launches, "max_abs_err": kres["bf16"],
         "ms": kres["ms"], "plain_ms": kres["plain_ms"],
         "bound_ms": kres["bound_ms"], "bound_by": kres["bound_by"],
         "library_ms": None},
        {"name": "fusion_train_fwd", "route": "cuda", "source": train_source,
         "replaces": "cavp_tpu/ops/pallas/fusion_train_kernel.py:280",
         "launches": train["launches"][0], "max_abs_err": tres["fwd_err"],
         "ms": tres["fwd_ms"], "plain_ms": tres["plain_fwd_ms"],
         "bound_ms": tres["fwd_bound"][0], "bound_by": tres["fwd_bound"][1],
         "library_ms": None},
        {"name": "fusion_train_bwd", "route": "cuda", "source": train_source,
         "replaces": "cavp_tpu/ops/pallas/fusion_train_kernel.py:312",
         "launches": train["launches"][1], "max_abs_err": tres["bwd_err"],
         "ms": tres["bwd_ms"], "plain_ms": tres["plain_bwd_ms"],
         "bound_ms": tres["bwd_bound"][0], "bound_by": tres["bwd_bound"][1],
         "library_ms": None}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
