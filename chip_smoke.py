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
   plain fusion path and prints frames/s for both.

The weights are random, drawn from a seed, and made non-degenerate (see
``random_weights``) so the comparisons are not empty. The numbers printed
are measurements of the port on this card, not a benchmark. Every phase fails loudly; the last
line is ``{"ok": true, "device": {...}}`` only when all of them passed.
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
    tokens = BENCH_SHAPE[0] * BENCH_SHAPE[1]
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

    print(json.dumps({"kernels": [{
        "name": "fused_visual_fusion", "route": "cuda",
        "source": "cavp_tpu_torch/csrc/fusion_kernel.cu",
        "replaces": "cavp_tpu/ops/pallas/fusion_kernel.py:119",
        "launches": launches, "max_abs_err": kres["bf16"],
        "ms": kres["ms"], "plain_ms": kres["plain_ms"]}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
