#!/usr/bin/env python3
"""Where the wgmma kernels' time goes, from clock64() stage counters.

    python3 scripts/torch_chain_stamps.py

on a machine with an NVIDIA Hopper GPU and ``nvcc``, from the repository
root. It builds the two fusion kernel sources, the layer1 source and the
mel source with ``-DCHAIN_STAMPS`` (the counters of
``cavp_tpu_torch/csrc/sm90.cuh``) into a library of its own under
``build/``, binds the port's wrappers to it, and runs the eval kernel at
[120, 3136, 304], the train forward at [32, 3136, 304] and the fused layer1
(its three launches together) at [120, 56, 56, 128] (bf16, the seeded model
of ``chip_smoke.py``), and the log-mel kernel at [120, 16000] -> 96 frames
(float32). For each it prints the share of each consumer warpgroup
leader's cycles spent loading x, waiting for weight slabs, in wgmma (issue
to completion), at the consumers' barriers, and in the rest (the epilogues;
layer1's "loading x" is the wait for the tile's input; the mel kernel's
stages are staging the waveform span, waiting for slabs, products, barriers
and the epilogue: power, sparse mel, dB and stores), and the producer
warp's share waiting for free ring slots; then the counted build's time
beside the normal library's, in turns.
"""

import ctypes
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

STAGES = ("total", "load_x", "wait_full", "mma", "barrier", "producer", "wait_empty")


def build_stamped() -> ctypes.CDLL:
    from cavp_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "stamps"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    objs, procs = [], []
    for name in ("fusion_kernel", "fusion_train_kernel", "layer1_kernel", "mel_kernel"):
        obj = out / f"{name}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-DCHAIN_STAMPS", "-c", "-o", str(obj),
             str(_build.CSRC / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed:\n{log}")
    so = out / f"libchain_stamps_{os.getpid()}.so"
    subprocess.run([nvcc, "-shared", "-o", str(so), *map(str, objs), *_build.LINK_FLAGS],
                   check=True)
    return ctypes.CDLL(str(so))


def main() -> int:
    import torch

    import chip_smoke as cs
    from cavp_tpu_torch.config import get_config
    from cavp_tpu_torch.engine.runner import build_model
    from cavp_tpu_torch.ops.kernels import fusion as fu
    from cavp_tpu_torch.ops.kernels import fusion_train as ft
    from cavp_tpu_torch.ops.kernels import layer1 as l1
    from cavp_tpu_torch.ops.kernels import mel as mk

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line())
    t0 = time.perf_counter()
    plain_lib = fu._library()
    lib = build_stamped()
    print(f"stamped build {time.perf_counter() - t0:.1f} s")
    for fn, proto in (("cavp_fused_visual_fusion", plain_lib.cavp_fused_visual_fusion),
                      ("cavp_fusion_train_fwd", ft._library().cavp_fusion_train_fwd),
                      ("cavp_layer1_bottleneck", l1._library().cavp_layer1_bottleneck),
                      ("cavp_fused_log_mel", mk._library().cavp_fused_log_mel)):
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = proto.argtypes, proto.restype
    lib.cavp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cavp_cuda_error_string.restype = ctypes.c_char_p
    counts = ctypes.c_ulonglong * 21

    dev = torch.device("cuda")
    config = get_config("avss").replace(image_width=224, image_height=224,
                                        compute_dtype="bfloat16", use_pallas_fusion=True)
    model = build_model(config, dev)
    cs.random_weights(model, config, dev)
    g = torch.Generator().manual_seed(cs.SEED + 30)
    C = 304

    x = torch.randn(120, 3136, C, generator=g).to(dev, torch.bfloat16)
    a = torch.randn(120, C, generator=g).to(dev, torch.bfloat16)
    ops = fu.fusion_operands(model, a, torch.bfloat16)
    xt = torch.randn(32, 3136, C, generator=g).to(dev, torch.bfloat16)
    fa = torch.randn(64, C, generator=g).to(dev, torch.bfloat16)
    with torch.no_grad():
        wqk2, m2, ws = ft.train_operands(model, fa, 32, torch.bfloat16)
    resnet = model.backbone.backbone
    with torch.inference_mode():
        image = torch.randn(120, 3, 224, 224, generator=g).to(dev, torch.bfloat16)
        stem = resnet.stem_forward(image).permute(0, 2, 3, 1).contiguous()
    blocks = l1.layer1_operands(resnet, torch.bfloat16)
    wave = ((torch.rand(120, 16000, generator=g) - 0.5) * 0.2).to(dev)

    cases = {"eval [120,3136,304]": (lambda: fu._launch(x, ops, 4), lib.cavp_chain_stamps),
             "train forward [32,3136,304]": (lambda: ft.token_chain_train(xt, wqk2, m2, ws),
                                             lib.cavp_chain_stamps_train),
             "layer1 [120,56,56,128]": (lambda: l1._launch(stem, blocks), lib.cavp_layer1_stamps),
             "mel [120,16000] -> 96": (lambda: mk.fused_log_mel(wave, 96), lib.cavp_mel_stamps)}
    mel_names = {"load_x": "staging", "wait_full": "wait_full", "mma": "products",
                 "barrier": "barrier"}
    for name, (run, read) in cases.items():
        for which in (plain_lib, lib, lib, plain_lib):
            fu._library = ft._library = l1._library = mk._library = (lambda L=which: L)
            ms = cs.cuda_ms(run, 5)
            print(f"{name}: {'counted' if which is lib else 'normal'} build {ms:.3f} ms")
        fu._library = ft._library = l1._library = mk._library = (lambda: lib)
        out = counts()
        read(out)  # zero
        run()
        torch.cuda.synchronize()
        read(out)
        wgs = [[out[w * 7 + k] for k in range(7)] for w in range(3)]
        for w in range(2):
            c = dict(zip(STAGES, wgs[w]))
            total = c["total"]
            rest = total - c["load_x"] - c["wait_full"] - c["mma"] - c["barrier"]
            label = mel_names if name.startswith("mel") else dict.fromkeys(c)
            print(f"{name}: consumer warpgroup {w}, share of {total} cycles: "
                  + ", ".join(f"{label[k] or k} {100 * c[k] / total:.1f}%" for k in
                              ("load_x", "wait_full", "mma", "barrier"))
                  + f", epilogues {100 * rest / total:.1f}%")
        p = dict(zip(STAGES, wgs[2]))
        print(f"{name}: producer: waiting for a free slot {100 * p['wait_empty'] / p['producer']:.1f}% "
              f"of {p['producer']} cycles")
    return 0


if __name__ == "__main__":
    sys.exit(main())
