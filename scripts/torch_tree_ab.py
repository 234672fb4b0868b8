#!/usr/bin/env python3
"""The port's CUDA kernels of two source trees side by side on one card.

    python3 scripts/torch_tree_ab.py OTHER_TREE

from the repository root, on a machine with an NVIDIA Hopper GPU and
``nvcc``. OTHER_TREE is another checkout of this repository (for example
the parent commit unpacked with ``git archive`` into a git-ignored
directory). Each tree's ``cavp_tpu_torch`` builds its own kernel library
(under that tree's ``build/``) and runs in processes of its own, in turns:
other, this, this, other. Every process builds the seeded avss model of
``chip_smoke.py`` (224x224, bf16) and runs, on inputs drawn from one seed:

- the eval fusion kernel (K1) at [120, 3136, 304] and the train fusion
  forward (K2) at [32, 3136, 304],
- the log-mel kernel (K3) at [120, 16000] -> 96 frames, float32,
- the upsample + argmax kernel (K4) at [120, 56, 56, 71] -> 224 x 224,
- the fused layer1 (K5) at the stem output [120, 56, 56, 128],

the others in bf16. It prints each kernel's median time (CUDA events) in
each process, one call at a time and in a row of launches, and whether its output is bit-for-bit the same in the two
trees (sha256 of the output bytes); it exits 1 if a kernel whose design did
not change in one of them (named with ``--same``, default K1, K2, K4 and
K5) gives other bits, or if a process fails.
"""

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
KERNELS = ("K1", "K2", "K3", "K4", "K5")


def worker(tree: Path) -> dict:
    """Run the five kernels from ``tree``'s package; returns times and hashes."""
    sys.path.insert(0, str(tree))
    import torch

    sys.path.insert(1, str(REPO))
    import chip_smoke as cs
    from cavp_tpu_torch.config import get_config
    from cavp_tpu_torch.engine.runner import build_model
    from cavp_tpu_torch.ops._build import build_library
    from cavp_tpu_torch.ops.kernels import fusion as fu
    from cavp_tpu_torch.ops.kernels import fusion_train as ft
    from cavp_tpu_torch.ops.kernels.layer1 import fused_layer1
    from cavp_tpu_torch.ops.kernels.mel import fused_log_mel
    from cavp_tpu_torch.ops.kernels.upsample_argmax import upsample_argmax

    import cavp_tpu_torch
    assert Path(cavp_tpu_torch.__file__).resolve().is_relative_to(tree.resolve())
    # this tree's timer for both trees (the other tree's chip_smoke may lack it)
    spec = importlib.util.spec_from_file_location("this_chip_smoke", REPO / "chip_smoke.py")
    timer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timer)
    build_library()
    dev = torch.device("cuda")
    config = get_config("avss").replace(image_width=224, image_height=224,
                                        compute_dtype="bfloat16", use_pallas_fusion=True)
    model = build_model(config, dev)
    cs.random_weights(model, config, dev)
    g = torch.Generator().manual_seed(cs.SEED + 40)
    C = 304
    x = torch.randn(120, 3136, C, generator=g).to(dev, torch.bfloat16)
    fea_a = torch.randn(120, C, generator=g).to(dev, torch.bfloat16)
    xt = torch.randn(32, 3136, C, generator=g).to(dev, torch.bfloat16)
    fa = torch.randn(64, C, generator=g).to(dev, torch.bfloat16)
    logits = torch.randn(120, 56, 56, 71, generator=g).to(dev, torch.bfloat16)
    image = torch.randn(120, 3, 224, 224, generator=g).to(dev, torch.bfloat16)
    wave = ((torch.rand(120, 16000, generator=g) - 0.5) * 0.2).to(dev)
    resnet = model.backbone.backbone
    with torch.inference_mode():
        stem = resnet.stem_forward(image).permute(0, 2, 3, 1).contiguous()
        wqk2, m2, ws = ft.train_operands(model, fa, 32, torch.bfloat16)
    runs = {
        "K1": lambda: fu.fused_visual_fusion(model, x, fea_a, num_heads=4),
        "K2": lambda: ft.token_chain_train(xt, wqk2, m2, ws),
        "K3": lambda: fused_log_mel(wave, 96),
        "K4": lambda: upsample_argmax(logits, (224, 224)),
        "K5": lambda: fused_layer1(resnet, stem),
    }
    out = {"card": cs.card_line()}
    for name, run in runs.items():
        with torch.inference_mode():
            y = run()
            torch.cuda.synchronize()
            y = y[0] if isinstance(y, tuple) else y
            out[name] = {
                "sha256": hashlib.sha256(y.contiguous().view(torch.uint8).cpu().numpy()).hexdigest(),
                "ms": cs.cuda_ms(run, 10), "ms_in_a_row": timer.back_to_back_ms(run)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, nargs="?")
    ap.add_argument("--same", default="K1,K2,K4,K5",
                    help="kernels that must give the same bits in both trees")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return 0
    if args.other is None:
        ap.error("name the other tree")
    trees = {"other": args.other.resolve(), "this": REPO}
    results = {"other": [], "this": []}
    for which in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, __file__, "--worker", str(trees[which])],
                              capture_output=True, text=True, cwd=trees[which])
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
            return 1
        results[which].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(results["this"][0]["card"])
    failed = False
    for k in KERNELS:
        hashes = {w: {r[k]["sha256"] for r in results[w]} for w in results}
        same = len(hashes["other"] | hashes["this"]) == 1
        times = {w: [round(r[k]["ms"], 4) for r in results[w]] for w in results}
        rows = {w: [round(r[k]["ms_in_a_row"], 4) for r in results[w]] for w in results}
        print(f"{k}: other tree {times['other']} ms, this tree {times['this']} ms (in a row of "
              f"launches {rows['other']} and {rows['this']}); outputs "
              f"{'bit-equal' if same else 'differ'} across the trees"
              f"{'' if all(len(h) == 1 for h in hashes.values()) else ' (and within one)'}")
        failed |= k in args.same.split(",") and not same
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
