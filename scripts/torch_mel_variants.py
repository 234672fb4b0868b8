#!/usr/bin/env python3
"""What holds the log-mel kernel (K3): its accuracy on more inputs than
``chip_smoke.py`` phase 8, and its time beside builds with its products
taken out, with its stage counters.

    python3 scripts/torch_mel_variants.py

from the repository root, on a machine with an NVIDIA Hopper GPU and
``nvcc``. It prints, for eight inputs (noise at the eval shape, 8 and 3
rows, the 60-7000 and 0-8000 Hz bands, 7 and 1 frames a row, a tone over a
noise floor), the kernel's and the plain version's largest distance from
the function in float64, the kernel's from plain, and whether two launches
are bit-equal. Then it builds ``csrc/mel_kernel.cu`` four ways into
``build/``: as it is, with ``-DCHAIN_STAMPS`` (the counters of
``csrc/sm90.cuh``), with only the hi.hi products, and with no products
(the last two compute nothing useful: they time the staging, the stream of
bases and the epilogue), and times each at [120, 16000] -> 96 frames, one
call at a time and in a row of launches, then prints the counted build's
shares of the consumer warpgroups' cycles (staging, waiting for slabs,
products, barriers, epilogue) and the producer's wait for free slots.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

PRODUCTS = ("mma_rs_tf32<WN>(part, ah[ks], desc_k(B + S::kSlot / 2 + 32 * ks), ks > 0);",
            "mma_rs_tf32<WN>(part, al[ks], desc_k(B + 32 * ks), 1);",
            "mma_rs_tf32<WN>(part, ah[ks], desc_k(B + 32 * ks), 1);")
STAGES = ("total", "staging", "wait_full", "products", "barrier", "producer", "wait_empty")


def build_variants() -> dict:
    from cavp_tpu_torch.ops import _build

    src = (_build.CSRC / "mel_kernel.cu").read_text()
    for line in PRODUCTS:
        assert line in src, f"the kernel source no longer has: {line}"
    hi_only = src.replace(PRODUCTS[0], "").replace(PRODUCTS[1], "")
    variants = {"kernel": (src, []), "counted": (src, ["-DCHAIN_STAMPS"]),
                "hi.hi only": (hi_only, []), "no products": (hi_only.replace(PRODUCTS[2], ""), [])}
    out = _build.BUILD_DIR / "mel_variants"
    out.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build.find_nvcc(), {}
    for i, (name, (text, flags)) in enumerate(variants.items()):
        cu = out / f"mel_{i}.cu"
        cu.write_text(text.replace('#include "sm90.cuh"', f'#include "{_build.CSRC}/sm90.cuh"'))
        procs[name] = (out / f"mel_{i}.so", subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *flags, "-shared", "-o", str(out / f"mel_{i}.so"),
             str(cu), *_build.LINK_FLAGS], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        print(f"[build] {name}: " + "; ".join(
            line.strip() for line in log.splitlines() if "spill" in line))
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from cavp_tpu_torch.ops.kernels import mel as mk

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line())
    dev = torch.device("cuda")
    rng = np.random.RandomState(cs.SEED + 50)

    def noise(rows, length=16000, amp=0.2):
        return torch.from_numpy(((rng.rand(rows, length) - 0.5) * amp).astype(np.float32)).to(dev)

    t = np.arange(16000) / 16000.0
    tone = torch.from_numpy((0.5 * np.sin(2 * np.pi * 1000.0 * t)[None]
                             + 1e-4 * rng.randn(120, 16000)).astype(np.float32)).to(dev)
    cases = (("eval", noise(120), 96, {}), ("bucket8", noise(8), 96, {}),
             ("ragged", noise(3), 101, {}), ("60-7000 Hz", noise(120), 96,
                                             dict(f_min=60.0, f_max=7000.0)),
             ("0-8000 Hz, -80..20 dB", noise(5, 48000, 1.5), 300,
              dict(spec_min=-80.0, spec_max=20.0, f_min=0.0, f_max=8000.0)),
             ("7 frames a row", noise(5), 7, {}), ("1 frame a row", noise(70), 1, {}),
             ("tone", tone, 96, {}))
    for name, w, frames, kw in cases:
        got, again = mk.fused_log_mel(w, frames, **kw), mk.fused_log_mel(w, frames, **kw)
        ref, f64 = mk.fused_log_mel_reference(w, frames, **kw), mk.log_mel_float64(w, frames, **kw)
        dist = lambda a: float((a.double() - f64).abs().max())
        print(f"{name}: from float64 kernel {dist(got):.3e}, plain {dist(ref):.3e}; kernel "
              f"from plain {float((got - ref).abs().max()):.3e}; two launches "
              f"{'bit-equal' if torch.equal(got, again) else 'DIFFER'}")

    libs = build_variants()
    w = noise(120)
    plan = mk.mel_plan(125.0, 3800.0)
    hi, lo, bands, weights = mk._device_plan(125.0, 3800.0, dev)
    out = torch.empty(120, 96, 64, device=dev)
    for lib in libs.values():
        lib.cavp_fused_log_mel.argtypes = mk._library().cavp_fused_log_mel.argtypes

    def runner(lib):
        def run():
            err = lib.cavp_fused_log_mel(
                w.data_ptr(), hi.data_ptr(), lo.data_ptr(), bands.data_ptr(), weights.data_ptr(),
                out.data_ptr(), 120, 16000, 96, mk.frames_per_tile(96), plan.chunks,
                plan.chunk_cols, 0.0, 0.01, torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
        return run

    for name in list(libs) + list(reversed(libs)):
        run = runner(libs[name])
        print(f"{name}: {cs.cuda_ms(run, 20):.4f} ms one call at a time, "
              f"{cs.back_to_back_ms(run):.4f} ms in a row")
    counted = libs["counted"]
    counted.cavp_mel_stamps.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 21)()
    counted.cavp_mel_stamps(buf)
    runner(counted)()
    torch.cuda.synchronize()
    counted.cavp_mel_stamps(buf)
    for wg in range(2):
        c = dict(zip(STAGES, buf[7 * wg:7 * wg + 7]))
        rest = c["total"] - sum(c[k] for k in ("staging", "wait_full", "products", "barrier"))
        print(f"consumer warpgroup {wg}, share of {c['total']} cycles: " + ", ".join(
            f"{k} {100 * c[k] / c['total']:.1f}%" for k in
            ("staging", "wait_full", "products", "barrier")) +
            f", epilogue {100 * rest / c['total']:.1f}%")
    p = dict(zip(STAGES, buf[14:21]))
    print(f"producer: waiting for a free slot {100 * p['wait_empty'] / p['producer']:.1f}% "
          f"of {p['producer']} cycles")
    return 0


if __name__ == "__main__":
    sys.exit(main())
