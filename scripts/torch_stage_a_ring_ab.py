#!/usr/bin/env python3
"""A/B of the bf16 train-fusion backward's stage A on one CUDA GPU.

    python3 scripts/torch_stage_a_ring_ab.py

from the repository root, on a machine with a CUDA GPU and ``nvcc``.
Builds ``cavp_tpu_torch/csrc/fusion_train_kernel.cu`` three times with
stage A's weight ring at 3, 4 and 5 slots (``STAGES``), and once more at
3 slots with ``clock64`` counters that split stage A's cycles into its
products (``gemm``, ``gemm_pair``) and the rest. Each build goes into
``build/stage_a_ab/`` and is held against the plain backward at
``[32, 3136, 304]`` bf16 (largest error over the largest entry, and two
launches bit-equal); stage A is then timed with CUDA events, the three
depths interleaved (3, 4, 5, 5, 4, 3). Prints one JSON object with the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cavp_tpu_torch.ops import _build  # noqa: E402
from cavp_tpu_torch.ops.kernels import fusion_train as ft  # noqa: E402

CSRC = REPO / "cavp_tpu_torch" / "csrc"
OUT = REPO / "build" / "stage_a_ab"


def variant(stages: int, counted: bool) -> str:
    """The kernel source with ``stages`` ring slots; ``counted`` adds the
    cycle counters and ``probe_read`` to fetch and clear them."""
    s = (CSRC / "fusion_train_kernel.cu").read_text()
    s = s.replace("constexpr int STAGES = 3;", f"constexpr int STAGES = {stages};")
    if not counted:
        return s
    s = s.replace("namespace {\n", "namespace {\n__device__ unsigned long long g_cyc[2];\n", 1)
    for head in ("__device__ void gemm(const bf16* A", "__device__ void gemm_pair(const bf16* A1"):
        i = s.index("{", s.index(head))
        s = s[:i + 1] + "\n  const long long c0_ = clock64();" + s[i + 1:]
        end = s.index("  __syncthreads();\n}", i)
        s = (s[:end] + "  __syncthreads();\n  if (threadIdx.x == 0) atomicAdd(&g_cyc[0], "
             "(unsigned long long)(clock64() - c0_));\n}" + s[end + len("  __syncthreads();\n}"):])
    loop = "  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {\n"
    i = s.index(loop, s.index("stage_a_kernel(")) + len(loop)
    s = s[:i] + "    const long long t0_ = clock64();\n" + s[i:]
    tail = "        if (t < nv) put2(dx + (row0 + t) * C + j, v0, v1);\n      });\n    });\n"
    i = s.index(tail) + len(tail)
    s = (s[:i] + "    if (threadIdx.x == 0) atomicAdd(&g_cyc[1], "
         "(unsigned long long)(clock64() - t0_));\n" + s[i:])
    return s.replace('extern "C" {', 'extern "C" {\nint probe_read(unsigned long long* o) {\n'
                     '  cudaError_t e = cudaMemcpyFromSymbol(o, g_cyc, sizeof(g_cyc));\n'
                     '  unsigned long long z[2] = {0, 0};\n'
                     '  cudaMemcpyToSymbol(g_cyc, z, sizeof(z));\n  return (int)e;\n}\n', 1)


def build(builds: dict) -> dict:
    """One shared library per variant (with fusion_kernel.cu, which holds
    the error-string function the wrapper calls), compiled side by side."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build.find_nvcc(), {}
    for name, (stages, counted) in builds.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(variant(stages, counted))
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(OUT / f"{name}.so"), str(cu),
             str(CSRC / "fusion_kernel.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    libs = {}
    for name in builds:
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        _build.load_library = lambda lib=lib: lib   # what ft._library binds
        ft._library.cache_clear()
        libs[name] = ft._library()
    return libs


def use(lib) -> None:
    ft._library = lambda: lib


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    builds = {"s3": (3, False), "s4": (4, False), "s5": (5, False), "s3_counted": (3, True)}
    t0 = time.perf_counter()
    libs = build(builds)
    out = {"card": cs.card_line(), "build_s": round(time.perf_counter() - t0, 1)}

    from cavp_tpu_torch.config import get_config
    from cavp_tpu_torch.engine.runner import build_model

    dev = torch.device("cuda")
    config = get_config("avss").replace(image_width=224, image_height=224,
                                        compute_dtype="bfloat16")
    model = build_model(config, dev)
    cs.random_weights(model, config, dev)
    g = torch.Generator().manual_seed(cs.SEED + 9)
    B, N, C = cs.TRAIN_SHAPE
    x = torch.randn(B, N, C, generator=g).to(dev, torch.bfloat16)
    fea_a = torch.randn(2 * B, C, generator=g).to(dev, torch.bfloat16)
    dy = torch.randn(2 * B, N, C, generator=g).to(dev, torch.bfloat16)
    flat = lambda r: [r[0], r[1], r[2], *r[3]]
    with torch.no_grad():
        wqk2, m2, ws = ft.train_operands(model, fea_a, B, torch.bfloat16)
        ref = flat(ft.token_chain_train_backward_reference(x, wqk2, m2, ws, dy))
        for name, lib in libs.items():
            use(lib)
            a = flat(ft.token_chain_train_backward(x, wqk2, m2, ws, dy))
            b = flat(ft.token_chain_train_backward(x, wqk2, m2, ws, dy))
            torch.cuda.synchronize()
            out[name] = {
                "max_rel_err": max(float((p.float() - r.float()).abs().max())
                                   / float(r.float().abs().max()) for p, r in zip(a, ref)),
                "bit_equal": all(torch.equal(p, q) for p, q in zip(a, b))}
        plans = {}
        for name in ("s3", "s4", "s5"):
            use(libs[name])
            plans[name] = ft._BackwardPlan(x, wqk2, m2, ws, dy, 4)
        times = {name: [] for name in plans}
        for name in ("s3", "s4", "s5", "s5", "s4", "s3"):
            times[name].append(cs.cuda_ms(plans[name].stage_a, 5))
        out["stage_a_ms"] = times
        lib = libs["s3_counted"]
        use(lib)
        plan = ft._BackwardPlan(x, wqk2, m2, ws, dy, 4)
        cycles = (ctypes.c_ulonglong * 2)()
        lib.probe_read(cycles)
        plan.stage_a()
        torch.cuda.synchronize()
        lib.probe_read(cycles)
        out["products_share_of_stage_a_cycles"] = cycles[0] / cycles[1]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
