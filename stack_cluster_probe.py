#!/usr/bin/env python3
"""Time the PyTorch port's fused RealNVP / Glow stack kernels on one NVIDIA
card where the planner (``nf_tpu_torch/ops/cuda/fused_stack.py::ffma_plan``)
chooses between them:

* ``samples``: the cluster kernel at 48, 32 and 16 samples a cluster, at
  B = 1,000 and 8,192, at the cluster path's shapes (``chip_smoke.py``'s
  PAST_BLOCK_STACK_CASES);
* ``narrow``: the FFMA kernel's 16-sample tiling (NARROW_TILE) against the
  cluster kernel at 48 samples, at B = 1,000 and 8,192, at the first and
  the last D of each (model, F) that took that tiling before the cluster
  kernel took the narrow widths;
* ``spill``: the cluster kernel with its x tiles in shared memory (the
  most samples that fit) against in device memory (48 samples), on both
  sides of SPILL_BELOW, and past the shared memory's reach in device
  memory alone.

    python3 stack_cluster_probe.py      # from the root of the repository
    python3 stack_cluster_probe.py narrow     # one part: samples, narrow or spill

Two couplings; random weights of the kernels' own layout (``FfmaWeights``)
from a seed, small enough that no value overflows (the kernels' times do
not depend on the values; their results are held against the plain
version by tests/test_torch_cuda_kernels.py and chip_smoke.py).  Each
configuration: device ms per launch from CUDA events over 10 launches
after 3, forward and inverse.  Prints one JSON line per configuration and
the card's name and power limit.
"""
import json
import subprocess
import sys

import torch

LAYERS = 2
ITERS = 10
SAMPLE_CASES = [("realnvp", 400, 32), ("glow", 400, 32), ("realnvp", 1024, 32),
                ("glow", 1024, 32), ("realnvp", 400, 256), ("realnvp", 63, 256)]
NARROW_CASES = [("realnvp", 97, 8), ("realnvp", 820, 8), ("realnvp", 166, 16),
                ("realnvp", 600, 16), ("realnvp", 213, 32), ("realnvp", 378, 32),
                ("realnvp", 117, 64), ("realnvp", 190, 64), ("realnvp", 79, 128),
                ("realnvp", 94, 128), ("realnvp", 29, 256), ("realnvp", 38, 256),
                ("glow", 76, 8), ("glow", 152, 8), ("glow", 102, 16), ("glow", 146, 16),
                ("glow", 111, 32), ("glow", 132, 32), ("glow", 80, 64), ("glow", 102, 64),
                ("glow", 63, 128), ("glow", 70, 128), ("glow", 27, 256), ("glow", 36, 256)]
SPILL_CASES = [("glow", 1024, 256), ("glow", 1904, 32), ("glow", 1905, 32),
               ("glow", 2048, 32), ("realnvp", 5312, 32), ("realnvp", 5313, 32),
               ("glow", 4096, 32), ("glow", 1300, 256)]


def weights(fs, name, D, F, g, dev, cluster):
    """Random ``FfmaWeights`` of a (D, F) stack: the cluster kernel's mix
    layout (W^T) where ``cluster``, else the FFMA kernel's (W)."""
    n, fp, half = LAYERS, fs.padded_width(F), (D + 1) // 2

    def r(*shape, scale=0.02):
        return scale * torch.randn(*shape, generator=g, device=dev)

    pre = torch.stack([r(n, D), 1 + r(n, D, scale=0.1)], dim=2)
    vec = r(n, fs._N_VEC, fp, scale=0.5)
    vec[:, 1::3] += 1.0
    kw = dict(pre=pre, prei=torch.stack([pre[..., 0], 1 / pre[..., 1]], dim=2),
              w0t=r(n, half, fp), vec=vec, wrt=r(n, 4, fp, fp), wh=r(n, 2 * half, fp),
              bh=r(n, 2 * half), gb=r(n, 2, scale=0.5))
    if name == "glow":
        eye = torch.eye(D, device=dev)
        mix = (eye + r(D, D, scale=0.2 / D ** 0.5)).expand(n, D, D).contiguous()
        mixi = torch.linalg.inv(mix)
        kw["mix"], kw["mixi"] = ((fs.cluster_mix(mix), fs.cluster_mix(mixi)) if cluster
                                 else (mix, mixi))
    path, tile = fs.ffma_plan(D, F, name == "glow")
    return fs.FfmaWeights(fp=fp, tile=tile, path=path, **kw)


def launcher(fs, kw, name, D, B, x, y, ld, inverse, kernel, samples):
    """One launch of ``kernel`` ('cluster', 'spill' or 'narrow')."""
    mix = kw.mixi if inverse else kw.mix
    ptrs = [x.data_ptr(), y.data_ptr(), ld.data_ptr(),
            (kw.prei if inverse else kw.pre).data_ptr(),
            0 if mix is None else mix.data_ptr(), kw.w0t.data_ptr(), kw.vec.data_ptr(),
            kw.wrt.data_ptr(), kw.wh.data_ptr(), kw.bh.data_ptr(), kw.gb.data_ptr()]
    stream = torch.cuda.current_stream().cuda_stream
    glow = int(name == "glow")
    if kernel == "narrow":
        S, TS = fs.NARROW_TILE
        return lambda: fs._ffma_fn()(*ptrs, B, D, LAYERS, kw.fp, S, TS, int(inverse), glow,
                                     0.0, stream)
    spill = None
    if kernel == "spill":
        blocks = -(-B // samples) * fs.CLUSTER
        spill = x.new_empty(blocks * fs.spill_floats(samples, D, name == "glow"))
    sp = 0 if spill is None else spill.data_ptr()
    return lambda: fs._cluster_fn()(*ptrs, sp, B, D, LAYERS, kw.fp, samples, int(inverse),
                                    glow, 0.0, stream)


def device_ms(fn):
    for _ in range(3):
        if fn() != 0:
            raise RuntimeError("launch failed")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def time_case(fs, dev, g, what, name, D, F, B, configs):
    """configs: [(kernel, samples)], each timed forward and inverse."""
    kws = {}
    x = torch.randn(B, D, generator=g, device=dev)
    y, ld = torch.empty_like(x), x.new_empty(B)
    row = dict(probe=what, model=name, D=D, F=F, B=B,
               plan=list(fs.ffma_plan(D, F, name == "glow")))
    for kernel, samples in configs:
        cluster = kernel != "narrow"
        if cluster not in kws:
            kws[cluster] = weights(fs, name, D, F, g, dev, cluster)
        key = f"{kernel}_{samples}"
        row[key] = [device_ms(launcher(fs, kws[cluster], name, D, B, x, y, ld, inv, kernel,
                                       samples)) for inv in (False, True)]
        row[key + "_finite"] = bool(torch.isfinite(y).all() and torch.isfinite(ld).all())
    print(json.dumps(row), flush=True)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from nf_tpu_torch.ops.cuda import _build
    from nf_tpu_torch.ops.cuda import fused_stack as fs

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build(("fused_stack", "fused_stack_wide"))
    g = torch.Generator(device=dev).manual_seed(0)

    def fits(name, D, F, S, spill=False):
        fp = fs.padded_width(F)
        return fs.smem_bytes(fp, S, D, name == "glow", True, spill) <= fs.SMEM_LIMIT

    parts = sys.argv[1:] or ["samples", "narrow", "spill"]
    with torch.no_grad():
        for name, D, F in SAMPLE_CASES if "samples" in parts else ():
            for B in (1000, 8192):
                time_case(fs, dev, g, "samples", name, D, F, B,
                          [("cluster", S) for S in (48, 32, 16) if fits(name, D, F, S)])
        for name, D, F in NARROW_CASES if "narrow" in parts else ():
            for B in (1000, 8192):
                time_case(fs, dev, g, "narrow", name, D, F, B,
                          [("narrow", fs.NARROW_TILE[0]), ("cluster", 48)])
        for name, D, F in SPILL_CASES if "spill" in parts else ():
            smem = next((S for S in fs.CLUSTER_SAMPLES if fits(name, D, F, S)), None)
            configs = [("spill", 48)] + ([] if smem is None else [("cluster", smem)])
            time_case(fs, dev, g, "spill", name, D, F, 1000, configs)
    print(json.dumps({"card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
