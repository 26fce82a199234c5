#!/usr/bin/env python3
"""Measure the PyTorch port's wide ResFlow kernel (``csrc/fused_resflow_wide.cu``)
on one NVIDIA card, for its planner (``nf_tpu_torch/ops/cuda/fused_resflow.py::
wide_plan``):

* ``check``: the three variants (fwd_ld, solve_ld, solve) at the planner's
  plan against the plain versions, at (D, F) = (2, 512) and (16, 64), B =
  1,000 and 8,192, with the plan, the times and the host's own cost of a
  solve's ``fused_resflow.launch`` (``solve_host_ms``);
* ``occupancy``: the clusters the card holds at once
  (cudaOccupancyMaxActiveClusters) for each cluster size at the plan's
  shared memory (fused_resflow.ACTIVE_CLUSTERS records them);
* ``clusters``: cluster sizes C in {1, 2, 4, 8} (where the plan exists)
  and samples a cluster S in {8, 16, 24, 32, 48, 64} (where they fit), at B =
  1,000 and 8,192, for (D, F) = (2, 512), (2, 1024), (16, 64) and (63, 256)
  (BSDS300's width), beside the planner's own choice;
* ``tile``: the tiled kernel (csrc/fused_resflow.cu) at (2, 256) beside
  the wide kernel at the same shape, a record only (the routing between the
  two stays ``fused_resflow.kernel_path``'s);
* ``phases``: a timed build of the kernel (``resflow_wide_phases.patch``
  applied to a copy of the source, built into the build directory beside
  the normal one) at the planner's plan, (2, 512) and (16, 64), B = 1,000:
  the SM clocks thread 0 of block 0 spends in each phase of a call
  (``WidePhase``), a where-the-time-goes breakdown.

    python3 resflow_wide_probe.py            # from the root of the repository: all parts
    python3 resflow_wide_probe.py clusters   # one part

Two residual blocks of the port's ResFlow 2-D model (build_model, weights
from a seed, ActNorm perturbed as chip_smoke.py perturbs it), the port's
serving probes (``eval_probes``).  Each configuration: device ms per launch
from CUDA events over 10 launches after 3, each variant (the inverse and
the solve at the forward's output).  Prints one JSON line per configuration
and the card's name and power limit.
"""
import json
import subprocess
import sys

import torch

LAYERS = 2
ITERS = 10
CHECK_CASES = [(2, 512), (16, 64)]
CLUSTER_CASES = [(2, 512), (2, 1024), (16, 64), (63, 256)]
BATCHES = (1000, 8192)
SAMPLES = (8, 16, 24, 32, 48, 64)
# chip_smoke.py's tolerances: z / log-det of the forward, the inverse's x and log-det
Z_TOL = dict(atol=1e-4, rtol=1e-4)
LD_ATOL = 1e-3
INV_ATOL = 1e-3


def stack_of(D, F, dev, seed):
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.ops.cuda import fused_resflow as rf

    cfg = NetworkConfig(name="resflow", layers=LAYERS, base_filters=F, logdet="unbias")
    model = build_model("resflow", (D,), "2d", cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    model.init(g)
    with torch.no_grad():
        for layer in model.bijector.layers[::2]:
            layer.log_scale.normal_(0.0, 0.3, generator=g)
            layer.bias.normal_(0.0, 0.3, generator=g)
    spec = rf.extract_resflow_spec(model.bijector, model.dims)
    return rf.PackedResFlow(spec, rf.pack_resflow(model.bijector, spec))


def device_ms(fn, iters=ITERS):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def inputs(D, B, dev, seed):
    from nf_tpu_torch.ops.estimators import eval_probes

    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(B, D, generator=g, device=dev), eval_probes("unbias", B, D, dev)


def plan_fields(plan):
    return {"cluster": plan.cluster, "samples": plan.samples, "chunk": plan.chunk,
            "kchunk": plan.kchunk, "residency": plan.residency, "w1_res": plan.w1_res,
            "w3_res": plan.w3_res, "vec_smem": plan.vec_smem, "smem_bytes": plan.smem_bytes}


def host_ms(fn, iters=100):
    """The host's own ms per call: ``iters`` calls up to the last one's
    return, before the synchronize."""
    import time

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def time_plan(st, x, probes, plan):
    """ms per launch of each variant at ``plan`` (the weights of its cluster)."""
    from nf_tpu_torch.ops.cuda import fused_resflow as rf

    z, _ = rf.launch_wide(st, x, "forward", probes, plan)
    return {"fwd_ld_ms": device_ms(lambda: rf.launch_wide(st, x, "forward", probes, plan)),
            "solve_ld_ms": device_ms(lambda: rf.launch_wide(st, z, "inverse", probes, plan)),
            "solve_ms": device_ms(lambda: rf.launch_wide(st, z, "solve", None, plan))}


def check(dev):
    """Each variant at the planner's plan against its plain version."""
    from nf_tpu_torch.ops.cuda import fused_resflow as rf

    ok = True
    for D, F in CHECK_CASES:
        st = stack_of(D, F, dev, D + F)
        spec, packed = st.spec, st.packed
        for B in BATCHES:
            x, probes = inputs(D, B, dev, B + D)
            plan = rf.wide_plan(F, D, B, cluster=st.kernel.cluster)
            z, ld = rf.launch(st, x, "forward", probes)
            zr, ldr = rf.fused_resflow_fwd_logdet_reference(spec, packed, x, probes)
            xi, ldi = rf.launch(st, zr, "inverse", probes)
            xr, ldir = rf.fused_resflow_solve_logdet_reference(spec, packed, zr, probes)
            xs = rf.launch(st, zr, "solve")
            torch.cuda.synchronize()
            e = {k: float((a - b).abs().max()) for k, a, b in (
                ("z", z, zr), ("ld", ld, ldr), ("x_inv", xi, xr), ("ld_inv", ldi, ldir),
                ("x_solve", xs, xr))}
            good = (torch.allclose(z, zr, **Z_TOL) and e["ld"] <= LD_ATOL
                    and max(e["x_inv"], e["ld_inv"], e["x_solve"]) <= INV_ATOL)
            ok &= good
            print(json.dumps({"part": "check", "D": D, "F": F, "B": B, **plan_fields(plan),
                              "n_terms": probes[1].tolist(), "max_abs_err": e, "ok": good,
                              **time_plan(st, x, probes, plan),
                              "solve_host_ms": host_ms(lambda: rf.launch(st, zr, "solve"))}),
                  flush=True)
    return ok


def occupancy(dev):
    from nf_tpu_torch.ops.cuda import fused_resflow as rf

    for D, F in CLUSTER_CASES:
        for C in rf.CLUSTER_SIZES:
            try:
                plan = rf.wide_plan(F, D, 1000, cluster=C)
            except ValueError:
                continue
            print(json.dumps({"part": "occupancy", "D": D, "F": F, **plan_fields(plan),
                              "active_clusters": rf.wide_active_clusters(plan)}), flush=True)
    return True


def clusters(dev):
    from nf_tpu_torch.ops.cuda import fused_resflow as rf

    for D, F in CLUSTER_CASES:
        st = stack_of(D, F, dev, D + F)
        chosen = rf.wide_cluster(F, D)
        for C in rf.CLUSTER_SIZES:
            st.kernel = rf.wide_weights(st.spec, st.packed, C)
            for B in BATCHES:
                x, probes = inputs(D, B, dev, B + D)
                planned = rf.wide_plan(F, D, B, cluster=C)
                plans = {planned}
                for S in SAMPLES:
                    try:
                        plans.add(rf.wide_plan(F, D, B, cluster=C, samples=S))
                    except ValueError:
                        pass
                for plan in sorted(plans, key=lambda p: p.samples):
                    row = {"part": "clusters", "D": D, "F": F, "B": B, **plan_fields(plan),
                           "planner": plan == planned and C == chosen,
                           "planned_for_C": plan == planned}
                    print(json.dumps({**row, **time_plan(st, x, probes, plan)}), flush=True)
    return True


def tile(dev):
    """(2, 256): the tiled kernel (kernel_path 'tile') beside the wide
    kernel on the same stack."""
    from nf_tpu_torch.ops.cuda import fused_resflow as rf

    D, F = 2, 256
    st = stack_of(D, F, dev, D + F)
    tiled = st.kernel
    for B in BATCHES:
        x, probes = inputs(D, B, dev, B + D)
        st.kernel = tiled
        z, _ = rf.launch(st, x, "forward", probes)
        t = {"fwd_ld_ms": device_ms(lambda: rf.launch(st, x, "forward", probes)),
             "solve_ld_ms": device_ms(lambda: rf.launch(st, z, "inverse", probes)),
             "solve_ms": device_ms(lambda: rf.launch(st, z, "solve"))}
        print(json.dumps({"part": "tile", "kernel": "tile", "D": D, "F": F, "B": B, **t}),
              flush=True)
        st.kernel = rf.wide_weights(st.spec, st.packed)
        plan = rf.wide_plan(F, D, B, cluster=st.kernel.cluster)
        print(json.dumps({"part": "tile", "kernel": "wide", "D": D, "F": F, "B": B,
                          **plan_fields(plan), **time_plan(st, x, probes, plan)}), flush=True)
        st.kernel = tiled
    return True


PHASES = ("stage_a", "stage_b", "k_barrier", "epilogue_b", "c_barrier", "stage_c", "exchange",
          "reduce", "r_barrier", "dot", "staging", "other")


def patched(text, patch):
    """``text`` with a unified diff's hunks applied, each at the first match
    of its context after the previous hunk."""
    lines, out, at = text.split("\n"), [], 0
    hunks = patch.split("\n@@")[1:]
    for hunk in hunks:
        body = [l for l in hunk.split("\n")[1:] if l[:1] in (" ", "-", "+")]
        old = [l[1:] for l in body if l[0] != "+"]
        new = [l[1:] for l in body if l[0] != "-"]
        i = next(i for i in range(at, len(lines) - len(old) + 1)
                 if lines[i:i + len(old)] == old)
        out += lines[at:i] + new
        at = i + len(old)
    return "\n".join(out + lines[at:])


def timed_library():
    """The kernel with resflow_wide_phases.patch's phase marks, built into
    the build directory."""
    import ctypes
    import hashlib
    from pathlib import Path

    from nf_tpu_torch.ops.cuda import _build

    patch = (Path(__file__).resolve().parent / "resflow_wide_phases.patch").read_text()
    src = patched((_build.CSRC_DIR / "fused_resflow_wide.cu").read_text(), patch)
    digest = hashlib.sha256(b"".join([src.encode()] + [p.read_bytes() for p in
                                      sorted(_build.CSRC_DIR.glob("*.cuh"))])).hexdigest()
    so = _build.BUILD_DIR / f"libfused_resflow_wide_timed-{digest[:16]}.so"
    if not so.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = so.with_suffix(".cu")
        cu.write_text(src)
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
                        "-o", str(so), str(cu)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def phases(dev):
    import ctypes

    from nf_tpu_torch.ops.cuda import _build
    from nf_tpu_torch.ops.cuda import fused_resflow as rf

    lib = timed_library()
    plain = _build._loaded.get("fused_resflow_wide")
    _build._loaded["fused_resflow_wide"] = lib
    out = (ctypes.c_ulonglong * len(PHASES))()
    try:
        for D, F in CHECK_CASES:
            st = stack_of(D, F, dev, D + F)
            x, probes = inputs(D, 1000, dev, 1000 + D)
            plan = rf.wide_plan(F, D, 1000, cluster=st.kernel.cluster)
            z, _ = rf.launch(st, x, "forward", probes)
            for direction, inp, pr in (("forward", x, probes), ("inverse", z, probes),
                                       ("solve", z, None)):
                torch.cuda.synchronize()
                lib.nf_fused_resflow_wide_phases(out)
                rf.launch(st, inp, direction, pr)
                torch.cuda.synchronize()
                lib.nf_fused_resflow_wide_phases(out)
                clocks = dict(zip(PHASES, list(out)))
                total = sum(clocks.values())
                print(json.dumps({"part": "phases", "D": D, "F": F, "B": 1000,
                                  "direction": direction, **plan_fields(plan),
                                  "block0_clocks": total,
                                  "share": {k: round(v / total, 4) for k, v in clocks.items()},
                                  "clocks": clocks}), flush=True)
    finally:
        if plain is None:
            _build._loaded.pop("fused_resflow_wide")
        else:
            _build._loaded["fused_resflow_wide"] = plain
    return True


PARTS = {"check": check, "occupancy": occupancy, "clusters": clusters, "tile": tile,
         "phases": phases}


def main():
    if not torch.cuda.is_available():
        print("resflow_wide_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    names = sys.argv[1:] or list(PARTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    ok = all([PARTS[n](dev) for n in names])
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
