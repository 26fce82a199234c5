#!/usr/bin/env python3
"""Drive the PyTorch port (nf_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of the repository

Phases, each of which exits non-zero when it fails:
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the path from nf_tpu_torch/csrc/;
  3. hold each kernel against its plain PyTorch version on the card:
     RealNVP 2-D at full width (32 couplings, F = 32, B = 8192) and a
     ragged D = 3, n = 4, F = 64, B = 1000 stack; z atol/rtol 1e-4,
     logdet atol 1e-3 (f32 sums in another order, compounded through 32
     exp(s) factors);
  4. the main path: build_model("realnvp", (2,), "2d") on the card ->
     init(generator) -> eval_program -> log_prob(x) and sample(8192),
     with the launch counters set to 0 just before and read just after,
     and the outputs checked (finite, round trip, against the eager
     chain on a small batch);
  5. time each kernel (CUDA events, warm L2 as in a serving loop), its
     plain version and the serving rate fwd_inv_samples_per_s =
     8192 / (t_fwd + t_inv), bench.py's definition; print the kernels line
     with each kernel's bound;
  6. print {"ok": true, "device": {...}} as the last line.
Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.
"""
import json
import subprocess
import sys
import time

import torch

BATCH = 8192
SEED = 0
Z_TOL = dict(atol=1e-4, rtol=1e-4)
LD_ATOL = 1e-3
# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12


class SmokeFailure(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def perturbed_program(D, layers, F, device, seed):
    """Serving program of a RealNVP density model with random weights and
    running statistics moved off identity, so the host folding has teeth."""
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model

    model = build_model("realnvp", (D,), "2d",
                        NetworkConfig(layers=layers, base_filters=F), device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    params = model.init(g)
    with torch.no_grad():
        for name, buf in params.items():
            if name.endswith("running_mean"):
                buf.copy_(0.3 * torch.randn(buf.shape, generator=g, device=device))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g, device=device))
    return model, model.eval_program(params), g


def device_ms(fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def stack_work(stack, batch):
    """Operations and bytes one direction of the fused stack needs: the
    conditioner's multiply-adds (2 flops each) and elementwise operations at
    the model's own width F, and each input / weight read and each output
    written once."""
    spec = stack.spec
    D, F = spec.dim, spec.filters
    mac = elem = 0
    for c in range(spec.n_repeats):
        out, inp = spec.halves[c % 2]
        mac += 2 * (inp * F + 4 * F * F + 2 * out * F)
        # norm 2D; biases 5F + 2out; BN affine + ReLU 15F; residual 2F;
        # coupling tanh, gain, bias, exp, mul, add, logdet sum 7out
        elem += 2 * D + 22 * F + 9 * out
    weights = sum(t.numel() for p in stack.packed for k, t in p.items() if k != "prei")
    bytes_ = 4 * (2 * batch * D + batch + weights)
    return batch * mac, batch * elem, bytes_


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from nf_tpu_torch.ops.cuda import _build
    from nf_tpu_torch.ops.cuda import fused_stack as fs
    from nf_tpu_torch.ops.math import standard_normal_logprob

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- 2. build every kernel of the path
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # ---- 3. kernels against their plain versions
    errs = {"fused_stack_fwd": 0.0, "fused_stack_inv": 0.0}
    cases = [(2, 32, 32, BATCH), (3, 4, 64, 1000)]
    for D, layers, F, B in cases:
        _, prog, g = perturbed_program(D, layers, F, dev, SEED + D)
        x = torch.randn(B, D, generator=g, device=dev)
        for direction, name in (("forward", "fused_stack_fwd"), ("inverse", "fused_stack_inv")):
            y, ld = fs.launch(prog.stack, x, direction == "inverse")
            torch.cuda.synchronize()
            yr, ldr = fs.fused_stack_reference(prog.stack.packed, prog.stack.const_ld,
                                               x, direction)
            ey = float((y - yr).abs().max())
            eld = float((ld - ldr).abs().max())
            print(f"check {name} D={D} n={layers} F={F} B={B}: "
                  f"max|dz|={ey:.3e} max|dlogdet|={eld:.3e}")
            check(torch.isfinite(y).all() and torch.isfinite(ld).all(),
                  f"{name}: non-finite output")
            check(torch.allclose(y, yr, **Z_TOL), f"{name} D={D}: z off by {ey}")
            check(eld <= LD_ATOL, f"{name} D={D}: logdet off by {eld}")
            errs[name] = max(errs[name], ey, eld)

    # ---- 4. the main path, through the entry points a user calls
    from nf_tpu_torch.config import NETWORK_DEFAULTS, NetworkConfig
    from nf_tpu_torch.models import build_model

    cfg = NetworkConfig(name="realnvp", **NETWORK_DEFAULTS["realnvp"])
    model = build_model("realnvp", (2,), "2d", cfg)
    check(model.device.type == "cuda", "build_model did not default to the card")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = model.init(gen)
    prog = model.eval_program(params)
    check(prog.stack is not None, "the headline model missed the fused stack")
    x = torch.randn(BATCH, 2, generator=gen, device=dev)

    fs.reset_launches()
    log_px = prog.log_prob(x)
    y_s, log_py = prog.sample(BATCH, gen)
    torch.cuda.synchronize()
    launches = dict(fs.LAUNCHES)
    print(f"main path launches: {launches}")
    check(launches == {"fused_stack_fwd": 1, "fused_stack_inv": 1},
          f"expected one launch per call, got {launches}")

    check(log_px.shape == (BATCH,) and y_s.shape == (BATCH, 2) and log_py.shape == (BATCH,),
          "main path output shapes")
    for t, what in ((log_px, "log_prob"), (y_s, "sample"), (log_py, "sample log p")):
        check(bool(torch.isfinite(t).all()), f"{what}: non-finite values")
    z, ld = prog.forward(x)
    xr, ldi = prog.inverse(z)
    rt = float((xr - x).abs().max())
    ld_sum = float((ld + ldi).abs().max())
    print(f"round trip: max|x - inv(fwd(x))|={rt:.3e} max|ld_fwd + ld_inv|={ld_sum:.3e}")
    check(rt < 1e-3 and ld_sum < 1e-3, "round trip")
    with torch.no_grad():
        zc, ldc = model(x[:256])             # the eager chain, cuBLAS f32
    lp_small = float((prog.log_prob(x[:256]) - (standard_normal_logprob(zc) + ldc)).abs().max())
    print(f"eager chain vs serving program, 256 samples: max|dlog p|={lp_small:.3e} "
          f"max|dz|={float((z[:256] - zc).abs().max()):.3e}")
    check(torch.allclose(z[:256], zc, **Z_TOL) and lp_small <= LD_ATOL,
          "serving program disagrees with the eager chain")

    # ---- 5. timing and bounds
    stack = prog.stack
    zin = torch.randn(BATCH, 2, generator=gen, device=dev)
    mac, elem, nbytes = stack_work(stack, BATCH)
    bound_f32 = max((mac + elem) / F32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    bound_tf32 = max(mac / TF32_FLOPS, elem / F32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    kernels = []
    for name, inv, inp in (("fused_stack_fwd", False, x), ("fused_stack_inv", True, zin)):
        direction = "inverse" if inv else "forward"
        ms = device_ms(lambda: fs.launch(stack, inp, inv), 200)
        plain = device_ms(lambda: fs.fused_stack_reference(stack.packed, stack.const_ld,
                                                           inp, direction), 10)
        kernels.append({
            "name": name, "route": "cuda", "source": "nf_tpu_torch/csrc/fused_stack.cu",
            "replaces": ("nf_tpu/ops/pallas/fused_stack.py:422" if inv
                         else "nf_tpu/ops/pallas/fused_stack.py:397"),
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain, "bound_ms": bound_f32, "bound_by": "operations",
            "library_ms": None,
            "library_note": "no single PyTorch call computes the whole stack",
            "tf32_bound_ms": bound_tf32, "flop": mac + elem, "bytes": nbytes,
            "shape": [BATCH, 2], "couplings": stack.spec.n_repeats,
            "filters": stack.spec.filters,
        })
    t_fwd = wall_ms(lambda: prog.forward(x), 200)
    t_inv = wall_ms(lambda: prog.inverse(zin), 200)
    rate = BATCH / ((t_fwd + t_inv) / 1e3)
    print(json.dumps({"main_path": {
        "model": "realnvp 2d, 32 couplings, F=32", "batch": BATCH,
        "eval_program_forward_ms": t_fwd, "eval_program_inverse_ms": t_inv,
        "fwd_inv_samples_per_s": rate, "card": smi}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
