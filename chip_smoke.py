#!/usr/bin/env python3
"""Drive the PyTorch port (nf_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of the repository

Phases, each of which exits non-zero when it fails:
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the path from nf_tpu_torch/csrc/ (one nvcc
     per source, all at once);
  3. hold each kernel against its plain PyTorch version on the card, with
     weights, ActNorm parameters and running statistics moved off
     identity by a seed:
       RealNVP and Glow fused stack: D = 2, 32 couplings, F = 32,
         B = 8192, and a ragged D = 3, n = 4, F = 64, B = 1000;
       Flow++: 32 couplings, F = 32, K = 8, B = 8192, and a ragged
         n = 4, F = 64, K = 4, B = 1000;
     forward z atol/rtol 1e-4, logdet atol 1e-3 (f32 sums in another
     order, compounded through 32 couplings); the Flow++ inverse runs on
     the forward's latent of the same data, as tests/test_pallas.py
     inverts the chain's output, with x atol 1e-2 and logdet atol 5e-3:
     the kernel's and the plain version's Newton solves meet the same
     root only within XTOL = 1e-5 per coupling, and 32 couplings of
     random weights expand that (max|dx| 4.8e-3 and max|dlogdet| 3.9e-3
     on an H100, where the plain version's own round trip x -> z -> x
     misses x by as much; the line "plain round trip" prints it);
  4. the main path, for "realnvp", "glow" and "flow++" in turn:
     build_model(name, (2,), "2d") on the card -> init(generator) ->
     (Glow / Flow++: ActNorm moved off identity by the seed) ->
     eval_program -> log_prob(x) and sample(8192), with every launch
     counter set to 0 just before and read just after (one launch of that
     model's kernel per call, none of any other), and the outputs checked
     (finite, round trip, against the eager chain on 256 samples);
  5. time each kernel (CUDA events, warm L2 as in a serving loop), its
     plain version and, per model, the serving rate
     fwd_inv_samples_per_s = 8192 / (t_fwd + t_inv), bench.py's
     definition; print one main_path line per model and the kernels line
     with each kernel's bound;
  6. print {"ok": true, "device": {...}} as the last line.
Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.
"""
import json
import re
import subprocess
import sys
import time

import torch

BATCH = 8192
SEED = 0
Z_TOL = dict(atol=1e-4, rtol=1e-4)
LD_ATOL = 1e-3
# Flow++ inverse: two Newton solves agree within XTOL per coupling,
# expanded through 32 couplings (see phase 3 above)
FLOWPP_INV_X_ATOL = 1e-2
FLOWPP_INV_LD_ATOL = 5e-3
# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
SMS = 132
# special-function unit results per SM and clock, compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput table)
SFU_PER_SM_CLOCK = 16
PLAIN_ITERS = 10

KERNEL_SOURCES = {
    "fused_stack_fwd": ("nf_tpu_torch/csrc/fused_stack.cu", "nf_tpu/ops/pallas/fused_stack.py:397"),
    "fused_stack_inv": ("nf_tpu_torch/csrc/fused_stack.cu", "nf_tpu/ops/pallas/fused_stack.py:422"),
    "fused_stack_glow_fwd": ("nf_tpu_torch/csrc/fused_stack.cu",
                             "nf_tpu/ops/pallas/fused_stack.py:397"),
    "fused_stack_glow_inv": ("nf_tpu_torch/csrc/fused_stack.cu",
                             "nf_tpu/ops/pallas/fused_stack.py:422"),
    "fused_flowpp_fwd": ("nf_tpu_torch/csrc/fused_flowpp.cu",
                         "nf_tpu/ops/pallas/fused_flowpp.py:312"),
    "fused_flowpp_inv": ("nf_tpu_torch/csrc/fused_flowpp.cu",
                         "nf_tpu/ops/pallas/fused_flowpp.py:328"),
}
MODELS = {"realnvp": ("fused_stack_fwd", "fused_stack_inv"),
          "glow": ("fused_stack_glow_fwd", "fused_stack_glow_inv"),
          "flow++": ("fused_flowpp_fwd", "fused_flowpp_inv")}


class SmokeFailure(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


@torch.no_grad()
def perturb(model, g, device):
    """Move ActNorm shift / log-scale and the running statistics off
    identity, so the host folding has teeth."""
    D = model.dims[-1]
    for name, p in model.named_parameters():
        if name.endswith((".log_scale", ".bias")) and p.dim() == 1 and p.numel() == D:
            p.copy_(0.3 * torch.randn(p.shape, generator=g, device=device))
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(0.3 * torch.randn(buf.shape, generator=g, device=device))
        elif name.endswith("running_var"):
            buf.copy_(0.5 + torch.rand(buf.shape, generator=g, device=device))


def perturbed_program(name, D, layers, F, device, seed, K=8):
    """Serving program of a density model with random weights moved off
    their init values."""
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model

    model = build_model(name, (D,), "2d",
                        NetworkConfig(layers=layers, base_filters=F, mixtures=K),
                        device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    params = model.init(g)
    perturb(model, g, device)
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


def device_busy(fn, iters):
    """Share of a window of ``iters`` calls in which the card runs a
    kernel, from torch.profiler (CPU and CUDA activity): the kernels' own
    device time over the window's wall time.  The profiler adds host cost,
    so the idle share it gives is an upper bound.  None when the trace
    holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return busy_us / wall_us if busy_us > 0 else None


def stack_work(stack, batch):
    """Operations and bytes one direction of the RealNVP / Glow fused stack
    needs: the conditioner's multiply-adds (2 flops each) and elementwise
    operations at the model's own width F, the Glow mix's D*D
    multiply-adds, and each input / weight read and each output written
    once."""
    spec = stack.spec
    D, F = spec.dim, spec.filters
    mac = elem = 0
    for c in range(spec.n_repeats):
        out, inp = spec.halves[c % 2]
        mac += 2 * (inp * F + 4 * F * F + 2 * out * F + (D * D if spec.has_mix else 0))
        # norm 2D; biases 5F + 2out; BN affine + ReLU 15F; residual 2F;
        # coupling tanh, gain, bias, exp, mul, add, logdet sum 7out
        elem += 2 * D + 22 * F + 9 * out
    weights = sum(t.numel() for p in stack.packed for k, t in p.items()
                  if k not in ("prei", "mixi"))
    bytes_ = 4 * (2 * batch * D + batch + weights)
    return {"flop": batch * (mac + elem), "mac_flop": batch * mac, "elem": batch * elem,
            "transcendental": 0, "bytes": bytes_}


def newton_evaluation_counter():
    """A stand-in for fused_flowpp's mixture inverse that counts how many
    mixture evaluations the kernel's Newton does on these inputs: an
    element evaluates once per trip until it is done, and once more after
    the last trip if it never is.  Each call records (evaluations, what a
    warp of 32 consecutive samples runs: 32 x its slowest lane's count)."""
    from nf_tpu_torch.bijectors import mixlogcdf as mlc

    counts = []

    def counting_inverse(y, logpi, mu, s):
        x = torch.zeros_like(y)
        lo, hi = torch.full_like(y, -mlc.SPAN), torch.full_like(y, mlc.SPAN)
        dxold = torch.full_like(y, 2.0 * mlc.SPAN)
        active = torch.ones_like(y, dtype=torch.bool)
        evals = torch.zeros_like(y, dtype=torch.int64)
        for _ in range(mlc.N_ITERS):
            evals += active
            u, v, logpdf = mlc._mix_logit_parts(x, logpi, mu, s)
            f = (u - v) - y
            lo = torch.where(f < 0, x, lo)
            hi = torch.where(f >= 0, x, hi)
            df = torch.clamp(torch.exp(logpdf - u - v), min=mlc.TINY)
            dx = f / df
            xn = x - dx
            use_bis = ((xn <= lo) | (xn >= hi) | (torch.abs(2.0 * f) > torch.abs(dxold * df))
                       | ~torch.isfinite(xn))
            done = (torch.abs(dx) <= mlc.XTOL) | ((hi - lo) <= mlc.XTOL)
            active &= ~done
            dx = torch.where(use_bis, (hi - lo) * 0.5, dx)
            xn = torch.where(use_bis, (lo + hi) * 0.5, xn)
            x = torch.where(done, x, xn)
            dxold = torch.where(done, torch.zeros_like(dx), dx)
        evals += active
        lanes = torch.nn.functional.pad(evals, (0, -evals.numel() % 32))
        counts.append((int(evals.sum()), 32 * int(lanes.view(-1, 32).amax(1).sum())))
        return mlc.mix_log_cdf_logit_inverse(y, logpi, mu, s)

    return counting_inverse, counts


def flowpp_work(stack, x, inverse):
    """Operations and bytes one direction of the Flow++ stack needs on
    these inputs.  Per sample and coupling: F + 5F^2 + (2+3K)F multiply-adds
    and about 30F + 15K + 20 other f32 operations; transcendentals are
    exp / expm1 / log / log1p / tanh / sigmoid / rsqrt, counted one each:
    6F + 2K + 5 in the conditioner and head, and 5K + 3 per mixture
    evaluation (exp(-|z|) and log1p per component, three log-sum-exps'
    exp per component and log).  The forward evaluates the mixture once;
    the inverse as often as its Newton needs on these inputs (counted by
    replaying the solve in the plain version), each with about 12K + 15
    more f32 operations."""
    from nf_tpu_torch.ops.cuda import fused_flowpp as ff

    spec = stack.spec
    F, K, n = spec.filters, spec.n_mixtures, spec.n_repeats
    B = x.shape[0]
    if inverse:
        counter, counts = newton_evaluation_counter()
        original = ff.mix_log_cdf_logit_inverse
        ff.mix_log_cdf_logit_inverse = counter
        try:
            ff.fused_flowpp_reference(stack.packed, stack.const_ld, x, "inverse")
        finally:
            ff.mix_log_cdf_logit_inverse = original
        evaluations = sum(c[0] for c in counts)
        warp_evaluations = sum(c[1] for c in counts)
    else:
        evaluations = warp_evaluations = B * n
    mac = B * n * (F + 5 * F * F + (2 + 3 * K) * F)
    elem = B * n * (30 * F + 15 * K + 20) + evaluations * (12 * K + 15)
    trans = B * n * (6 * F + 2 * K + 5) + evaluations * (5 * K + 3)
    weights = sum(t.numel() for p in stack.packed for k, t in p.items() if k != "prei")
    return {"flop": 2 * mac + elem, "mac_flop": 2 * mac, "elem": elem,
            "transcendental": trans, "bytes": 4 * (2 * B * 2 + B + weights),
            "mixture_evaluations": evaluations, "warp_mixture_evaluations": warp_evaluations}


def bound_of(work, sfu_per_s):
    """The least time in ms: the largest of f32 operations, transcendentals
    on the SFUs, and bytes, each at its peak rate."""
    times = {"operations": max(work["flop"] / F32_FLOPS,
                               work["transcendental"] / sfu_per_s),
             "bytes": work["bytes"] / HBM_BYTES_PER_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def ptxas_summary(log):
    """One line per kernel instantiation from nvcc's -Xptxas -v output:
    its template arguments, registers and spill bytes."""
    out, args, spill = [], "", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?kernelI(\w*?)EEv", line)
        if m:
            args = ",".join(re.findall(r"L[ib](\d+)", m.group(1)))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"<{args}> {m.group(1)} registers, {spill}")
    return out


def reset_all(modules):
    for m in modules:
        m.reset_launches()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from nf_tpu_torch.ops.cuda import _build
    from nf_tpu_torch.ops.cuda import fused_flowpp as ff
    from nf_tpu_torch.ops.cuda import fused_stack as fs
    from nf_tpu_torch.ops.math import standard_normal_logprob

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    counters = (fs, ff)
    launches_of = lambda: {**fs.LAUNCHES, **ff.LAUNCHES}  # noqa: E731

    # ---- 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"], capture_output=True, text=True,
                           check=True, timeout=60).stdout.strip().splitlines()[0]
    sfu_per_s = SMS * SFU_PER_SM_CLOCK * float(clock) * 1e6
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}; "
          f"max SM clock {clock} MHz")

    # ---- 2. build every kernel of the path
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        for line in ptxas_summary(path.with_suffix(".log").read_text()):
            print(f"  {name}: {line}")

    # ---- 3. kernels against their plain versions
    errs = {k: 0.0 for k in KERNEL_SOURCES}
    cases = [("realnvp", 2, 32, 32, BATCH, 8), ("realnvp", 3, 4, 64, 1000, 8),
             ("glow", 2, 32, 32, BATCH, 8), ("glow", 3, 4, 64, 1000, 8),
             ("flow++", 2, 32, 32, BATCH, 8), ("flow++", 2, 4, 64, 1000, 4)]
    for model_name, D, layers, F, B, K in cases:
        _, prog, g = perturbed_program(model_name, D, layers, F, dev, SEED + D, K)
        stack = prog.stack
        flowpp = model_name == "flow++"
        mod = ff if flowpp else fs
        reference = ff.fused_flowpp_reference if flowpp else fs.fused_stack_reference
        x = torch.randn(B, D, generator=g, device=dev)
        inp = x
        for direction, name in zip(("forward", "inverse"), MODELS[model_name]):
            y, ld = mod.launch(stack, inp, direction == "inverse")
            torch.cuda.synchronize()
            yr, ldr = reference(stack.packed, stack.const_ld, inp, direction)
            if flowpp:
                # random weights make the inverse of a random latent
                # ill-conditioned (|d x / d z| up to e^21): invert the
                # forward's latent of x instead
                inp = yr
            ey = float((y - yr).abs().max())
            eld = float((ld - ldr).abs().max())
            print(f"check {name} D={D} n={layers} F={F}{f' K={K}' if flowpp else ''} B={B}: "
                  f"max|dz|={ey:.3e} max|dlogdet|={eld:.3e}")
            check(torch.isfinite(y).all() and torch.isfinite(ld).all(),
                  f"{name}: non-finite output")
            if flowpp and direction == "inverse":
                print(f"  plain round trip: max|x - inv(fwd(x))|="
                      f"{float((yr - x).abs().max()):.3e}")
                check(ey <= FLOWPP_INV_X_ATOL, f"{name}: x off by {ey}")
                check(eld <= FLOWPP_INV_LD_ATOL, f"{name}: logdet off by {eld}")
            else:
                check(torch.allclose(y, yr, **Z_TOL), f"{name} D={D}: z off by {ey}")
                check(eld <= LD_ATOL, f"{name} D={D}: logdet off by {eld}")
            errs[name] = max(errs[name], ey, eld)

    # ---- 4. the main path, through the entry points a user calls
    from nf_tpu_torch.config import NETWORK_DEFAULTS, NetworkConfig
    from nf_tpu_torch.models import build_model

    programs = {}
    launches = {}
    for model_name, (fwd_name, inv_name) in MODELS.items():
        cfg = NetworkConfig(name=model_name, **NETWORK_DEFAULTS[model_name])
        model = build_model(model_name, (2,), "2d", cfg)
        check(model.device.type == "cuda", "build_model did not default to the card")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = model.init(gen)
        if model_name != "realnvp":
            perturb(model, gen, dev)
        prog = model.eval_program(params)
        check(prog.stack is not None, f"{model_name} missed its fused kernel")
        x = torch.randn(BATCH, 2, generator=gen, device=dev)

        reset_all(counters)
        log_px = prog.log_prob(x)
        y_s, log_py = prog.sample(BATCH, gen)
        torch.cuda.synchronize()
        counts = launches_of()
        print(f"main path {model_name} launches: { {k: v for k, v in counts.items() if v} }")
        check(counts == {k: int(k in (fwd_name, inv_name)) for k in counts},
              f"{model_name}: expected one launch of its kernel per call, got {counts}")
        launches.update({fwd_name: counts[fwd_name], inv_name: counts[inv_name]})

        check(log_px.shape == (BATCH,) and y_s.shape == (BATCH, 2)
              and log_py.shape == (BATCH,), f"{model_name}: main path output shapes")
        for t, what in ((log_px, "log_prob"), (y_s, "sample"), (log_py, "sample log p")):
            check(bool(torch.isfinite(t).all()), f"{model_name} {what}: non-finite values")
        z, ld = prog.forward(x)
        xr, ldi = prog.inverse(z)
        rt = float((xr - x).abs().max())
        ld_sum = float((ld + ldi).abs().max())
        print(f"{model_name} round trip: max|x - inv(fwd(x))|={rt:.3e} "
              f"max|ld_fwd + ld_inv|={ld_sum:.3e}")
        rt_tol = FLOWPP_INV_X_ATOL if model_name == "flow++" else 1e-3
        ld_tol = FLOWPP_INV_LD_ATOL if model_name == "flow++" else 1e-3
        check(rt < rt_tol and ld_sum < ld_tol, f"{model_name}: round trip")
        with torch.no_grad():
            zc, ldc = model(x[:256])             # the eager chain, cuBLAS f32
        lp_small = float((prog.log_prob(x[:256])
                          - (standard_normal_logprob(zc) + ldc)).abs().max())
        print(f"{model_name} eager chain vs serving program, 256 samples: "
              f"max|dlog p|={lp_small:.3e} max|dz|={float((z[:256] - zc).abs().max()):.3e}")
        check(torch.allclose(z[:256], zc, **Z_TOL) and lp_small <= LD_ATOL,
              f"{model_name}: serving program disagrees with the eager chain")
        programs[model_name] = (prog, x, gen)

    # ---- 5. timing and bounds
    kernels = []
    for model_name, (prog, x, gen) in programs.items():
        stack = prog.stack
        flowpp = model_name == "flow++"
        mod = ff if flowpp else fs
        reference = ff.fused_flowpp_reference if flowpp else fs.fused_stack_reference
        zin = torch.randn(BATCH, 2, generator=gen, device=dev)
        for name, inv, inp in ((MODELS[model_name][0], False, x), (MODELS[model_name][1], True, zin)):
            direction = "inverse" if inv else "forward"
            work = flowpp_work(stack, inp, inv) if flowpp else stack_work(stack, BATCH)
            bound, bound_by = bound_of(work, sfu_per_s)
            ms = device_ms(lambda: mod.launch(stack, inp, inv), 200)
            plain = device_ms(lambda: reference(stack.packed, stack.const_ld, inp, direction),
                              PLAIN_ITERS)
            source, replaces = KERNEL_SOURCES[name]
            entry = {
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": errs[name],
                "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
                "library_ms": None,
                "library_note": "no single PyTorch call computes the whole stack",
                "f32_ms": work["flop"] / F32_FLOPS * 1e3,
                "sfu_ms": work["transcendental"] / sfu_per_s * 1e3,
                "bytes_ms": work["bytes"] / HBM_BYTES_PER_S * 1e3,
                "tf32_bound_ms": max(work["mac_flop"] / TF32_FLOPS,
                                     (work["flop"] - work["mac_flop"]) / F32_FLOPS,
                                     work["transcendental"] / sfu_per_s,
                                     work["bytes"] / HBM_BYTES_PER_S) * 1e3,
                "flop": work["flop"], "transcendental": work["transcendental"],
                "bytes": work["bytes"], "shape": [BATCH, 2],
                "couplings": stack.spec.n_repeats, "filters": stack.spec.filters,
            }
            if flowpp:
                entry.update(mixtures=stack.spec.n_mixtures,
                             mixture_evaluations=work["mixture_evaluations"],
                             warp_mixture_evaluations=work["warp_mixture_evaluations"])
            kernels.append(entry)
        t_fwd = wall_ms(lambda: prog.forward(x), 200)
        t_inv = wall_ms(lambda: prog.inverse(zin), 200)
        rate = BATCH / ((t_fwd + t_inv) / 1e3)
        busy = device_busy(lambda: (prog.forward(x), prog.inverse(zin)), 50)
        spec = stack.spec
        desc = (f"{model_name} 2d, {spec.n_repeats} couplings, F={spec.filters}"
                + (f", K={spec.n_mixtures}" if flowpp else ""))
        print(json.dumps({"main_path": {
            "model": desc, "batch": BATCH,
            "eval_program_forward_ms": t_fwd, "eval_program_inverse_ms": t_inv,
            "fwd_inv_samples_per_s": rate,
            "device_idle_share": None if busy is None else 1.0 - busy,
            "card": smi}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
