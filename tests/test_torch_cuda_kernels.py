"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped without an NVIDIA card (the CPU has no CUDA
kernel to run).  On a machine with one:
``python -m pytest tests/test_torch_cuda_kernels.py -q``.
Tolerances as chip_smoke.py: z atol/rtol 1e-4, logdet atol 1e-3 (the
fused stack also at D past its FFMA block's widest tiling); the
Flow++ inverse x atol 1e-3, logdet atol 5e-3 (two Newton solves meet the
same root only within XTOL, compounded through the couplings); the ResFlow
inverse x and logdet atol 1e-3 (the kernels stop each fixed point per tile
of 16 samples, the solve up to F = 64 per warp of 8, the plain version on
the whole batch).  The coupling
kernels: y, x, gz0 and graw atol / rtol 1e-5, the row log-dets atol 1e-4
(up to 1536 terms summed in another order), dgain and dbias rtol 1e-4
(B x N terms), the backward one launch and the same bits on every run;
under torch.utils.checkpoint the same gradients bit for bit, the ticket
reset.
Attention: out atol / rtol 1e-5 against the plain version (and
PyTorch's SDPA) at D = 2 to 2048 and L = 2 to 1500 (past D = 128 the
wide kernel, past 1024 in column groups), its gradient through the
Function 1e-5; GatedAttn at base_filters 8192 against the CPU 1e-4.  The
wide paths: the stack's cluster kernel at D = 63 to 6000 (its x tiles in
device memory from Glow D = 1300 at F = 256), the ResFlow
wide kernel at (D, F) = (2, 512) and (16, 64), all three variants, at the
tolerances above.  The
mixture-CDF inverse: x atol / rtol 1e-4 against the plain version and
1e-3 against the x that made y, the log-det atol 1e-3 (up to 1500 terms
in another order), as nf_tpu's tests/test_pallas.py holds its kernel, at
K = 1 to 64 and rows of up to 2100 elements; two launches give the same
bits.
"""
from collections import Counter

import pytest
import torch

from nf_tpu_torch.utils.tracing import recording

pytestmark = pytest.mark.cuda


def _paths(spans) -> Counter:
    """{kernel path: launches} of a recording's launch spans
    (``launch.<LAUNCHES key>.<path>``)."""
    return Counter(name.rsplit(".", 1)[1] for name in spans.counts("launch.").elements())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _program(D, layers, F, seed, device, name="realnvp", K=8, logdet="unbias"):
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model

    model = build_model(name, (D,), "2d",
                        NetworkConfig(layers=layers, base_filters=F, mixtures=K, logdet=logdet),
                        device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    model.init(g)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            # ActNorm shift and log-scale off identity
            if pname.endswith((".log_scale", ".bias")) and p.dim() == 1 and p.numel() == D:
                p.copy_(0.3 * torch.randn(p.shape, generator=g, device=device))
        for bname, buf in model.named_buffers():
            if bname.endswith("running_mean"):
                buf.copy_(0.3 * torch.randn(buf.shape, generator=g, device=device))
            elif bname.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g, device=device))
    return model.eval_program(), g


@pytest.mark.parametrize("name", ["realnvp", "glow"])
@pytest.mark.parametrize("D,layers,F,B", [(2, 4, 8, 300), (2, 4, 32, 1024),
                                          (3, 4, 32, 777), (3, 4, 64, 1000),
                                          (5, 2, 128, 100), (2, 2, 256, 70),
                                          (2, 32, 32, 8192)])
def test_fused_stack_kernel_matches_plain(cuda, name, D, layers, F, B):
    """Every case runs the kernel its shape picks (the tensor-core kernel up
    to F = 64, the FFMA kernel past it); (2, 32, 32, 8192) is the
    headline."""
    from nf_tpu_torch.ops.cuda import fused_stack as fs

    prog, g = _program(D, layers, F, 0, cuda, name)
    assert prog.stack.spec.has_mix == (name == "glow")
    assert prog.stack.variant == fs.kernel_variant(D, F)
    assert isinstance(prog.stack.kernel, fs.MmaWeights if F <= 64 else fs.FfmaWeights)
    x = torch.randn(B, D, generator=g, device=cuda)
    for direction in ("forward", "inverse"):
        y, ld = fs.fused_stack(prog.stack, x, direction)
        torch.cuda.synchronize()
        yr, ldr = fs.fused_stack_reference(prog.stack.packed, prog.stack.const_ld,
                                           x, direction)
        torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(ld, ldr, atol=1e-3, rtol=0)


@pytest.mark.parametrize("name,D,F", [("realnvp", 213, 32), ("glow", 111, 32),
                                      ("realnvp", 117, 64), ("realnvp", 29, 256),
                                      ("glow", 27, 256), ("glow", 80, 64), ("glow", 63, 128)])
def test_fused_stack_narrow_tiling_matches_plain(cuda, name, D, F):
    """Stacks whose FFMA block at TILES' sample count passes the shared
    memory run the 16-sample tiling, or at CLUSTER_PAST_TILES' widths
    (RealNVP F = 32, Glow up to 128) the cluster kernel."""
    from nf_tpu_torch.ops.cuda import fused_stack as fs

    prog, g = _program(D, 2, F, 0, cuda, name)
    cluster = fs.padded_width(F) in fs.CLUSTER_PAST_TILES[name == "glow"]
    assert (prog.stack.kernel.path, prog.stack.kernel.tile) == (
        ("ffma_cluster", (48, fs.CLUSTER)) if cluster else ("ffma_narrow", fs.NARROW_TILE))
    x = torch.randn(300, D, generator=g, device=cuda)
    for direction in ("forward", "inverse"):
        y, ld = fs.fused_stack(prog.stack, x, direction)
        torch.cuda.synchronize()
        yr, ldr = fs.fused_stack_reference(prog.stack.packed, prog.stack.const_ld,
                                           x, direction)
        torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(ld, ldr, atol=1e-3, rtol=0)


@pytest.mark.parametrize("name,D,F", [("realnvp", 400, 32), ("glow", 400, 32),
                                      ("realnvp", 1024, 32), ("realnvp", 400, 256),
                                      ("realnvp", 63, 256), ("glow", 1024, 32),
                                      ("glow", 1024, 256), ("glow", 4096, 32),
                                      ("glow", 1300, 256), ("realnvp", 6000, 32)])
def test_fused_stack_cluster_kernel_matches_plain(cuda, name, D, F):
    """Past both FFMA tilings the cluster kernel runs the stack (48 samples
    a cluster of 4 blocks, 32 for Glow at D = 1024 and 16 at F = 256; past
    the D whose member fits at 16 samples, Glow on flattened 64 x 64
    images among them, the x tiles in device memory at 48; 300 samples:
    the last cluster ragged): one launch per direction, against the plain
    version (the log-det at D = 1,300 and past, a sum of thousands of
    terms of up to about 2,000 in all, also within rtol 1e-6)."""
    from nf_tpu_torch.ops.cuda import fused_stack as fs

    prog, g = _program(D, 2, F, 0, cuda, name)
    path, tile = fs.ffma_plan(D, F, name == "glow")
    assert path == ("ffma_cluster_spill" if D >= 1300 else "ffma_cluster")
    assert (prog.stack.kernel.path, prog.stack.kernel.tile) == (path, tile)
    x = torch.randn(300, D, generator=g, device=cuda)
    for direction in ("forward", "inverse"):
        fs.reset_launches()
        with recording() as spans:
            y, ld = fs.fused_stack(prog.stack, x, direction)
        torch.cuda.synchronize()
        assert _paths(spans) == {path: 1}
        yr, ldr = fs.fused_stack_reference(prog.stack.packed, prog.stack.const_ld,
                                           x, direction)
        torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(ld, ldr, atol=1e-3, rtol=1e-6 if D >= 1300 else 0)


def test_fused_stack_headline_fills_the_card(cuda):
    """B = 8192, F = 32, D = 2: 128 blocks of 4 consumer warps, all
    resident at once (one wave)."""
    from nf_tpu_torch.ops.cuda import fused_stack as fs

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in ("realnvp", "glow"):
        prog, _ = _program(2, 4, 32, 0, cuda, name)
        for inverse in (False, True):
            per_sm = fs.mma_blocks_per_sm(prog.stack.kernel, name == "glow", inverse)
            assert per_sm >= 1 and -(-8192 // fs.MMA_SAMPLES) <= per_sm * sms


@pytest.mark.parametrize("layers,F,K,B", [(4, 8, 4, 300), (4, 32, 8, 1024),
                                          (4, 20, 3, 777), (4, 64, 4, 1000),
                                          (2, 64, 12, 130), (2, 128, 32, 70)])
def test_fused_flowpp_kernel_matches_plain(cuda, layers, F, K, B):
    from nf_tpu_torch.ops.cuda import fused_flowpp as ff

    prog, g = _program(2, layers, F, 0, cuda, "flow++", K)
    x = 1.5 * torch.randn(B, 2, generator=g, device=cuda)
    for direction, z_tol, ld_tol in (("forward", 1e-4, 1e-3), ("inverse", 1e-3, 5e-3)):
        y, ld = ff.fused_flowpp(prog.stack, x, direction)
        torch.cuda.synchronize()
        yr, ldr = ff.fused_flowpp_reference(prog.stack.packed, prog.stack.const_ld,
                                            x, direction)
        torch.testing.assert_close(y, yr, atol=z_tol, rtol=1e-4)
        torch.testing.assert_close(ld, ldr, atol=ld_tol, rtol=0)


@pytest.mark.parametrize("D,layers,F,B", [(2, 4, 8, 300), (2, 6, 32, 1024), (3, 4, 20, 777),
                                          (3, 4, 64, 1000), (8, 2, 64, 100), (5, 3, 16, 33),
                                          (2, 3, 128, 300), (8, 2, 100, 70),
                                          (2, 3, 256, 300), (8, 2, 200, 45),
                                          (2, 4, 32, 8192)])
def test_fused_resflow_kernel_matches_plain(cuda, D, layers, F, B):
    """The solve runs the warp-per-8-samples kernel up to F = 64 and
    variant 0 (16-sample tiles) at F = 128 and 256."""
    from nf_tpu_torch.nets.spectral import LipSwish
    from nf_tpu_torch.ops.cuda import fused_resflow as rf

    prog, g = _program(D, layers, F, 0, cuda, "resflow")
    with torch.no_grad():
        for m in prog.model.modules():
            if isinstance(m, LipSwish):
                m.beta.copy_(0.5 + torch.rand(1, generator=g, device=cuda))
    prog = prog.model.eval_program()
    st = prog.stack
    assert rf.solve_kernel(st.kernel.fp) == ("warp" if F <= 64 else "tile")
    x = torch.randn(B, D, generator=g, device=cuda)
    probes = rf.draw_unbias_probes(B, D, g)
    z, ld = rf.fused_resflow(st, x, "forward", probes)
    torch.cuda.synchronize()
    zr, ldr = rf.fused_resflow_fwd_logdet_reference(st.spec, st.packed, x, probes)
    torch.testing.assert_close(z, zr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ld, ldr, atol=1e-3, rtol=0)
    xi, ldi = rf.fused_resflow(st, zr, "inverse", probes)
    xs = rf.fused_resflow(st, zr, "solve")
    torch.cuda.synchronize()
    xr, ldir = rf.fused_resflow_solve_logdet_reference(st.spec, st.packed, zr, probes)
    torch.testing.assert_close(xi, xr, atol=1e-3, rtol=0)
    torch.testing.assert_close(ldi, ldir, atol=1e-3, rtol=0)
    torch.testing.assert_close(xs, xr, atol=1e-3, rtol=0)


def test_resflow_main_path_launch_puts_8_warps_on_every_sm(cuda):
    """B = 8192, F = 32, D = 2: the series kernels' blocks fit the card in
    one wave, dealt evenly at least two to an SM (8 warps); the solve
    kernel's 256 blocks (a warp per 8 samples) fit in one wave with at least
    one block on every SM."""
    from nf_tpu_torch.ops.cuda import fused_resflow as rf

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-8192 // rf.SAMPLES)
    for direction in ("forward", "inverse"):
        per_sm = rf.blocks_per_sm(32, 2, direction)
        assert blocks <= per_sm * sms
        assert rf.WARPS * min(per_sm, blocks // sms) >= 8
    blocks = rf.solve_blocks(8192)
    assert sms <= blocks <= rf.solve_blocks_per_sm(32, 2) * sms


@pytest.mark.parametrize("D,F,B", [(2, 512, 300), (16, 64, 300), (9, 8, 45), (2, 2048, 50),
                                   (2, 512, 1000), (16, 64, 1000), (2, 512, 8192),
                                   (16, 64, 8192), (2, 288, 1000)])
def test_resflow_wide_kernel_matches_plain(cuda, D, F, B):
    """Past F = 256 or D = 8 the wide kernel runs all three variants,
    against the plain versions, at wide_plan's plan: (2, 512) and (2, 2048)
    on clusters of 2 reading W2t's slabs from L2 ((2, 2048): the vectors in
    device scratch), (16, 64) and (9, 8) one block holding all of W2t,
    (2, 288) clusters of 2 each holding its slab of W2t (the members' bulk
    copies at their own offsets, the partials summed through distributed
    shared memory); B = 1,000 leaves a ragged last cluster."""
    from nf_tpu_torch.ops.cuda import fused_resflow as rf

    prog, g = _program(D, 2, F, 0, cuda, "resflow")
    st = prog.stack
    assert rf.kernel_path(st.spec) == "wide" and isinstance(st.kernel, rf.WideWeights)
    plan = rf.wide_plan(F, D, B, cluster=st.kernel.cluster)
    want = {(2, 512): "streamed", (16, 64): "one block", (9, 8): "one block",
            (2, 2048): "streamed", (2, 288): "cluster"}[(D, F)]
    assert plan.residency == want and plan.smem_bytes <= rf.SMEM_LIMIT
    x = torch.randn(B, D, generator=g, device=cuda)
    probes = rf.draw_unbias_probes(B, D, g)
    rf.reset_launches()
    with recording() as spans:
        z, ld = rf.fused_resflow(st, x, "forward", probes)
        torch.cuda.synchronize()
        zr, ldr = rf.fused_resflow_fwd_logdet_reference(st.spec, st.packed, x, probes)
        torch.testing.assert_close(z, zr, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(ld, ldr, atol=1e-3, rtol=0)
        xi, ldi = rf.fused_resflow(st, zr, "inverse", probes)
        xs = rf.fused_resflow(st, zr, "solve")
    torch.cuda.synchronize()
    assert _paths(spans) == {"wide": 3}
    xr, ldir = rf.fused_resflow_solve_logdet_reference(st.spec, st.packed, zr, probes)
    torch.testing.assert_close(xi, xr, atol=1e-3, rtol=0)
    torch.testing.assert_close(ldi, ldir, atol=1e-3, rtol=0)
    torch.testing.assert_close(xs, xr, atol=1e-3, rtol=0)


@pytest.mark.parametrize("name,fwd,inv", [
    ("realnvp", "fused_stack_fwd", "fused_stack_inv"),
    ("glow", "fused_stack_glow_fwd", "fused_stack_glow_inv"),
    ("flow++", "fused_flowpp_fwd", "fused_flowpp_inv"),
    ("resflow", "fused_resflow_fwd_ld", "fused_resflow_solve_ld")])
def test_eval_program_is_one_launch_per_call(cuda, name, fwd, inv):
    from nf_tpu_torch.ops.cuda import fused_flowpp as ff
    from nf_tpu_torch.ops.cuda import fused_resflow as rf
    from nf_tpu_torch.ops.cuda import fused_stack as fs

    prog, g = _program(2, 4, 32, 1, cuda, name)
    x = torch.randn(512, 2, generator=g, device=cuda)
    for mod in (fs, ff, rf):
        mod.reset_launches()
    prog.log_prob(x)
    prog.sample(512, g)
    torch.cuda.synchronize()
    counts = {k: v for k, v in {**fs.LAUNCHES, **ff.LAUNCHES, **rf.LAUNCHES}.items() if v}
    assert counts == {fwd: 1, inv: 1}


def test_resflow_exact_inverse_is_one_solve_launch(cuda):
    from nf_tpu_torch.ops.cuda import fused_resflow as rf

    prog, g = _program(2, 4, 32, 2, cuda, "resflow", logdet="exact")
    x = torch.randn(512, 2, generator=g, device=cuda)
    rf.reset_launches()
    z, ld = prog.forward(x)
    xr, ldi = prog.inverse(z)
    torch.cuda.synchronize()
    assert {k: v for k, v in rf.LAUNCHES.items() if v} == {"fused_resflow_solve": 1}
    torch.testing.assert_close(xr, x, atol=1e-3, rtol=0)
    torch.testing.assert_close(ldi, -ld, atol=1e-3, rtol=0)


@pytest.mark.parametrize("B,N", [(1024, 512), (1000, 384), (3, 128), (77, 1536)])
def test_coupling_kernels_match_plain(cuda, B, N):
    from nf_tpu_torch.ops.cuda import coupling as tc

    g = torch.Generator(device=cuda).manual_seed(B + N)
    z0, t, raw, gy = (torch.randn(B, N, generator=g, device=cuda) for _ in range(4))
    gld = torch.randn(B, generator=g, device=cuda)
    gain = torch.tensor([0.7], device=cuda)
    bias = torch.tensor([-0.1], device=cuda)
    y, ld = tc.launch(z0, t, raw, gain, bias, inverse=False)
    x, ldi = tc.launch(y, t, raw, gain, bias, inverse=True)
    gz0, graw, dgain, dbias = tc.launch_bwd(z0, raw, gain, bias, gy, gld)
    torch.cuda.synchronize()
    yr, ldr = tc.coupling_fwd_reference(z0, t, raw, gain, bias)
    xr, ldir = tc.coupling_inv_reference(y, t, raw, gain, bias)
    gz0r, gtr, grawr, dgainr, dbiasr = tc.coupling_bwd_reference(z0, raw, gain, bias, gy, gld)
    torch.testing.assert_close(y, yr, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(ld, ldr, atol=1e-4, rtol=0)
    torch.testing.assert_close(x, xr, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(ldi, ldir, atol=1e-4, rtol=0)
    torch.testing.assert_close(x, z0, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(gz0, gz0r, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(graw, grawr, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dgain, dgainr, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(dbias, dbiasr, atol=1e-3, rtol=1e-4)


def test_coupling_backward_is_deterministic(cuda):
    from nf_tpu_torch.ops.cuda import coupling as tc

    g = torch.Generator(device=cuda).manual_seed(0)
    z0, raw, gy = (torch.randn(1024, 512, generator=g, device=cuda) for _ in range(3))
    gld = torch.randn(1024, generator=g, device=cuda)
    gain, bias = torch.tensor([0.7], device=cuda), torch.tensor([-0.1], device=cuda)
    first = tc.launch_bwd(z0, raw, gain, bias, gy, gld)
    for _ in range(3):
        for a, b in zip(first, tc.launch_bwd(z0, raw, gain, bias, gy, gld)):
            assert torch.equal(a, b)


def test_coupling_backward_is_one_launch(cuda):
    """launch_bwd runs exactly one kernel per call, including the fold of
    dgain and dbias: 5 calls captured in a CUDA graph are 5 kernel nodes
    (chip_smoke.kernels_per_call), and the wrapper counted its own kernel
    at each."""
    from chip_smoke import kernels_per_call
    from nf_tpu_torch.ops.cuda import coupling as tc

    g = torch.Generator(device=cuda).manual_seed(1)
    z0, raw, gy = (torch.randn(1024, 512, generator=g, device=cuda) for _ in range(3))
    gld = torch.randn(1024, generator=g, device=cuda)
    gain, bias = torch.tensor([0.7], device=cuda), torch.tensor([-0.1], device=cuda)
    calls = 5
    tc.reset_launches()
    assert kernels_per_call(lambda: tc.launch_bwd(z0, raw, gain, bias, gy, gld), calls) == 1
    assert tc.LAUNCHES["coupling_bwd"] == calls + 1


def test_coupling_autograd_on_the_card_matches_the_cpu(cuda):
    from nf_tpu_torch.ops.cuda import coupling as tc

    g = torch.Generator().manual_seed(3)
    cpu = [torch.randn(64, 256, generator=g) for _ in range(3)] + [
        torch.tensor([0.7]), torch.tensor([-0.1])]
    grads = []
    for dev in ("cpu", cuda):
        leaves = [a.detach().to(dev).requires_grad_() for a in cpu]
        y, ld = tc.coupling_fwd(*leaves)
        (y.square().sum() + 3.0 * ld.sum()).backward()
        grads.append([a.grad.cpu() for a in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


def test_coupling_kernels_under_checkpoint_match_and_reset_the_ticket(cuda):
    """torch.utils.checkpoint (non-reentrant, as remat runs it) over the
    coupling kernels: the same gradients bit for bit as without it, the
    forward kernel launched twice (the pass and its recompute) and the
    backward once, and the backward's ticket left at 0."""
    from torch.utils.checkpoint import checkpoint

    from nf_tpu_torch.ops.cuda import coupling as tc

    g = torch.Generator(device=cuda).manual_seed(5)
    base = [torch.randn(256, 512, generator=g, device=cuda) for _ in range(3)] + [
        torch.tensor([0.7], device=cuda), torch.tensor([-0.1], device=cuda)]

    def step(remat):
        leaves = [a.detach().clone().requires_grad_() for a in base]

        def f(*xs):
            y, ld = tc.coupling_fwd(*xs)
            return y.square().sum() + 3.0 * ld.sum()

        loss = checkpoint(f, *leaves, use_reentrant=False) if remat else f(*leaves)
        loss.backward()
        return [a.grad for a in leaves]

    plain = step(False)
    tc.reset_launches()
    got = step(True)
    torch.cuda.synchronize()
    assert tc.LAUNCHES["coupling_fwd"] == 2 and tc.LAUNCHES["coupling_bwd"] == 1
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    ticket = tc._ticket(base[0].device, torch.cuda.current_stream().cuda_stream)
    assert int(ticket.item()) == 0


def test_image_realnvp_launches_161_per_pass(cuda):
    """realnvp-img32x1: one coupling_fwd per coupling per forward, one
    coupling_bwd per coupling per train step, one coupling_inv per
    coupling per inverse, and no other kernel of the port."""
    from nf_tpu_torch.config import NetworkConfig, OptimizerConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.ops.cuda import coupling as tc
    from nf_tpu_torch.ops.cuda import fused_flowpp as ff
    from nf_tpu_torch.ops.cuda import fused_resflow as rf
    from nf_tpu_torch.ops.cuda import fused_stack as fs
    from nf_tpu_torch.train import Trainer

    def counts():
        return {k: v for k, v in {**fs.LAUNCHES, **ff.LAUNCHES, **rf.LAUNCHES,
                                  **tc.LAUNCHES}.items() if v}

    def reset():
        for mod in (fs, ff, rf, tc):
            mod.reset_launches()

    model = build_model("realnvp", (32, 32, 1), "image", NetworkConfig())
    g = torch.Generator(device=cuda).manual_seed(0)
    batch = 0.05 + 0.9 * torch.rand(2, 8, 32, 32, 1, generator=g, device=cuda)
    tr = Trainer(model, OptimizerConfig(), seed=0)
    reset()
    ts = tr.init_state(batch[0])
    assert counts() == {"coupling_fwd": 161}
    reset()
    ts, losses = tr.train_steps(ts, batch)
    assert counts() == {"coupling_fwd": 322, "coupling_bwd": 322}
    assert torch.isfinite(losses).all()
    prog = model.eval_program()
    reset()
    prog.log_prob(batch[0])
    assert counts() == {"coupling_fwd": 161}
    reset()
    y, log_py = prog.sample(8, g)
    torch.cuda.synchronize()
    assert counts() == {"coupling_inv": 161}
    assert torch.isfinite(log_py).all()


def test_image_glow_launches_161_per_pass(cuda):
    """glow-img32x3: the coupling kernels as realnvp-img32x1's, and no other
    kernel of the port (the 1x1 convs and ActNorms are ATen ops)."""
    from nf_tpu_torch.config import NetworkConfig, OptimizerConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.ops.cuda import coupling as tc
    from nf_tpu_torch.ops.cuda import fused_stack as fs
    from nf_tpu_torch.train import Trainer

    def counts():
        return {k: v for k, v in {**fs.LAUNCHES, **tc.LAUNCHES}.items() if v}

    def reset():
        fs.reset_launches()
        tc.reset_launches()

    model = build_model("glow", (32, 32, 3), "image", NetworkConfig(name="glow"))
    g = torch.Generator(device=cuda).manual_seed(0)
    batch = 0.05 + 0.9 * torch.rand(2, 8, 32, 32, 3, generator=g, device=cuda)
    tr = Trainer(model, OptimizerConfig(), seed=0)
    reset()
    ts = tr.init_state(batch[0])
    assert counts() == {"coupling_fwd": 161}
    reset()
    ts, losses = tr.train_steps(ts, batch)
    assert counts() == {"coupling_fwd": 322, "coupling_bwd": 322}
    assert torch.isfinite(losses).all()
    prog = model.eval_program()
    reset()
    y, log_py = prog.sample(8, g)
    torch.cuda.synchronize()
    assert counts() == {"coupling_inv": 161} and torch.isfinite(log_py).all()


@pytest.mark.parametrize("name", ["maf", "planar"])
def test_maf_and_planar_launch_no_kernel(cuda, name):
    """MAF and Planar serve through the eager chain, as nf_tpu runs no
    Pallas kernel for them; log p as the same state's on the CPU."""
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.ops.cuda import coupling as tc
    from nf_tpu_torch.ops.cuda import fused_stack as fs

    model = build_model(name, (2,), "2d", NetworkConfig(name=name, layers=4))
    g = torch.Generator(device=cuda).manual_seed(0)
    prog = model.eval_program(model.init(g))
    x = torch.randn(1000, 2, generator=g, device=cuda)
    fs.reset_launches()
    tc.reset_launches()
    lp = prog.log_prob(x)
    y, _ = prog.sample(1000, g)
    torch.cuda.synchronize()
    assert not any({**fs.LAUNCHES, **tc.LAUNCHES}.values()) and torch.isfinite(y).all()
    cpu = build_model(name, (2,), "2d", NetworkConfig(name=name, layers=4), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    torch.testing.assert_close(lp.cpu(), cpu.eval_program().log_prob(x.cpu()), atol=1e-4,
                               rtol=0)


def test_matmul_precision_on_the_card(cuda):
    """build_model turns TF32 off on the card; matmul_precision="bfloat16"
    builds an image model (nf_tpu sets XLA's default the same way) and
    sets the process's precision, which is set back to f32 after, so the
    tests that follow compare f32 products."""
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.ops import precision as pm

    torch.backends.cudnn.allow_tf32 = True
    build_model("realnvp", (2,), "2d", NetworkConfig(layers=2, base_filters=8))
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    try:
        build_model("realnvp", (16, 16, 1), "image",
                    NetworkConfig(layers=1, matmul_precision="bfloat16"))
        assert pm.matmul_precision() == "bfloat16"
    finally:
        pm.set_matmul_precision(None)


@pytest.mark.parametrize("BH,L,D", [(4096, 256, 8), (4096, 64, 8), (4096, 16, 8), (1000, 49, 8),
                                    (64, 100, 32), (33, 300, 64), (70, 16, 2), (10, 1024, 4),
                                    (5, 2, 16), (192, 256, 12), (64, 1500, 8), (64, 100, 128),
                                    (4, 16, 6), (2, 1025, 8), (3, 8, 128), (64, 256, 192),
                                    (64, 64, 512), (3, 40, 1000)])
def test_attention_kernel_matches_plain(cuda, BH, L, D):
    import torch.nn.functional as F

    from nf_tpu_torch.ops import attention as ta
    from nf_tpu_torch.ops.cuda import attention as ca

    g = torch.Generator(device=cuda).manual_seed(BH + L + D)
    q, k, v = (torch.randn(BH, L, D, generator=g, device=cuda) for _ in range(3))
    out = ca.launch(q, k, v)
    torch.cuda.synchronize()
    want = ta.attention_reference(q, k, v)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(F.scaled_dot_product_attention(q, k, v), want, atol=1e-5,
                               rtol=1e-5)


def test_attention_gradient_through_the_function(cuda):
    from nf_tpu_torch.ops import attention as ta

    g = torch.Generator(device=cuda).manual_seed(7)
    base = [torch.randn(96, 64, 8, generator=g, device=cuda) for _ in range(4)]
    grads = []
    for fn in (ta.attention, ta.attention_reference):
        leaves = [t.clone().requires_grad_() for t in base[:3]]
        (fn(*leaves) * base[3]).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,N,K", [(1024, 512, 8), (1000, 300, 5), (7, 64, 32), (3, 1500, 12),
                                   (300, 200, 1), (64, 256, 33), (256, 512, 64), (5, 2100, 8)])
def test_mix_log_cdf_inverse_kernel_matches_plain(cuda, B, N, K):
    from nf_tpu_torch.bijectors import mixlogcdf as mlc
    from nf_tpu_torch.ops.cuda import mixlogcdf as cm

    g = torch.Generator(device=cuda).manual_seed(B + N + K)
    x = 2.0 * torch.randn(B, N, generator=g, device=cuda)
    logpi = torch.log_softmax(torch.randn(B, N, K, generator=g, device=cuda), dim=-1)
    mu = torch.randn(B, N, K, generator=g, device=cuda)
    s = 0.3 * torch.randn(B, N, K, generator=g, device=cuda)
    y, _ = mlc.mix_log_cdf_forward(x, logpi, mu, s)
    xk, ldk = cm.launch(y, logpi, mu, s)
    torch.cuda.synchronize()
    xr, ldr = mlc.mix_log_cdf_inverse_reference(y, logpi, mu, s)
    torch.testing.assert_close(xk, xr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ldk, ldr, atol=1e-3, rtol=0)
    # the round trip where f32 keeps x: a y rounded next to 0 or 1 loses x
    # where the mixture's tail is thin, for the plain version alike (at
    # K = 1 on a few elements in 10^4); past K = 1 on every element
    kept = (xr - x).abs() <= 1e-3
    assert bool(kept.all()) or (K == 1 and float(kept.float().mean()) >= 0.999)
    torch.testing.assert_close(xk[kept], x[kept], atol=1e-3, rtol=0)
    again = cm.launch(y, logpi, mu, s)
    assert torch.equal(again[0], xk) and torch.equal(again[1], ldk)


def test_mix_log_cdf_inverse_has_no_gradient(cuda):
    from nf_tpu_torch.bijectors import mixlogcdf as mlc

    g = torch.Generator(device=cuda).manual_seed(1)
    y = torch.rand(4, 128, generator=g, device=cuda).requires_grad_()
    logpi = torch.log_softmax(torch.randn(4, 128, 8, generator=g, device=cuda), dim=-1)
    mu, s = (torch.randn(4, 128, 8, generator=g, device=cuda) for _ in range(2))
    x, ld = mlc.mix_log_cdf_inverse(y, logpi, mu, s)
    with pytest.raises(NotImplementedError, match="no gradient"):
        (x.sum() + ld.sum()).backward()


def test_attention_past_128_matches_plain_and_other_dtypes_raise(cuda):
    """Past D = 128 the wide kernel runs at each of its tilings, and past
    1,024 in column groups (D = 2,048: GatedAttn at base_filters 8,192;
    1,030 ragged and off the 16-byte copies), against the plain version; a
    dtype the kernels do not take raises, with no launch counted."""
    from nf_tpu_torch.ops import attention as ta
    from nf_tpu_torch.ops.cuda import attention as ca
    from nf_tpu_torch.ops.cuda import mixlogcdf as cm

    ca.reset_launches()
    cm.reset_launches()
    g = torch.Generator(device=cuda).manual_seed(129)
    with recording() as spans:
        for BH, L, D in ((4, 16, 129), (64, 256, 192), (64, 64, 512), (3, 40, 130),
                         (5, 1, 200), (8, 64, 2048), (3, 33, 1030)):
            q, k, v = (torch.randn(BH, L, D, generator=g, device=cuda) for _ in range(3))
            out = ta.attention(q, k, v)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ta.attention_reference(q, k, v), atol=1e-5,
                                       rtol=1e-5)
    assert _paths(spans) == {"wide": 6}   # one token returns v
    with pytest.raises(ValueError, match="float32"):
        ca.launch(*(torch.randn(4, 16, 8, device=cuda, dtype=torch.float64),) * 3)
    assert ca.LAUNCHES == {"attention_fwd": 6} and cm.LAUNCHES == {"mix_log_cdf_inverse": 0}


def test_gated_attention_past_1024_columns_trains_on_the_card(cuda):
    """GatedAttn at base_filters 8,192 (4 heads of D = 2,048, the wide
    kernel's column groups): its output and its gradients on the card
    against the same module on the CPU, atol / rtol 1e-4."""
    import copy

    from nf_tpu_torch.nets.gated import GatedAttn
    from nf_tpu_torch.ops.cuda import attention as ca

    net = GatedAttn((4, 4, 8), filters=8192, device=cuda)
    net.init(torch.Generator(device=cuda).manual_seed(8))
    cpu = copy.deepcopy(net).cpu()
    x = torch.randn(2, 4, 4, 8, generator=torch.Generator(device=cuda).manual_seed(9),
                    device=cuda)
    ca.reset_launches()
    with recording() as spans:
        y = net(x)
        y.square().sum().backward()
    torch.cuda.synchronize()
    assert _paths(spans) == {"wide": 1}
    yc = cpu(x.cpu())
    yc.square().sum().backward()
    torch.testing.assert_close(y.detach().cpu(), yc.detach(), atol=1e-4, rtol=1e-4)
    for (name, p), pc in zip(net.named_parameters(), cpu.parameters()):
        torch.testing.assert_close(p.grad.cpu(), pc.grad, atol=1e-4, rtol=1e-4, msg=name)


def test_image_flowpp_launches_only_attention(cuda, monkeypatch):
    """flowpp-img32x1 through EvalProgram's eager chain: one attention_fwd
    per coupling per pass (64 / 64 / 33 over L = 256 / 64 / 16) and no
    other kernel of the port."""
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.ops.cuda import attention as ca
    from nf_tpu_torch.ops.cuda import coupling as tc
    from nf_tpu_torch.ops.cuda import fused_flowpp as ff
    from nf_tpu_torch.ops.cuda import fused_resflow as rf
    from nf_tpu_torch.ops.cuda import fused_stack as fs
    from nf_tpu_torch.ops.cuda import mixlogcdf as cm

    mods = (fs, ff, rf, tc, ca, cm)

    def counts():
        return {k: v for m in mods for k, v in m.LAUNCHES.items() if v}

    model = build_model("flow++", (32, 32, 1), "image", NetworkConfig(name="flow++"))
    g = torch.Generator(device=cuda).manual_seed(0)
    prog = model.eval_program(model.init(g))
    assert prog.stack is None
    x = 0.05 + 0.9 * torch.rand(8, 32, 32, 1, generator=g, device=cuda)
    by_len, launch = Counter(), ca.launch

    def counting(q, k, v):
        by_len[q.shape[1]] += 1
        return launch(q, k, v)

    monkeypatch.setattr(ca, "launch", counting)
    for call in (lambda: prog.log_prob(x), lambda: prog.sample(8, g)):
        for m in mods:
            m.reset_launches()
        by_len.clear()
        out = call()
        torch.cuda.synchronize()
        assert counts() == {"attention_fwd": 161}
        assert by_len == {256: 64, 64: 64, 16: 33}
        assert all(torch.isfinite(t).all() for t in (out if isinstance(out, tuple) else (out,)))
