"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped without an NVIDIA card (the CPU has no CUDA
kernel to run).  On a machine with one:
``python -m pytest tests/test_torch_cuda_kernels.py -q``.
Tolerances as chip_smoke.py: z atol/rtol 1e-4, logdet atol 1e-3; the
Flow++ inverse x atol 1e-3, logdet atol 5e-3 (two Newton solves meet the
same root only within XTOL, compounded through the couplings); the ResFlow
inverse x and logdet atol 1e-3 (the kernel stops each fixed point per tile
of 32 samples, the plain version on the whole batch).
"""
import pytest
import torch

pytestmark = pytest.mark.cuda


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
                                          (5, 2, 128, 100), (2, 2, 256, 70)])
def test_fused_stack_kernel_matches_plain(cuda, name, D, layers, F, B):
    from nf_tpu_torch.ops.cuda import fused_stack as fs

    prog, g = _program(D, layers, F, 0, cuda, name)
    assert prog.stack.spec.has_mix == (name == "glow")
    x = torch.randn(B, D, generator=g, device=cuda)
    for direction in ("forward", "inverse"):
        y, ld = fs.fused_stack(prog.stack, x, direction)
        torch.cuda.synchronize()
        yr, ldr = fs.fused_stack_reference(prog.stack.packed, prog.stack.const_ld,
                                           x, direction)
        torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(ld, ldr, atol=1e-3, rtol=0)


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
                                          (2, 3, 128, 300), (8, 2, 100, 70)])
def test_fused_resflow_kernel_matches_plain(cuda, D, layers, F, B):
    from nf_tpu_torch.nets.spectral import LipSwish
    from nf_tpu_torch.ops.cuda import fused_resflow as rf

    prog, g = _program(D, layers, F, 0, cuda, "resflow")
    with torch.no_grad():
        for m in prog.model.modules():
            if isinstance(m, LipSwish):
                m.beta.copy_(0.5 + torch.rand(1, generator=g, device=cuda))
    prog = prog.model.eval_program()
    st = prog.stack
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


def test_resflow_past_the_kernels_tilings_raises(cuda):
    with pytest.raises(NotImplementedError, match="F = 256"):
        _program(2, 2, 256, 0, cuda, "resflow")


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
