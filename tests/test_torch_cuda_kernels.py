"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped without an NVIDIA card (the CPU has no CUDA
kernel to run).  On a machine with one:
``python -m pytest tests/test_torch_cuda_kernels.py -q``.
Tolerances as chip_smoke.py: z atol/rtol 1e-4, logdet atol 1e-3.
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


def _program(D, layers, F, seed, device):
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model

    model = build_model("realnvp", (D,), "2d",
                        NetworkConfig(layers=layers, base_filters=F), device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    model.init(g)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.3 * torch.randn(buf.shape, generator=g, device=device))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g, device=device))
    return model.eval_program(), g


@pytest.mark.parametrize("D,layers,F,B", [(2, 4, 8, 300), (2, 4, 32, 1024),
                                          (3, 4, 32, 777), (3, 4, 64, 1000),
                                          (5, 2, 128, 100), (2, 2, 256, 70)])
def test_fused_stack_kernel_matches_plain(cuda, D, layers, F, B):
    from nf_tpu_torch.ops.cuda import fused_stack as fs

    prog, g = _program(D, layers, F, 0, cuda)
    x = torch.randn(B, D, generator=g, device=cuda)
    for direction in ("forward", "inverse"):
        y, ld = fs.fused_stack(prog.stack, x, direction)
        torch.cuda.synchronize()
        yr, ldr = fs.fused_stack_reference(prog.stack.packed, prog.stack.const_ld,
                                           x, direction)
        torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(ld, ldr, atol=1e-3, rtol=0)


def test_eval_program_is_one_launch_per_call(cuda):
    from nf_tpu_torch.ops.cuda import fused_stack as fs

    prog, g = _program(2, 4, 32, 1, cuda)
    x = torch.randn(512, 2, generator=g, device=cuda)
    fs.reset_launches()
    prog.log_prob(x)
    prog.sample(512, g)
    torch.cuda.synchronize()
    assert fs.LAUNCHES == {"fused_stack_fwd": 1, "fused_stack_inv": 1}
