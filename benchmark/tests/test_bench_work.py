"""The frozen work counts against counts made by hand."""
from benchmark.work import kernels
from benchmark.work import realnvp as work

CFG_2D = {"network": "realnvp", "dims": [2], "datatype": "2d",
          "network_config": {"layers": 32, "base_filters": 32}}
CFG_IMG = {"network": "realnvp", "dims": [32, 32, 1], "datatype": "image",
           "network_config": {"layers": 32, "base_filters": 32}}


def test_stack_work_by_hand():
    # D = 2, F = 32, 32 couplings with halves of 1 and 1: per row and coupling
    # 1*32 + 4*32*32 + 2*1*32 = 4,192 multiply-adds; 2*2 + 22*32 + 9 = 717 others
    w = kernels.stack_work(32, 2, 32, [(1, 1), (1, 1)], 8192)
    assert w["mac_flop"] == 8192 * 32 * 2 * 4192
    assert w["elem"] == 8192 * 32 * 717
    weights = 32 * (4 + 32 + 15 * 32 + 4 * 32 * 32 + 64 + 2 + 2)
    assert w["bytes"] == 4 * (2 * 8192 * 2 + 8192 + weights)
    # the bound at 3xTF32 (165 TFLOP/s) is the kernel table's 0.01332 ms
    assert abs(kernels.bound_s(w, 165e12, 67e12, 3.35e12) * 1e3 - 0.01332) < 1e-5


def test_model_flops_by_hand():
    assert work.model_flops(CFG_2D, "log_prob", 1) == 2 * 32 * 4192
    # 161 couplings: 32 at 16x16 (checkerboard of 32x32x1, in = out = 2), 32 at
    # 16x16 (channelwise of 16x16x4, 2 and 2), 32 at 8x8 (checkerboard of
    # 16x16x4, 8 and 8), 32 at 8x8 (channelwise of 8x8x16, 8 and 8), 33 at 4x4
    # (checkerboard of 8x8x16, 32 and 32)
    F = 32

    def conv(px, c):
        return px * (9 * c * F + 36 * F * F + F * 2 * c)
    mac = 64 * conv(256, 2) + 64 * conv(64, 8) + 33 * conv(16, 32)
    assert work.model_flops(CFG_IMG, "sample", 3) == 3 * 2 * mac


def test_kernel_calls():
    (group, w), = work.kernel_calls(CFG_2D, "log_prob", 100)
    assert group == "fused_stack" and w["mac_flop"] == 100 * 2 * 32 * 4192
    assert work.kernel_calls(CFG_IMG, "log_prob", 4096) == []
