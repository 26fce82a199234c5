"""The trace's arithmetic on a made-up trace: busy time as a union, idle
gaps by the host's span, the clock shifts, and the readers on it."""
from types import SimpleNamespace

from benchmark import cells, tracing


def _trace():
    ops = [("void fused_stack_mma_kernel<32, 2, false, false>(Params)", 100, 400),
           ("at::native::reduce_kernel", 350, 450),
           ("void coupling_kernel<true>(float4 const*)", 600, 700)]
    return tracing.DeviceTrace(list(ops), "wall", [460, 720])


def test_union_busy_and_gaps():
    t = _trace()
    assert t.union() == [[100, 450], [600, 700]]
    assert t.busy_ns(0, 1000) == 450 and t.busy_ns(120, 620) == 350
    assert t.gaps(0, 1000) == [(0, 100), (450, 600), (700, 1000)]
    assert t.kernel("fused_stack_mma_kernel") == (300, 1)
    assert t.kernel("coupling_kernel") == (100, 1) and t.kernel("coupling_bwd_kernel") == (0, 0)


def test_gaps_are_labelled_by_the_host_span():
    spans = [(0, "log_prob.call"), (300, "log_prob.sync"), (500, "between")]
    labelled = dict(tracing.label_gaps([(0, 100), (450, 600), (700, 1000)], spans))
    assert labelled == {"log_prob.call": 100e-9, "log_prob.sync": 150e-9, "between": 300e-9}


def test_clock_shift():
    t = _trace()
    assert tracing.clock_shift(t, [470, 720, 731]) == 10
    assert t.ops[0][1:] == (110, 410) and t.runtime_syncs == [470, 730]
    assert t.union()[0] == [110, 460]


def test_short_names():
    assert tracing.short_name("void at::native::reduce_kernel<512, 1>(R)") == \
        "at::native::reduce_kernel"


def test_readers_on_a_made_up_run():
    cfg = {"network": "realnvp", "dims": [2], "datatype": "2d",
           "network_config": {"layers": 32, "base_filters": 32}}
    rec = SimpleNamespace(kind="log_prob", rows=8192, t_call=0, t_return=50_000, t_end=500_000)
    early = SimpleNamespace(kind="log_prob", rows=8192, t_call=0, t_return=40_000, t_end=90_000)
    run = SimpleNamespace(cfg=cfg, requests=[rec], window_ns=(0, 500_000),
                          work=cells.family("work", "realnvp"), launched={"fused_stack_fwd": 1},
                          untraced=[early, early, rec],
                          trace=tracing.DeviceTrace(
                              [("fused_stack_mma_kernel", 1000, 56_000)], "wall", []))
    share = cells.reader("fused_stack_roofline.eval")(run)
    assert abs(share - 100 * 4.44003e-6 / 55e-6) < 0.01
    assert abs(cells.reader("idle_share.eval")(run) - 89.0) < 1e-9
    assert cells.reader("conv_roofline.eval")(run) is None
    assert cells.reader("aten_us_per_image.eval")(run) is None
    # the host's time is read from the untraced requests only
    assert abs(cells.reader("host_ms_per_request")(run) - 0.04) < 1e-12
    mfu = cells.reader("mfu.eval")(run)
    assert abs(mfu - 100 * 8192 * 268288 / (500e-6 * 495e12)) < 1e-9
    run.launched = {"fused_stack_fwd": 2}     # a record the profiler dropped
    assert abs(cells.reader("fused_stack_roofline.eval")(run) - share / 2) < 1e-9
    run.untraced = []
    assert cells.reader("host_ms_per_request")(run) is None


def test_image_readers_on_a_made_up_run():
    cfg = {"network": "realnvp", "dims": [32, 32, 1], "datatype": "image",
           "network_config": {"layers": 32, "base_filters": 32}}
    work = cells.family("work", "realnvp")
    recs = [SimpleNamespace(kind="log_prob", rows=256, t_call=0, t_return=1, t_end=2),
            SimpleNamespace(kind="sample", rows=64, t_call=3, t_return=4, t_end=10_000_000)]
    ops = [("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw", 0, 4_000_000),
           ("void cudnn::engines_precompiled::nchwToNhwcKernel<float>(P)", 4_000_000, 5_000_000),
           ("void at::native::elementwise_kernel<128, 2>(int, F)", 5_000_000, 5_320_000),
           ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>(P)",
            5_320_000, 5_640_000),
           ("void coupling_kernel<true>(float4 const*)", 5_640_000, 5_700_000)]
    run = SimpleNamespace(cfg=cfg, requests=recs, window_ns=(0, 10_000_000), work=work,
                          launched={}, untraced=recs,
                          trace=tracing.DeviceTrace(ops, "wall", []))
    flops = work.model_flops(cfg, "log_prob", 320)
    conv = cells.reader("conv_roofline.eval")(run)
    assert abs(conv - 100 * flops / 495e12 / 5e-3) < 1e-9 and 0 < conv < 100
    assert abs(cells.reader("aten_us_per_image.eval")(run) - 640 / 320) < 1e-12
    assert cells.reader("fused_stack_roofline.eval")(run) is None


class _NoDevice:
    """The profiler's place on the CPU: a trace with no device operation."""
    stop_s = read_s = 0.0

    def __enter__(self):
        self.trace = tracing.DeviceTrace([], "wall", [])
        return self

    def __exit__(self, *exc):
        return False


def test_a_traced_run_reads_the_host_before_the_profiler(monkeypatch):
    """The host's time comes from the untraced first half; the second half
    is the traced window."""
    from benchmark.tests.tiny import run_tiny
    monkeypatch.setattr(tracing, "Profiler", _NoDevice)
    result, _ = run_tiny("realnvp-2d.bulk", seconds=0.6, trace=1)
    assert result["metrics"]["host_ms_per_request"]["value"] > 0
    assert result["correct"] and 0 < result["device"]["window_s"] < 0.6
    assert result["attempted"] > len(result["breakdown"]["idle_gaps"]) > 0
