"""The readers of the served program's spans (`spans.py`, the five
`metrics/*.spans.py` and `launch_lag_us.eval.py`) on made-up runs, and a
tiny CPU traced run with the spans recorded (`span_run.traced_run`)."""
from types import SimpleNamespace

import pytest

from benchmark import cells, spans, tracing

READERS = ("eval_self_us.spans", "launch_host_us.spans", "chain_self_us_per_image.spans",
           "conditioner_us_per_image.spans", "launch_lag_us.eval")
KERNEL = "void fused_stack_mma_kernel<32, 2, false, false>(Params)"


def _rec(t_call, t_return, t_end, rows=4, kind="log_prob"):
    return SimpleNamespace(kind=kind, rows=rows, t_call=t_call, t_return=t_return, t_end=t_end)


def _run(kernel_start=1070, launch_seen=1050):
    """A 2-D run: one request in the host's phase (0-150 ns), one in the
    traced window (1000-1500 ns), each root holding the input, the launch
    and the epilogue."""
    s = [("EvalProgram.log_prob", 10, 90, -1, 0), ("EvalProgram.input", 12, 20, 0, 0),
         ("launch.fused_stack_fwd.mma", 25, 60, 0, 0), ("EvalProgram.logp", 65, 85, 0, 0),
         ("EvalProgram.log_prob", 1005, 1090, -1, 1), ("EvalProgram.input", 1011, 1018, 4, 1),
         ("launch.fused_stack_fwd.mma", 1020, 1060, 4, 1), ("EvalProgram.logp", 1065, 1085, 4, 1)]
    ops = [("void at::native::copy_kernel(P)", 1000, 1030, 9), (KERNEL, kernel_start, 1400, 7),
           ("void at::native::reduce_kernel<512, 1>(R)", 1410, 1450, 8)]
    return SimpleNamespace(
        spans=s, dropped=0, untraced=[_rec(0, 100, 150)], requests=[_rec(1000, 1100, 1500)],
        window_ns=(1000, 1500), device_ops=ops, port_kernels=[ops[1]],
        runtime_launches={9: 1012, 7: launch_seen, 8: 1080},
        trace=tracing.DeviceTrace([o[:3] for o in ops], "wall", []))


def _image_run():
    """An image run's host phase: one coupling in a chain, two convs."""
    s = [("EvalProgram.log_prob", 0, 1000, -1, 0), ("layer.Chain", 100, 900, 0, 0),
         ("layer.AffineCoupling", 150, 850, 1, 0), ("coupling.split", 160, 200, 2, 0),
         ("coupling.net", 210, 700, 2, 0), ("net.weight", 220, 260, 4, 0),
         ("net.weight", 400, 450, 4, 0), ("launch.coupling_fwd", 710, 760, 2, 0),
         ("coupling.merge", 770, 800, 2, 0)]
    return SimpleNamespace(spans=s, dropped=0, untraced=[_rec(0, 1000, 1200, rows=2)],
                           requests=[], window_ns=(0, 0), trace=None)


def test_self_times():
    assert spans.self_ns(_run().spans)[:4] == [80 - 8 - 35 - 20, 8, 35, 20]


def test_host_readers_on_made_up_spans():
    run = _run()
    assert cells.reader("eval_self_us.spans")(run) == pytest.approx((17 + 8 + 20) / 1e3)
    assert cells.reader("launch_host_us.spans")(run) == pytest.approx(35 / 1e3)
    assert cells.reader("chain_self_us_per_image.spans")(run) is None   # no chain in 2-D
    assert cells.reader("conditioner_us_per_image.spans")(run) is None


def test_image_readers_on_made_up_spans():
    run = _image_run()
    # self: Chain 800 - 700, AffineCoupling 700 - 40 - 490 - 50 - 30, split 40, merge 30
    assert cells.reader("chain_self_us_per_image.spans")(run) == pytest.approx(
        (100 + 90 + 40 + 30) / 1e3 / 2)
    assert cells.reader("conditioner_us_per_image.spans")(run) == pytest.approx(490 / 1e3 / 2)
    assert cells.reader("eval_self_us.spans")(run) == pytest.approx(200 / 1e3)
    assert cells.reader("launch_host_us.spans")(run) == pytest.approx(50 / 1e3)


@pytest.mark.parametrize("name", READERS)
def test_no_spans_no_reading(name):
    bare = SimpleNamespace(untraced=[_rec(0, 100, 150)], requests=[_rec(1000, 1100, 1500)],
                           window_ns=(1000, 1500), trace=None)
    assert cells.reader(name)(bare) is None     # a run of the parent: nothing recorded
    empty = _run()
    empty.spans = []
    assert cells.reader(name)(empty) is None


def test_launch_lag_and_the_clock_check():
    run = _run()
    assert cells.reader("launch_lag_us.eval")(run) == pytest.approx(50 / 1e3)
    check = spans.clock_check(run)
    assert check["launches_before_span"] == 0 and check["launch_events_in_span"] == 100.0
    assert check["launch_event_to_kernel_us_min"] == pytest.approx(20 / 1e3)
    early = spans.clock_check(_run(kernel_start=1020 - spans.SLACK_NS - 1))
    assert early["launches_before_span"] == 1
    assert early["launch_event_to_kernel_us_min"] < 0
    outside = _run(launch_seen=1063)   # the runtime's record outside any launch span
    assert spans.clock_check(outside) == {"matched": 0}
    assert cells.reader("launch_lag_us.eval")(outside) is None
    dropped = _run()
    dropped.port_kernels = []          # the profiler kept no record of the launch
    assert spans.clock_check(dropped) == {"matched": 0}
    by_order = _run()
    by_order.runtime_launches = {}     # no runtime records: the n-th launch, the n-th record
    assert spans.clock_check(by_order)["lag_us_median"] == pytest.approx(50 / 1e3)


def test_the_device_clocks_offsets_are_taken_out():
    """Launches every 10 ms over 1 s, each kernel 5 us after its launch
    record on the host's clock, the device's timestamps 400 us early from
    0.3 s to 0.5 s: the offsets are found stretch by stretch and taken out."""
    s, ops, runtime = [], [], {}
    for j in range(100):
        t = j * 10_000_000
        s.append(("launch.coupling_fwd", t, t + 20_000, -1, j))
        start = t + 15_000 - (400_000 if 300_000_000 <= t < 500_000_000 else 0)
        ops.append(("void coupling_kernel<true>(P)", start, start + 3_000, j))
        runtime[j] = t + 10_000
    run = SimpleNamespace(spans=s, untraced=[], requests=[_rec(0, 1, 1_000_000_000)],
                          window_ns=(0, 1_000_000_000), device_ops=ops, port_kernels=list(ops),
                          runtime_launches=runtime,
                          trace=tracing.DeviceTrace([o[:3] for o in ops], "wall", []))
    assert spans.clock_check(run)["launches_before_span"] == 20
    offsets = spans.device_offsets(run)
    assert offsets == {b: -400_000 if b in (3, 4) else 0 for b in range(10)}
    spans.realign(run, offsets)
    check = spans.clock_check(run)
    assert check["launches_before_span"] == 0
    assert check["launch_event_to_kernel_us_min"] == pytest.approx(5)
    assert run.trace.ops[35][1] == run.port_kernels[35][1] == 350_015_000


def test_gaps_are_put_down_to_program_spans():
    gaps = dict(spans.label_gaps(_run()))
    # idle 1030-1070 inside the launch span; 1400-1410 and 1450-1500 outside any
    assert gaps == pytest.approx({"log_prob.call/launch.fused_stack_fwd.mma": 40e-9,
                                  "log_prob.sync": 60e-9})
    # cut where the host moved: the launch span closes at 1060, the epilogue opens at 1065
    assert dict(spans.label_gaps(_run(), cut=True)) == pytest.approx({
        "log_prob.call/launch.fused_stack_fwd.mma": 30e-9,
        "log_prob.call/EvalProgram.log_prob": 5e-9, "log_prob.call/EvalProgram.logp": 5e-9,
        "log_prob.sync": 60e-9})


def test_device_time_is_put_down_to_the_spans_that_launched_it():
    by = spans.device_by_span(_run())
    assert by == {"EvalProgram.input": 30, "launch.fused_stack_fwd.mma": 330,
                  "EvalProgram.logp": 40, "EvalProgram.log_prob": 400}
    counts = spans.span_counts(_run())
    assert counts["EvalProgram.log_prob"]["per_request"] == 1.0
    assert counts["EvalProgram.log_prob"]["self_us_median"] == pytest.approx(17 / 1e3)
    assert counts["launch.fused_stack_fwd.mma"]["device_s"] == pytest.approx(330e-9)


class _NoDevice:
    """The profiler's place on the CPU: a trace with no device operation."""
    stop_s = read_s = 0.0

    def __enter__(self):
        self.trace = tracing.DeviceTrace([], "wall", [])
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("name", ["realnvp-2d.bulk", "realnvp-img32x1.bulk"])
def test_a_tiny_traced_run_with_spans(monkeypatch, name):
    """Every metric the cell had is still read, and the result line keeps
    its shape; the host phase's spans give the `.spans` readings."""
    import time

    from benchmark import span_run
    from benchmark.tests.tiny import tiny

    monkeypatch.setattr(tracing, "Profiler", _NoDevice)
    bench, cell, cfg, mix = tiny(name)
    result, run, _ = span_run.traced_run(bench, cell, 7, 0.6, device="cpu",
                                         t0=time.perf_counter_ns(), cfg=cfg, mix=mix)
    assert tracing.Profiler is _NoDevice
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert result["correct"] and list(result)[-1] == "checks"
    assert {m["name"] for m in bench.metrics(cell, True)} - {"fused_stack_roofline.eval",
                                                             "conv_roofline.eval",
                                                             "aten_us_per_image.eval"} \
        <= set(result["metrics"])
    assert run.spans and run.dropped == 0
    assert cells.reader("eval_self_us.spans")(run) > 0
    image = name.startswith("realnvp-img")
    for reader in ("chain_self_us_per_image.spans", "conditioner_us_per_image.spans"):
        value = cells.reader(reader)(run)
        assert value > 0 if image else value is None
    assert cells.reader("launch_host_us.spans")(run) is None    # no kernel on the CPU
    harness_labels = {f"{kind}.{at}" for kind in ("log_prob", "sample")
                      for at in ("call", "sync")} | {"between"}
    labels = [label.split("/")[0] for label, _ in spans.label_gaps(run)]
    assert labels and set(labels) <= harness_labels
