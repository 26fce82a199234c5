"""The port's span recorder (``nf_tpu_torch/utils/tracing.py``) on the CPU.

Nothing is recorded outside ``recording()``.  Inside it the served
program's calls, the eager chain's layers, the couplings' splits,
conditioners and merges and the weight norms are spans that nest by
``parent``, share one ``request`` id a call, and have self times that are
non-negative and add up to the root's duration.  The outputs are the same
bits with and without recording; the buffer drops past its capacity and
counts the drops; a ``record_function`` opens only under a profiler.
"""
import threading

import pytest
import torch

from nf_tpu_torch.config import NetworkConfig
from nf_tpu_torch.models import build_model
from nf_tpu_torch.utils import tracing
from nf_tpu_torch.utils.tracing import recording, self_ns, span


def _program_2d():
    model = build_model("realnvp", (2,), "2d", NetworkConfig(layers=4, base_filters=8),
                        device="cpu")
    model.init(torch.Generator().manual_seed(0))
    return model.eval_program()


def _program_image():
    model = build_model("realnvp", (16, 16, 1), "image", NetworkConfig(layers=2, base_filters=8),
                        device="cpu")
    model.init(torch.Generator().manual_seed(1))
    return model.eval_program()


def _x(kind, rows=8):
    g = torch.Generator().manual_seed(2)
    if kind == "2d":
        return torch.randn(rows, 2, generator=g)
    return 0.05 + 0.9 * torch.rand(rows, 16, 16, 1, generator=g)


PROGRAMS = {"2d": _program_2d, "image": _program_image}
DIMS = {"2d": (2,), "image": (16, 16, 1)}


def _calls(program, kind):
    """A log p and a draw, each one request."""
    x = _x(kind)
    return [lambda: program.log_prob(x),
            lambda: program.sample(4, torch.Generator().manual_seed(3))]


def _check_tree(spans):
    """Every parent opened before its child and holds it in time; every
    child shares its parent's request."""
    for i, (name, start, end, parent, request) in enumerate(spans):
        assert start <= end, name
        if parent >= 0:
            p = spans[parent]
            assert parent < i and p[1] <= start and end <= p[2], (name, p[0])
            assert request == p[4], (name, p[0])


def test_nothing_is_recorded_by_default():
    program = _program_2d()
    assert tracing._buffer is None
    assert span("EvalProgram.log_prob", request=True) is span("net.weight")
    with recording() as buf:
        program.log_prob(_x("2d"))
    n = len(buf.spans)
    assert n > 0 and tracing._buffer is None
    program.log_prob(_x("2d"))
    assert len(buf.spans) == n and buf.dropped == 0


def test_a_recording_inside_a_recording_shares_its_buffer():
    with recording() as outer:
        with recording() as inner:
            with span("a"):
                pass
        assert inner is outer and tracing._buffer is outer
    assert [s[0] for s in outer.spans] == ["a"] and tracing._buffer is None


def test_spans_of_the_2d_program():
    """The plain path (the fused stack's plain version on the CPU): the
    root, the input and the epilogue; the draw in a sample."""
    program = _program_2d()
    log_prob, sample = _calls(program, "2d")
    with recording() as buf:
        log_prob()
        sample()
    assert [(s[0], s[3], s[4]) for s in buf.spans] == [
        ("EvalProgram.log_prob", -1, 0), ("EvalProgram.input", 0, 0),
        ("EvalProgram.logp", 0, 0),
        ("EvalProgram.sample", -1, 1), ("EvalProgram.draw", 3, 1),
        ("EvalProgram.input", 3, 1), ("EvalProgram.logp", 3, 1)]
    assert buf.requests == 2
    _check_tree(buf.spans)


def test_spans_of_the_image_chain():
    """Each layer of the eager chain a span inside the root, the couplings'
    split, conditioner and merge inside their layer, weight norm inside the
    conditioner: 7 couplings at 16x16x1 with 2 layers a block, 6 convs each."""
    program = _program_image()
    with recording() as buf:
        program.log_prob(_x("image"))
    spans = buf.spans
    _check_tree(spans)
    counts = buf.counts()
    assert counts["EvalProgram.log_prob"] == 1 and counts["layer.Chain"] == 1
    assert counts["layer.AffineCoupling"] == counts["layer.BatchNorm"] == 7
    for part in ("coupling.split", "coupling.net", "coupling.merge"):
        assert counts[part] == 7, part
    assert counts["net.weight"] == 7 * 6
    assert counts["layer.Logit"] == counts["layer.Squeeze2d"] == counts["layer.Unsqueeze2d"] == 1
    for name, _, _, parent, _ in spans:
        if name.startswith("coupling."):
            assert spans[parent][0] == "layer.AffineCoupling"
        if name == "net.weight":
            while spans[parent][0] != "coupling.net":
                parent = spans[parent][3]
                assert parent >= 0
    assert {s[4] for s in spans} == {0}


@pytest.mark.parametrize("kind", ["2d", "image"])
@pytest.mark.parametrize("call", [0, 1], ids=["log_prob", "sample"])
def test_self_times_add_up_to_the_root(kind, call):
    program = PROGRAMS[kind]()
    with recording() as buf:
        _calls(program, kind)[call]()
    own = self_ns(buf.spans)
    assert all(t >= 0 for t in own)
    root = buf.spans[0]
    assert root[3] == -1 and root[0].startswith("EvalProgram.")
    assert sum(own) == root[2] - root[1]


@pytest.mark.parametrize("kind", ["2d", "image"])
def test_outputs_are_the_same_bits_with_recording(kind):
    program = PROGRAMS[kind]()
    plain = [call() for call in _calls(program, kind)]
    with recording():
        traced = [call() for call in _calls(program, kind)]
    assert torch.equal(plain[0], traced[0])
    for a, b in zip(plain[1], traced[1]):
        assert torch.equal(a, b)


def test_the_buffer_drops_past_its_capacity():
    program = _program_image()
    with recording() as whole:
        program.log_prob(_x("image"))
    with recording(capacity=10) as buf:
        program.log_prob(_x("image"))
    assert len(buf.spans) == 10 and buf.dropped == len(whole.spans) - 10
    assert [s[0] for s in buf.spans] == [s[0] for s in whole.spans[:10]]
    _check_tree(buf.spans)


def test_spans_of_another_thread_are_dropped():
    with recording() as buf:
        worker = threading.Thread(target=lambda: span("elsewhere").__enter__())
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
        with span("here"):
            pass
    assert [s[0] for s in buf.spans] == ["here"] and buf.dropped == 1


def test_a_span_that_raises_is_closed():
    with recording() as buf:
        with pytest.raises(ValueError):
            with span("outer", request=True):
                with span("inner"):
                    raise ValueError("no")
        with span("after", request=True):
            pass
    assert [(s[0], s[3], s[4]) for s in buf.spans] == [
        ("outer", -1, 0), ("inner", 0, 0), ("after", -1, 1)]
    assert buf.open == [] and buf.request == -1


def test_self_ns_of_made_up_spans():
    spans = [("root", 0, 100, -1, 0), ("a", 10, 40, 0, 0), ("b", 15, 25, 1, 0),
             ("c", 50, 90, 0, 0)]
    assert self_ns(spans) == [30, 20, 10, 40]


def test_record_function_only_under_a_profiler(monkeypatch):
    program = _program_2d()
    opened = []
    record_function = torch.profiler.record_function

    def counting(name):
        opened.append(name)
        return record_function(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with recording():
        program.log_prob(_x("2d"))
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        program.log_prob(_x("2d"))
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with recording():
            program.log_prob(_x("2d"))
    assert opened == ["EvalProgram.log_prob", "EvalProgram.input", "EvalProgram.logp"]
    names = {e.key for e in prof.key_averages()}
    assert {"EvalProgram.log_prob", "EvalProgram.input", "EvalProgram.logp"} <= names


def test_the_profiling_trace_shows_the_spans(tmp_path):
    import json

    from nf_tpu_torch.utils.profiling import trace

    program = _program_image()
    with trace(str(tmp_path)) as prof:
        program.sample(2, torch.Generator().manual_seed(4))
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"EvalProgram.sample", "EvalProgram.draw", "layer.AffineCoupling", "coupling.net",
            "net.weight"} <= names
    assert tracing._buffer is None


def test_a_launch_is_a_span_where_its_wrapper_checks(monkeypatch):
    """The launch spans open before the wrapper's checks: a CPU tensor is
    refused inside ``launch.<LAUNCHES key>[.<path>]``, and nothing is
    counted."""
    from nf_tpu_torch.ops.cuda import coupling as tc
    from nf_tpu_torch.ops.cuda import fused_stack as fs

    z = torch.zeros(4, 128)
    scalar = torch.zeros(1)
    stack = _program_2d().stack
    before = dict(tc.LAUNCHES), dict(fs.LAUNCHES)
    with recording() as buf:
        with pytest.raises(ValueError, match="CUDA"):
            tc.launch(z, z, z, scalar, scalar, inverse=True)
        with pytest.raises(ValueError, match="CUDA"):
            fs.launch(stack, torch.zeros(4, 2), inverse=False)
    assert [s[0] for s in buf.spans] == ["launch.coupling_inv",
                                         f"launch.fused_stack_fwd.{stack.variant}"]
    assert (dict(tc.LAUNCHES), dict(fs.LAUNCHES)) == before
