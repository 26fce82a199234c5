"""The traffic generator: one seed gives the same requests and inputs, two
seeds the same work in another order."""
import json
from collections import Counter
from itertools import islice

import pytest
import torch

from benchmark import cells, generator
from benchmark.cells import HERE

BENCH = cells.Benchmark()


def _mix(name):
    cell = BENCH.workload(name)
    return BENCH.traffic(cell), BENCH.config(cell)


def _draw(name, seed, n):
    mix, cfg = _mix(name)
    mix["data"]["pool"] = generator.largest(mix) + 64
    t = generator.Traffic(mix, cfg["dims"], seed, "cpu")
    return t, list(islice(t.cycles(), n))


@pytest.mark.parametrize("name", ["realnvp-2d.bulk", "realnvp-img32x1.bulk"])
def test_same_seed_same_requests_and_inputs(name):
    seed = 2**31 + 1234567
    a, ra = _draw(name, seed, 40)
    b, rb = _draw(name, seed, 40)
    assert ra == rb
    assert torch.equal(a.pool, b.pool)


def _cycle(mix):
    return sum(int(e["weight"]) for e in mix["requests"])


@pytest.mark.parametrize("name", ["realnvp-2d.bulk", "realnvp-img32x1.bulk"])
def test_seeds_differ_in_order_and_inputs_not_in_work(name):
    mix, _ = _mix(name)
    cycle = _cycle(mix)
    a, ra = _draw(name, 11, 4 * cycle)
    b, rb = _draw(name, 2**33 + 5, 4 * cycle)
    assert not torch.equal(a.pool, b.pool)
    assert [(r.kind, r.rows) for r in ra] != [(r.kind, r.rows) for r in rb]
    for k in range(4):      # every cycle holds the same multiset of (kind, rows)
        one = Counter((r.kind, r.rows) for r in ra[k * cycle:(k + 1) * cycle])
        two = Counter((r.kind, r.rows) for r in rb[k * cycle:(k + 1) * cycle])
        assert one == two


@pytest.mark.parametrize("name", ["realnvp-2d.bulk", "realnvp-img32x1.bulk"])
def test_a_cycle_holds_each_entry_its_weight(name):
    mix, _ = _mix(name)
    _, reqs = _draw(name, 5, _cycle(mix))
    want = Counter()
    for e in mix["requests"]:
        want[(e["kind"], e["rows"])] += e["weight"]
        assert e["caller"]
    assert Counter((r.kind, r.rows) for r in reqs) == want


@pytest.mark.parametrize("name", ["realnvp-2d.bulk", "realnvp-img32x1.bulk"])
def test_checked_requests_per_entry_and_cap(name):
    mix, cfg = _mix(name)
    mix["data"]["pool"] = generator.largest(mix) + 64
    t = generator.Traffic(mix, cfg["dims"], 3, "cpu")
    cycle = _cycle(mix)
    reqs = list(islice(t.cycles(), cycle * (mix["check"]["most"] + 3)))
    entries = generator.entries(mix)
    checked = Counter((r.kind, r.rows) for r in reqs if r.checked)
    assert checked == {e: mix["check"]["most"] for e in entries}
    first = Counter((r.kind, r.rows) for r in reqs[:cycle] if r.checked)
    assert first == {e: 1 for e in entries}


@pytest.mark.parametrize("name", ["circles", "synthetic_mnist"])
def test_densities_have_their_shapes(name):
    g = torch.Generator().manual_seed(0)
    density = generator.density(name)
    x = density.draw(16, g, torch.device("cpu"))
    assert tuple(x.shape) == (16,) + density.DIMS and bool(torch.isfinite(x).all())
    if name.startswith("synthetic"):
        assert torch.equal(torch.round(x * 255) / 255, x)
        assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0


def test_every_density_a_mix_names_is_a_file():
    for path in sorted((HERE / "traffic").glob("*.json")):
        name = json.loads(path.read_text())["data"]["density"]
        assert (HERE / "densities" / f"{name}.py").is_file(), name
