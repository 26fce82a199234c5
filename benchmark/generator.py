"""The one traffic generator: it reads a mix's parameters (`traffic/<mix>.json`)
and turns a seed into inputs and a sequence of requests.

A mix is a closed loop of one client.  Its requests come in cycles: each
cycle holds every entry of `requests` (a kind, `log_prob` or `sample`, and
its rows) `weight` times, in an order drawn from the seed.  So every seed
offers the same work, in another order.  Each entry names the caller whose
request it copies.

Inputs of `log_prob` requests are rows of one pool drawn from the seed on
the device (`data.density`, `data.pool` rows), taken at an offset drawn
from the seed: no request copies its input.  A density is a file of its
own, `densities/<name>.py`, found by name.  A `sample` request gets a seed
of its own for its generator.

`check` says which requests the output check compares: in each cycle,
`per_cycle` of each (kind, rows) entry, drawn from the seed, up to `most`
of each entry.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np
import torch

from . import state


def density(name: str):
    """The `densities/<name>.py` module: `draw(n, generator, device)` and
    the rows' `DIMS`."""
    return importlib.import_module(f"benchmark.densities.{name}")


@dataclass
class Request:
    index: int
    kind: str          # 'log_prob' | 'sample'
    rows: int
    offset: int        # log_prob: first pool row
    seed: int          # sample: its generator's seed
    checked: bool


def entries(mix: dict) -> list:
    """The (kind, rows) entries of the mix, in the file's order."""
    return [(e["kind"], int(e["rows"])) for e in mix["requests"]]


def largest(mix: dict) -> int:
    return max(rows for _, rows in entries(mix))


class Traffic:
    """A mix's inputs and requests for one seed."""

    def __init__(self, mix: dict, dims, seed: int, device):
        self.mix, self.seed, self.device = mix, int(seed), torch.device(device)
        data = mix["data"]
        pool = int(data["pool"])
        if pool < largest(mix):
            raise ValueError(f"pool of {pool} rows is smaller than a request")
        g = state.generator(seed, self.device, 2)
        x = density(data["density"]).draw(pool, g, self.device).to(torch.float32)
        if tuple(x.shape[1:]) != tuple(dims):
            raise ValueError(f"density {data['density']} gives rows of {tuple(x.shape[1:])}, "
                             f"the model takes {tuple(dims)}")
        self.pool = x[torch.randperm(pool, generator=g, device=self.device)].contiguous()
        self._cycle = [(e["kind"], int(e["rows"])) for e in mix["requests"]
                       for _ in range(int(e["weight"]))]
        self._rng = np.random.default_rng([self.seed % (1 << 64), 3])
        self._checked = {entry: 0 for entry in entries(mix)}
        self._next = 0

    def input(self, r: Request) -> torch.Tensor:
        return self.pool[r.offset:r.offset + r.rows]

    def cycles(self):
        """Requests, cycle after cycle, without end."""
        check = self.mix["check"]
        pool = self.pool.shape[0]
        while True:
            order = self._rng.permutation(len(self._cycle))
            chosen = set()
            for entry in self._checked:
                where = [i for i, j in enumerate(order) if self._cycle[j] == entry]
                k = max(min(int(check["per_cycle"]), len(where),
                            int(check["most"]) - self._checked[entry]), 0)
                chosen.update(int(i) for i in self._rng.choice(where, size=k, replace=False))
                self._checked[entry] += k
            offsets = self._rng.integers(0, 1 << 62, size=len(order))
            seeds = self._rng.integers(0, 1 << 62, size=len(order))
            for i, j in enumerate(order):
                kind, n = self._cycle[j]
                yield Request(self._next, kind, n, int(offsets[i] % (pool - n + 1)),
                              int(seeds[i]), i in chosen)
                self._next += 1
