"""Faults planted under the served program, for the output check's tests
and its readings on the card: each wraps the program and breaks its
answers where they are produced.

* `identity`: every request returns its state unchanged: log p(x) is the
  base density's at x itself, a sample is its latent, as if no layer ran;
* `half`: half of the rows left out: the first half is served and its
  answers stand in for the rest;
* `altered`: one answer altered where it is produced: one row's log p, and
  one sampled row, moved by 1 %.
"""
from __future__ import annotations

import math

import torch


def _normal_logprob(z):
    z = z.reshape(z.shape[0], -1)
    return -0.5 * (z * z).sum(dim=1) - 0.5 * z.shape[1] * math.log(2.0 * math.pi)


class _Wrapped:
    def __init__(self, program):
        self.program = program
        self.dims = program.dims
        self.device = program.device


class Identity(_Wrapped):
    def log_prob(self, x):
        return _normal_logprob(x)

    def sample(self, n, generator):
        z = torch.randn((n,) + tuple(self.dims), generator=generator, device=generator.device)
        return z, _normal_logprob(z)


class Half(_Wrapped):
    @staticmethod
    def _fill(a, n):
        return torch.cat([a, a[:n - a.shape[0]]])

    def log_prob(self, x):
        return self._fill(self.program.log_prob(x[:(x.shape[0] + 1) // 2]), x.shape[0])

    def sample(self, n, generator):
        y, lp = self.program.sample((n + 1) // 2, generator)
        return self._fill(y, n), self._fill(lp, n)


class Altered(_Wrapped):
    def log_prob(self, x):
        lp = self.program.log_prob(x)
        lp[lp.shape[0] // 2] *= 1.01
        return lp

    def sample(self, n, generator):
        y, lp = self.program.sample(n, generator)
        y[n // 2] *= 1.01
        lp[n // 2] *= 1.01
        return y, lp


FAULTS = {"identity": Identity, "half": Half, "altered": Altered}
