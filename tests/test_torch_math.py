"""The port's flow math helpers and activation factories against nf_tpu's,
on the CPU.

``softplus``, ``deriv_sigmoid``, ``logistic_logcdf`` and
``mix_logistic_logcdf`` (``ops/math.py``) at 2e-5 on inputs that reach
|x| = 50, where nf_tpu's stable forms keep every value finite; the
``elu()`` / ``softplus()`` activations (``nets/core.py``) the same way.
"""
import numpy as np
import pytest
import torch
from _torch_parity import close

ATOL = 2e-5
B, N, K = 6, 40, 5


def _x(seed):
    """(B, N) entries spread over [-50, 50], the ends included."""
    x = np.random.default_rng(seed).uniform(-50.0, 50.0, (B, N)).astype(np.float32)
    x[0, :4] = (-50.0, 50.0, 0.0, -1e-3)
    return x


def _mixture(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, N, K)).astype(np.float32)
    logpi = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    mu = rng.standard_normal((B, N, K)).astype(np.float32)
    s = rng.uniform(-1.0, 0.5, (B, N, K)).astype(np.float32)
    return logpi.astype(np.float32), mu, s


@pytest.mark.parametrize("fn", ("softplus", "deriv_sigmoid"))
def test_elementwise_helpers_match_nf_tpu(fn):
    from nf_tpu.ops import math as nf_math

    from nf_tpu_torch.ops import math as tmath

    x = _x(1)
    got = getattr(tmath, fn)(torch.from_numpy(x))
    assert bool(torch.isfinite(got).all())
    close(got, getattr(nf_math, fn)(x), ATOL)


def test_logistic_logcdf_matches_nf_tpu():
    from nf_tpu.ops import math as nf_math

    from nf_tpu_torch.ops import math as tmath

    x = _x(2)
    _, mu, s = _mixture(2)
    mu, s = mu[..., 0], s[..., 0]
    got = tmath.logistic_logcdf(*map(torch.from_numpy, (x, mu, s)))
    assert bool(torch.isfinite(got).all()) and float(got.min()) < -40.0
    close(got, nf_math.logistic_logcdf(x, mu, s), ATOL)


def test_mix_logistic_logcdf_matches_nf_tpu_and_float64():
    from nf_tpu.ops import math as nf_math

    from nf_tpu_torch.ops import math as tmath

    x = _x(3)
    logpi, mu, s = _mixture(3)
    got = tmath.mix_logistic_logcdf(*map(torch.from_numpy, (x, logpi, mu, s)))
    assert got.shape == (B, N) and bool(torch.isfinite(got).all())
    close(got, nf_math.mix_logistic_logcdf(x, logpi, mu, s), ATOL)
    # a logsumexp over the K components on the last axis, in float64
    z = (x[..., None].astype(np.float64) - mu) * np.exp(-s.astype(np.float64))
    t = logpi + np.minimum(z, 0.0) - np.log1p(np.exp(-np.abs(z)))
    m = t.max(-1)
    close(got, m + np.log(np.exp(t - m[..., None]).sum(-1)), ATOL)


@pytest.mark.parametrize("factory", ("elu", "softplus", "relu"))
def test_activation_factories_match_nf_tpu(factory):
    from nf_tpu.core import Ctx
    from nf_tpu.nets import core as nf_core

    from nf_tpu_torch.nets import core

    act = getattr(core, factory)()
    assert isinstance(act, core.Activation) and not list(act.parameters())
    x = _x(4)
    want, _ = getattr(nf_core, factory)().apply({"params": {}, "state": {}}, x, Ctx())
    close(act(torch.from_numpy(x)), want, ATOL)
