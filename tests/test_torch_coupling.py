"""The coupling kernel's plain versions, its autograd Function and its
dispatchers against nf_tpu's ``ops/pallas/coupling.py``, on the CPU.

The plain forward and inverse against nf_tpu's Pallas kernels in interpret
mode, as tests/test_pallas.py runs them, atol 1e-5 (log-dets 1e-4: 256
terms summed in another order).  The analytic backward (``CouplingFwd``'s
CPU path) against nf_tpu's ``_cf_bwd`` and against ``torch.autograd`` of
the plain forward, atol / rtol 1e-4 as tests/test_pallas.py.  The
backward kernel's fold of dgain and dbias, walked in its order in f32,
against the plain backward at rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import close, normal

from nf_tpu.ops.pallas import coupling as jc


def _inputs(B, N, seed=0):
    z0, t, raw = (normal(seed + i, (B, N)) for i in range(3))
    gain = normal(seed + 3, (1,), 0.5)
    bias = normal(seed + 4, (1,), 0.1)
    return z0, t, raw, gain, bias


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_plain_versions_match_pallas_interpret():
    from nf_tpu_torch.ops.cuda import coupling as tc

    args = _inputs(16, 256)
    yp, ldp = jc.coupling_fwd_pallas(*args, interpret=True)
    y, ld = tc.coupling_fwd_reference(*_t(*args))
    close(y, yp, 1e-5)
    close(ld, ldp, 1e-4)
    xp, ldip = jc.coupling_inv_pallas(np.asarray(yp), *args[1:], interpret=True)
    x, ldi = tc.coupling_inv_reference(*_t(np.asarray(yp), *args[1:]))
    close(x, xp, 1e-5)
    close(ldi, ldip, 1e-4)
    close(x, args[0], 1e-5)


@pytest.mark.parametrize("B,N", [(4, 8), (6, 256)])
def test_analytic_backward_matches_cf_bwd_and_autograd(B, N):
    from nf_tpu_torch.ops.cuda import coupling as tc

    args = _inputs(B, N, seed=10)
    gy, gld = normal(20, (B, N)), normal(21, (B,))
    want = jc._cf_bwd(tuple(jnp.asarray(a) for a in (args[0], args[2], args[3], args[4])),
                      (jnp.asarray(gy), jnp.asarray(gld)))

    leaves = [a.requires_grad_() for a in _t(*args)]
    y, ld = tc.CouplingFwd.apply(*leaves)
    got = torch.autograd.grad((y, ld), leaves, _t(gy, gld))
    for g, w in zip(got, want):
        close(g, w, 1e-4, 1e-4)

    plain = [a.detach().clone().requires_grad_() for a in leaves]
    auto = torch.autograd.grad(tc.coupling_fwd_reference(*plain), plain, _t(gy, gld))
    for g, w in zip(got, auto):
        close(g, w, 1e-4, 1e-4)


def test_dispatch_follows_nf_tpus_gate():
    """A 2-D half a multiple of 128 wide goes through the Function (the
    kernels on the card); anything else takes the plain math."""
    from nf_tpu_torch.ops.cuda import coupling as tc

    for N, through in ((128, True), (384, True), (64, False), (1, False)):
        leaves = [a.requires_grad_() for a in _t(*_inputs(3, N))]
        y, ld = tc.coupling_fwd(*leaves)
        assert (type(y.grad_fn).__name__ == "CouplingFwdBackward") == through, N
        x, ldi = tc.coupling_inv(y.detach(), *leaves[1:])
        assert (type(x.grad_fn).__name__ == "CouplingInvBackward") == through, N
        close(x, leaves[0].detach(), 1e-5)
        close(ldi, -ld.detach(), 1e-5)
    assert not tc.eligible(torch.zeros(2, 4, 32))     # nf_tpu's gate: 2-D only


def test_inverse_has_no_gradient():
    from nf_tpu_torch.ops.cuda import coupling as tc

    leaves = [a.requires_grad_() for a in _t(*_inputs(2, 128))]
    x, ld = tc.coupling_inv(*leaves)
    with pytest.raises(NotImplementedError, match="no gradient"):
        (x.sum() + ld.sum()).backward()


def test_wrappers_raise_instead_of_running_the_plain_version():
    from nf_tpu_torch.ops.cuda import _build
    from nf_tpu_torch.ops.cuda import coupling as tc

    before = dict(tc.LAUNCHES)
    meta = [torch.zeros(4, 128, device="meta") for _ in range(3)]
    scal = [torch.zeros(1, device="meta") for _ in range(2)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        tc.coupling_fwd(*meta, *scal)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tc.coupling_inv(*meta, *scal)
    cpu = _t(*_inputs(4, 128))
    for inverse in (False, True):
        with pytest.raises(ValueError, match="CUDA tensor"):
            tc.launch(*cpu, inverse=inverse)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tc.launch_bwd(cpu[0], cpu[2], cpu[3], cpu[4], cpu[1], torch.zeros(4))
    assert tc.LAUNCHES == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            _build.load("coupling")


def _butterfly(v):
    """Lane 0 of an xor-butterfly sum over the last dimension (32 lanes):
    v += v[lane ^ o] for o = 16, 8, 4, 2, 1, as warp_sum does."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    return v[..., 0]


def _fold_walk(z0, raw, gain, bias, gy, gld):
    """dgain and dbias as csrc/coupling.cu's one-launch backward sums them,
    in f32: per row, lane l adds its float4 steps i = l, l + 32, ... as
    (x + y) + (z + w), then the warp's butterfly gives the row's partial;
    the last block's FOLD_THREADS threads add rows k, k + FOLD_THREADS, ...
    in order, each warp adds its lanes by a butterfly, and the warps are
    added in order."""
    from nf_tpu_torch.ops.cuda import coupling as tc

    th = torch.tanh(raw)
    es = torch.exp(th * gain + bias)
    ds = gy * z0 * es + gld[:, None]
    B, N = ds.shape

    def row_partials(v):
        q = v.view(B, N // 4, 4)
        steps = (q[..., 0] + q[..., 1]) + (q[..., 2] + q[..., 3])
        lanes = torch.zeros(B, 32)
        for i in range(N // 4):
            lanes[:, i % 32] += steps[:, i]
        return _butterfly(lanes)

    def fold(p):
        T = tc.FOLD_THREADS
        rows = torch.nn.functional.pad(p, (0, -B % T)).view(-1, T)
        acc = torch.zeros(T)
        for r in range(rows.shape[0]):
            acc = acc + rows[r]
        total = torch.zeros(())
        for w in _butterfly(acc.view(T // 32, 32)):
            total = total + w
        return total

    assert ds.dtype == torch.float32
    return fold(row_partials(ds * th)), fold(row_partials(ds))


@pytest.mark.parametrize("B,N", [(1024, 512), (1000, 384), (77, 1536)])
def test_backward_fold_order_matches_plain(B, N):
    from nf_tpu_torch.ops.cuda import coupling as tc

    z0, _, raw, gain, bias = _t(*_inputs(B, N, seed=B))
    gy, gld = _t(normal(B + 5, (B, N)), normal(B + 6, (B,)))
    dgain, dbias = _fold_walk(z0, raw, gain, bias, gy, gld)
    want = tc.coupling_bwd_reference(z0, raw, gain, bias, gy, gld)
    close(dgain.reshape(1), want[3], 0.0, 1e-5)
    close(dbias.reshape(1), want[4], 0.0, 1e-5)
    assert tc.FOLD_THREADS == 32 * tc.ROWS_PER_BLOCK
