"""The port's ``scan`` / ``remat`` against nf_tpu's, on the CPU.

* Every family built with ``scan=True`` has nf_tpu's bijector structure
  (``ScannedChain`` blocks, tails, the remat flags, with and without
  ``remat``), loads nf_tpu's stacked variables and exports them back
  unchanged, and with ``remat=True`` serves nf_tpu's log p: 1e-4 per
  program, 3e-4 for image log-densities (the RealNVP, Glow and Flow++
  image tiers in tests/test_torch_train.py, test_torch_glow_image.py and
  test_torch_flowpp_image_model.py).
* Blocks of unlike static configuration raise ``ValueError`` in both
  packages; ``scan_repeated`` folds as nf_tpu's.
* Rematerialization changes nothing: for RealNVP image, ResFlow 2-D and
  MAF 2-D (masks resampled from the generator), one train-mode step of
  the unrolled model with and without remat and of the scanned remat
  model gives the same loss, gradients, buffers (batch-norm statistics,
  ActNorm state, u / v) and generator state bit for bit.
* Three Trainer steps with ``scan=True, remat=True`` against nf_tpu's
  Trainer (``tests/_torch_parity.py::trainer_parity`` and
  ``resflow_trainer_parity``'s bounds), MAF's masks and ResFlow's draws
  rebuilt from nf_tpu's keys on the scanned key path.
* A scanned 2-D RealNVP, Glow, Flow++ or ResFlow gets no fused spec, in
  either package: it is served by the chain.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_parity import (bijector_structure, close, flag_parity, nf_layer_keys, normal,
                           resflow_trainer_parity, trainer_parity, uniform)

from nf_tpu.bijectors import made as jmade
from nf_tpu_torch.bijectors import made as tmade

FAMILIES = {   # name: (dims, datatype, config, log p atol; None: structure and variables)
    "realnvp-2d": ("realnvp", (2,), "2d", dict(layers=4), 1e-4),
    "glow-2d": ("glow", (2,), "2d", dict(layers=4), 1e-4),
    "flowpp-2d": ("flow++", (2,), "2d", dict(layers=4, mixtures=2), 1e-4),
    "maf-2d": ("maf", (2,), "2d", dict(layers=2), 1e-4),
    "maf-img": ("maf", (4, 4, 1), "image", dict(layers=2, allow_image=True), 3e-4),
    "planar-2d": ("planar", (2,), "2d", dict(layers=4), 1e-4),
    "resflow-2d": ("resflow", (2,), "2d", dict(layers=2, logdet="exact"), 1e-4),
    "resflow-img": ("resflow", (4, 4, 1), "image",
                    dict(layers=2, logdet="exact", allow_image=True), None),
    "ffjord-2d": ("ffjord", (2,), "2d", dict(layers=2, trace="exact"), 1e-4),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_scanned_family_matches_nf_tpu(family):
    name, dims, datatype, kw, atol = FAMILIES[family]
    flag_parity(name, dims, datatype, logp=False, base_filters=8, scan=True, **kw)
    _, _, tm = flag_parity(name, dims, datatype, atol, logp=atol is not None, base_filters=8,
                           scan=True, remat=True, **kw)
    assert "ScannedChain" in str(bijector_structure(tm.bijector))


def _blocks(pkg, odd_second, width=8):
    if pkg == "jax":
        from nf_tpu.bijectors.coupling import AffineCoupling
        from nf_tpu.bijectors.norm import BatchNorm
        from nf_tpu.core.bijector import Chain
        kw = {}
    else:
        from nf_tpu_torch.bijectors.coupling import AffineCoupling
        from nf_tpu_torch.bijectors.norm import BatchNorm
        from nf_tpu_torch.core.bijector import Chain
        kw = dict(device="cpu")
    return [Chain([BatchNorm(4, affine=False, **kw),
                   AffineCoupling((4,), odd=odd, base_filters=w, **kw)])
            for odd, w in ((False, 8), (odd_second, width))]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_unlike_blocks_raise(pkg):
    if pkg == "jax":
        from nf_tpu.core.bijector import ScannedChain
    else:
        from nf_tpu_torch.core.bijector import ScannedChain
    ScannedChain(_blocks(pkg, False))
    with pytest.raises(ValueError, match="share static configuration"):
        ScannedChain(_blocks(pkg, True))                   # parity differs
    if pkg == "torch":                                    # nf_tpu checks widths at init
        with pytest.raises(ValueError, match="share static configuration"):
            ScannedChain(_blocks(pkg, False, width=16))


@pytest.mark.parametrize("n,period", [(3, 4), (7, 4), (8, 4), (10, 4), (5, 1), (9, 2)])
def test_scan_repeated_folds_as_nf_tpu(n, period):
    from nf_tpu.bijectors.norm import ActNorm as JActNorm
    from nf_tpu.core.bijector import scan_repeated as jscan
    from nf_tpu_torch.bijectors.norm import ActNorm
    from nf_tpu_torch.core.bijector import scan_repeated

    for remat in (False, True):
        want = bijector_structure(jscan([JActNorm(2) for _ in range(n)], period, remat))
        got = bijector_structure(scan_repeated([ActNorm(2) for _ in range(n)], period, remat))
        assert got == want


def _model(name, dims, datatype, state=None, **kw):
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model

    m = build_model(name, dims, datatype, NetworkConfig(name=name, **kw), device="cpu")
    if state is not None:
        for dst, src in zip(m.state_dict().values(), state):
            dst.copy_(src)
    return m


REMAT_CASES = {
    "realnvp-img": ("realnvp", (16, 16, 1), "image", dict(layers=4, base_filters=8)),
    "resflow-2d": ("resflow", (2,), "2d", dict(layers=4, base_filters=8)),
    "maf-2d": ("maf", (3,), "2d", dict(layers=4, base_filters=8, resample_masks=True)),
}


@pytest.mark.parametrize("case", sorted(REMAT_CASES))
def test_remat_step_equals_the_plain_step_exactly(case):
    """One train-mode loss and backward: unrolled, unrolled with remat and
    scanned with remat, the same weights and generator seed.  The
    parameters and buffers line up in module order in all three."""
    name, dims, datatype, kw = REMAT_CASES[case]
    plain = _model(name, dims, datatype, **kw)
    plain.init(torch.Generator().manual_seed(3))
    batch = torch.from_numpy(uniform(5, (8,) + dims) if datatype == "image"
                             else normal(5, (64,) + dims))
    plain.data_dependent_init(batch)
    state = [t.clone() for t in plain.state_dict().values()]
    runs = []
    for cfg in ({}, dict(remat=True), dict(scan=True), dict(scan=True, remat=True)):
        m = plain if not cfg else _model(name, dims, datatype, state, **kw, **cfg)
        assert [t.shape for t in m.state_dict().values()] == [t.shape for t in state]
        m.train()
        g = torch.Generator().manual_seed(11)
        loss = -m.log_prob(batch, g).mean()
        loss.backward()
        runs.append((loss.detach(), [p.grad for p in m.parameters()],
                     [b.clone() for b in m.buffers()], g.get_state()))
    for ref, got in ((runs[0], runs[1]), (runs[2], runs[3])):      # remat: bit for bit
        assert torch.equal(got[0], ref[0])
        assert all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))
        assert all(torch.equal(a, b) for a, b in zip(got[2], ref[2]))
        assert torch.equal(got[3], ref[3])
    # scanned against unrolled: the log-dets summed per block, in another order
    ref, got = runs[0], runs[2]
    close(got[0], ref[0], 1e-5, 1e-6)
    for a, b in zip(got[1] + got[2], ref[1] + ref[2]):
        close(a.float(), b.float(), 1e-5, 1e-5)
    assert torch.equal(got[3], ref[3])
    ref = runs[0]
    moved = [not torch.equal(b, s) for b, s in zip(ref[2], (t for t, (k, _) in zip(
        state, plain.state_dict().items()) if k in dict(plain.named_buffers())))]
    assert any(moved)


def test_trainer_scan_remat_image_realnvp_matches_nf_tpu():
    """A gradient entry past 1e-5 of nf_tpu's is held to float64 as in
    tests/test_torch_train.py (s_bias' gradient, 0.76, sums 1,024 terms
    per block in another order under the scan)."""
    dims = (8, 8, 1)
    batches = np.stack([uniform(80 + k, (16,) + dims) for k in range(4)])
    model = trainer_parity(dims, "image", 3, 8, batches, f64_arbiter=True, scan=True,
                           remat=True)
    assert "ScannedChain" in str(bijector_structure(model.bijector))


def test_trainer_scan_remat_resflow_matches_nf_tpu():
    """The port's scan + remat ResFlow against nf_tpu's unrolled Trainer,
    nf_tpu's draws on its key path injected block by block: nf_tpu's own
    ResFlow cannot train scanned or rematerialized (its training forward
    leaks a tracer under lax.scan and under jax.checkpoint: pinned below),
    while the port's scan and remat give its unrolled step
    (test_remat_step_equals_the_plain_step_exactly)."""
    from nf_tpu.config import NetworkConfig as JNC
    from nf_tpu.config import OptimizerConfig as JOC
    from nf_tpu.models import build_model as jbuild
    from nf_tpu.train import Trainer as JTrainer

    batches = np.stack([normal(90 + k, (64, 2)) * 1.3 + 0.2 for k in range(4)])
    prog = resflow_trainer_parity((2,), "2d", 2, 8, batches, 1e-4,
                                  port_kw=dict(scan=True, remat=True))
    assert prog.stack is None
    for kw in (dict(scan=True), dict(remat=True)):
        jm = jbuild("resflow", (2,), "2d", JNC(name="resflow", layers=2, base_filters=8, **kw))
        jt = JTrainer(jm, JOC(), seed=0)
        with pytest.raises(jax.errors.UnexpectedTracerError):
            jt.train_step(jt.init_state(jax.random.PRNGKey(0), batches[0]), batches[1])


def test_trainer_scan_remat_maf_matches_nf_tpu(monkeypatch):
    """MAF with resample_masks: every MADE's masks drawn from nf_tpu's key
    on the scanned path (block, then layer, then the MADE), injected by
    the state of the generator handed in, so a recompute that restores
    the generator gets the same masks."""
    from nf_tpu_torch.bijectors.made import AutoregressiveTransform

    sampler = jmade.AutoregressiveTransform(2, base_filters=8, resample_masks=True).net_s
    table, pending = {}, []

    def inject(model, key):
        table.clear()
        pending.clear()
        for m, k in nf_layer_keys(model.bijector, key):
            if isinstance(m, AutoregressiveTransform):
                for j in (0, 1):
                    masks = sampler._sample_masks_traced(jax.random.fold_in(k, j))
                    pending.append([torch.from_numpy(np.array(a).T.copy()) for a in masks])

    def sample_masks(self, generator):
        state = generator.get_state().numpy().tobytes()
        torch.rand(1, generator=generator)
        if state not in table:
            table[state] = pending.pop(0)
        return table[state]

    monkeypatch.setattr(tmade.MADE, "sample_masks", sample_masks)
    batches = np.stack([normal(100 + k, (64, 2)) * 1.3 + 0.2 for k in range(4)])
    trainer_parity((2,), "2d", 2, 8, batches, name="maf", inject=inject, scan=True,
                   remat=True, resample_masks=True)
    assert not pending


@pytest.mark.parametrize("name,kw", [("realnvp", {}), ("glow", {}), ("flow++", dict(mixtures=2)),
                                     ("resflow", {})])
def test_scanned_2d_model_gets_no_fused_spec(name, kw):
    jm, var, tm = flag_parity(name, (2,), "2d", logp=False, layers=4, base_filters=8,
                              scan=True, **kw)
    assert jm._fused_spec is None
    assert tm.eval_program().stack is None
    unrolled = flag_parity(name, (2,), "2d", logp=False, layers=4, base_filters=8, **kw)
    assert unrolled[0]._fused_spec is not None
    for dst, src in zip(unrolled[2].state_dict().values(), tm.state_dict().values()):
        dst.copy_(src)                      # the same layers in the same order
    assert unrolled[2].eval_program().stack is not None
    x = torch.from_numpy(normal(6, (32, 2)))
    if name != "resflow":       # ResFlow's serving draws: test_trainer_scan_remat_resflow
        close(tm.eval_program().log_prob(x), unrolled[2].eval_program().log_prob(x), 1e-4)
