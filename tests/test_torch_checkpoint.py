"""Checkpoints in nf_tpu's format, on the CPU.

* The port's structure fingerprint of its model and ``TrainState`` equals
  nf_tpu's ``_structure_fingerprint`` of its ``TrainState`` for Adam,
  RMSprop and Adam with weight decay, unrolled and scanned (RealNVP 2-D,
  ``layers=4``: 427 leaves unrolled, 215 scanned).
* nf_tpu trains two steps and saves; the port loads the file and takes
  step 3, held against nf_tpu's step 3; the same the other way round, the
  port saving and nf_tpu's ``load_checkpoint`` reading; for the image
  RealNVP scanned (Adam) and the 2-D RealNVP with RMSprop and weight
  decay.  The loaded state is exact: a save after a load writes the same
  arrays, and the port's step 3 after a load equals, bit for bit, its
  step 3 run on without one.  Step 3 against nf_tpu: the loss rtol 1e-5,
  moments and buffers atol 1e-5, parameters 1e-5 except where the true
  gradient is zero and its f32 noise drives the update (the biases ahead
  of a train-mode batch norm, tests/test_torch_train.py): 1e-3 there,
  NOISE_DRIVEN.  The step resumes the schedule and the generators.
* A file of another structure raises ``ValueError`` (an unrolled file into
  a scanned model, another width), nothing loaded.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_parity import close, normal, uniform

from nf_tpu.config import NetworkConfig as JNC
from nf_tpu.config import OptimizerConfig as JOC
from nf_tpu.models import build_model as jbuild
from nf_tpu.train import Trainer as JTrainer
from nf_tpu.train import load_checkpoint as jload
from nf_tpu.train import save_checkpoint as jsave
from nf_tpu.train.checkpoint import _structure_fingerprint


def _pair(name, dims, datatype, opt, **kw):
    from nf_tpu_torch.config import NetworkConfig, OptimizerConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.train import Trainer

    jm = jbuild(name, dims, datatype=datatype, cfg=JNC(name=name, **kw))
    jt = JTrainer(jm, JOC(**opt), seed=0)
    tm = build_model(name, dims, datatype, NetworkConfig(name=name, **kw), device="cpu")
    return jm, jt, tm, Trainer(tm, OptimizerConfig(**opt), seed=0)


OPTIMIZERS = {"adam": {}, "rmsprop": dict(name="rmsprop"), "adam-wd": dict(weight_decay=0.1)}


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scanned"])
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_fingerprint_is_nf_tpus(opt, scan):
    from nf_tpu_torch.train.checkpoint import structure_fingerprint, train_state_tree

    _, jt, tm, tt = _pair("realnvp", (2,), "2d", OPTIMIZERS[opt], layers=4, scan=scan,
                          remat=scan)
    want = _structure_fingerprint(jt.init_state(jax.random.PRNGKey(0)))
    got = structure_fingerprint(train_state_tree(tm, tt.init_state()))
    assert got == want
    assert len(got) == {("adam", False): 427, ("adam", True): 215}.get((opt, scan), len(got))
    assert got[0] == [".params[1]['net'][0]['b']", [2, 32] if scan else [32], "float32"]
    assert got[-1] == [".step", [], "int32"]


CASES = {   # name: (model, dims, datatype, config, optimizer)
    "realnvp-img-scan": ("realnvp", (8, 8, 1), "image",
                         dict(layers=3, base_filters=8, scan=True, remat=True), {}),
    "realnvp-2d-rmsprop-wd": ("realnvp", (2,), "2d", dict(layers=2, base_filters=8),
                              dict(name="rmsprop", weight_decay=0.05)),
}


def _batches(dims, datatype):
    if datatype == "image":
        return np.stack([uniform(120 + k, (16,) + dims) for k in range(4)])
    return np.stack([normal(130 + k, (64,) + dims) * 1.3 + 0.2 for k in range(4)])


NOISE_DRIVEN = 1e-3


def _tree_close(got, want):
    """nf_tpu TrainStates: parameters within NOISE_DRIVEN and within 1e-5
    on all but a few entries, everything else within 1e-5."""
    gl, gt = jax.tree.flatten_with_path(got)
    wl, wt = jax.tree.flatten(want)
    assert jax.tree.structure(got) == wt
    loose = 0
    for (path, a), b in zip(gl, wl):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if jax.tree_util.keystr(path).startswith(".params"):
            close(a, b, NOISE_DRIVEN)
            loose += int((np.abs(a - b) > 1e-5).sum())
        else:
            close(a, b, 1e-5)
    n = sum(np.size(x) for x in jax.tree.leaves(want.params))
    assert loose <= 0.1 * n, (loose, n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_nf_tpu_file_resumes_in_the_port(case, tmp_path):
    from nf_tpu_torch.train import load_checkpoint, save_checkpoint

    name, dims, datatype, kw, opt = CASES[case]
    jm, jt, tm, tt = _pair(name, dims, datatype, opt, **kw)
    batches = _batches(dims, datatype)
    jts = jt.init_state(jax.random.PRNGKey(0), batches[0])
    for k in (1, 2):
        jts, _ = jt.train_step(jts, batches[k])
    path = str(tmp_path / "nf.npz")
    jsave(path, jts, 2)
    jts3, jloss = jt.train_step(jts, batches[3])

    ts = tt.init_state()
    assert load_checkpoint(path, tm, ts) == 2 and ts.step == 2
    again = str(tmp_path / "again.npz")
    save_checkpoint(again, tm, ts)                     # what was read, written back
    a, b = np.load(path), np.load(again)
    assert sorted(a.files) == sorted(b.files)
    for f in a.files:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    ts, loss = tt.train_step(ts, torch.from_numpy(batches[3]))
    assert ts.step == 3
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    out = str(tmp_path / "port3.npz")
    save_checkpoint(out, tm, ts)
    got, step = jload(out, jts3)
    assert step == 3
    _tree_close(got, jts3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_file_resumes_in_nf_tpu(case, tmp_path):
    from nf_tpu_torch.convert import load_jax_variables
    from nf_tpu_torch.train import load_checkpoint, save_checkpoint

    name, dims, datatype, kw, opt = CASES[case]
    jm, jt, tm, tt = _pair(name, dims, datatype, opt, **kw)
    batches = _batches(dims, datatype)
    jts0 = jt.init_state(jax.random.PRNGKey(0), batches[0])
    var0 = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    ts = tt.init_state(torch.from_numpy(batches[0]), params=load_jax_variables(tm, var0))
    for k in (1, 2):
        ts, _ = tt.train_step(ts, torch.from_numpy(batches[k]))
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, tm, ts)
    resumed, rtt = _pair(name, dims, datatype, opt, **kw)[2:]
    rts = rtt.init_state()
    assert load_checkpoint(path, resumed, rts) == 2
    jts, step = jload(path, jts0)
    assert step == 2 and int(jts.step) == 2
    jts3, jloss = jt.train_step(jts, batches[3])
    ts, loss = tt.train_step(ts, torch.from_numpy(batches[3]))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    out = str(tmp_path / "port3.npz")
    save_checkpoint(out, tm, ts)
    got, _ = jload(out, jts3)
    _tree_close(got, jts3)
    # the port resumed from its own file: step 3 bit for bit the one run on
    assert rtt.schedule(rts.step) == tt.schedule(2)
    assert rtt.step_generator(rts.step).initial_seed() == tt.step_generator(2).initial_seed()
    rts, rloss = rtt.train_step(rts, torch.from_numpy(batches[3]))
    assert torch.equal(rloss, loss) and rts.step == 3
    for a, b in zip(resumed.state_dict().values(), tm.state_dict().values()):
        assert torch.equal(a, b)
    for p, q in zip(resumed.parameters(), tm.parameters()):
        sa, sb = rtt_state(rts, p), rtt_state(ts, q)
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def rtt_state(ts, p):
    return ts.optimizer.state[p]


def test_mismatched_file_raises(tmp_path):
    from nf_tpu_torch.train import load_checkpoint, save_checkpoint

    _, _, tm, tt = _pair("realnvp", (2,), "2d", {}, layers=4, base_filters=8)
    path = str(tmp_path / "unrolled.npz")
    save_checkpoint(path, tm, tt.init_state())
    for kw in (dict(scan=True), dict(base_filters=16)):
        _, _, other, ott = _pair("realnvp", (2,), "2d", {}, layers=4, **{"base_filters": 8,
                                                                        **kw})
        ots = ott.init_state()
        before = [t.clone() for t in other.state_dict().values()]
        with pytest.raises(ValueError, match="structure mismatch"):
            load_checkpoint(path, other, ots)
        assert all(torch.equal(a, b) for a, b in zip(before, other.state_dict().values()))
        assert ots.step == 0
