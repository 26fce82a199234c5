"""Tensor parallelism on the CPU (``nf_tpu_torch/parallel/sharding.py``,
``make_mesh(model_axis)``): the card is one H100, so a model axis past 1
is checked here only, on gloo ranks in subprocesses (this file run as a
script), a ``file://`` rendezvous, one torch thread each.

* The rule: ``tp_shardings`` splits exactly the leaves nf_tpu's
  ``tp_shardings`` splits on a (4, 2) mesh, for RealNVP 2-D, Glow image
  (8x8x1), Flow++ 2-D and ResFlow 2-D at ``base_filters=64``, at least
  one leaf each (so the parity below cannot pass vacuously); the port's
  split axis holds nf_tpu's last one.
* Four ranks as a (2 data x 2 model) mesh: RealNVP 2-D, 4 layers,
  ``base_filters=64``, three Adam steps from nf_tpu's initial variables,
  each data rank on its half of every batch, against nf_tpu's ``Trainer``
  on a (2, 2) mesh of 4 CPU devices and against the port's one process:
  losses within atol 1e-4 and held-out log p within 1e-3, as nf_tpu's
  ``tests/test_tensor_parallel.py`` holds its mesh to one device.  The
  gradient entries whose true value is zero are zeroed in all three runs,
  as ``tests/test_torch_distributed.py`` does (Adam turns their f32 noise
  into lr-sized steps).  The split parameters and their Adam moments hold
  half their rows on each rank of a model group, the two model groups'
  states are equal, and the weights travel by all-gathers.
* The checkpoint rank 0 writes under tensor parallelism loads in nf_tpu
  (its structure fingerprint) and matches the one process's file leaf by
  leaf within atol and rtol 1e-5, moments included; the port loads it back
  into the sharded ranks bit for bit.
"""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHILD_TIMEOUT = 120
KW = dict(name="realnvp", layers=4, base_filters=64)
ROWS = 64


def _builds():
    """family -> (nf_tpu model, port model factory), at base_filters=64."""
    from nf_tpu.config import NetworkConfig as JNC
    from nf_tpu.models import build_model as jbuild
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model

    cases = {"realnvp-2d": ("realnvp", (2,), "2d", dict(layers=4)),
             "glow-8x8x1": ("glow", (8, 8, 1), "image", dict(layers=2)),
             "flow++-2d": ("flow++", (2,), "2d", dict(layers=2, mixtures=4)),
             "resflow-2d": ("resflow", (2,), "2d", dict(layers=2, logdet="exact"))}
    out = {}
    for key, (name, dims, datatype, kw) in cases.items():
        kw = dict(name=name, base_filters=64, **kw)
        out[key] = (jbuild(name, dims, datatype=datatype, cfg=JNC(**kw)),
                    lambda name=name, dims=dims, datatype=datatype, kw=kw: build_model(
                        name, dims, datatype, NetworkConfig(**kw), device="cpu"))
    return out


@pytest.mark.parametrize("family", ["realnvp-2d", "glow-8x8x1", "flow++-2d", "resflow-2d"])
def test_rule_splits_nf_tpus_leaves(family):
    import jax
    from jax.sharding import Mesh as JMesh
    from jax.sharding import NamedSharding

    from nf_tpu.parallel.sharding import tp_shardings as jrule
    from nf_tpu_torch.convert import leaves, variable_tree
    from nf_tpu_torch.parallel import Mesh, tp_shardings

    jmodel, tmodel = _builds()[family]
    var = jmodel.init(jax.random.PRNGKey(0))
    jmesh = JMesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jrule(var, jmesh), is_leaf=lambda x: isinstance(x, NamedSharding))
    want = {jax.tree_util.keystr(p) for p, s in flat if "model" in str(s.spec)}
    model = tmodel()
    got = tp_shardings(model, Mesh(0, 8, torch.device("cpu"), model=2))
    assert set(got) == {jax.tree_util.keystr(p) for p, _ in flat}
    assert {k for k, d in got.items() if d is not None} == want and want, (family, want)
    for path, leaf in leaves(variable_tree(model)):   # the split axis is nf_tpu's last
        if got[path] is not None:
            t = leaf.tensors[0]
            assert t.shape[got[path]] == leaf.shape[-1], path


# ----------------------------------------------------------------- the ranks
def _rank_main(work, rank):
    """One rank of a four-rank gloo group, a (2, 2) mesh."""
    torch.set_num_threads(1)
    from nf_tpu_torch.config import NetworkConfig, OptimizerConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.parallel import (COLLECTIVES, barrier, init_distributed, make_mesh,
                                       shard_batch)
    from nf_tpu_torch.train import Trainer, load_checkpoint, save_checkpoint

    work = pathlib.Path(work)
    assert init_distributed("cpu", f"file://{work / 'rendezvous'}", rank, 4)
    mesh = make_mesh(model_axis=2)
    assert (mesh.data_index, mesh.model_index, mesh.host_data) == (rank // 2, rank % 2, 2)
    spec = torch.load(work / "spec.pt")
    model = build_model("realnvp", (2,), "2d", NetworkConfig(**KW), device="cpu")
    tt = Trainer(model, OptimizerConfig(), mesh=mesh, seed=0)
    batches = spec["batches"]
    ts = tt.init_state(batches[0], params=spec["params"])
    tp = model.tensor_parallel
    split = {n: tp.dims[id(p)] for n, p in model.named_parameters() if id(p) in tp.dims}
    for name, p in model.named_parameters():
        k = spec["keep"][name]
        if name in split:
            k = k.chunk(2, split[name])[mesh.model_index]
        p.register_hook(lambda g, k=k: g * k)
    losses = []
    for b in batches[1:4]:
        ts, loss = tt.train_step(ts, shard_batch(b, mesh))
        losses.append(float(loss))
    logp = tt.log_prob(ts, spec["heldout"])
    state = {n: t.clone() for n, t in model.state_dict().items()}
    moments = {n: ts.optimizer.state[p]["exp_avg"].clone() for n, p in model.named_parameters()}
    save_checkpoint(str(work / "tp.npz"), model, ts)
    barrier()   # rank 0 has written the file
    load_checkpoint(str(work / "tp.npz"), model, ts)
    reloaded = all(torch.equal(t, state[n]) for n, t in model.state_dict().items())
    torch.save({"losses": losses, "logp": logp, "state": state, "moments": moments,
                "split": split, "reloaded": reloaded, "collectives": dict(COLLECTIVES)},
               work / f"rank{rank}.pt")


# ----------------------------------------------------------------- the tests
def test_four_ranks_at_2x2_take_the_one_process_steps(tmp_path):
    import jax
    from _torch_parity import normal, to_numpy
    from jax.sharding import Mesh as JMesh
    from test_torch_distributed import _keep_masks, _masked_nf_tpu_trainer

    from nf_tpu.config import NetworkConfig as JNC
    from nf_tpu.config import OptimizerConfig as JOC
    from nf_tpu.models import build_model as jbuild
    from nf_tpu.train import Trainer as JTrainer
    from nf_tpu.train import load_checkpoint as jload
    from nf_tpu_torch.config import NetworkConfig, OptimizerConfig
    from nf_tpu_torch.convert import export_jax_variables, load_jax_variables
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.train import Trainer, save_checkpoint

    data = np.stack([normal(90 + k, (ROWS, 2)) * 0.7 for k in range(5)])
    batches, heldout = data[:4], data[4][:32]
    jmodel = jbuild("realnvp", (2,), datatype="2d", cfg=JNC(**KW))
    key = jax.random.PRNGKey(0)
    var0 = to_numpy(jmodel.init(key))

    def tmodel():
        return build_model("realnvp", (2,), "2d", NetworkConfig(**KW), device="cpu")

    model = tmodel()
    params = {k: v.clone() for k, v in load_jax_variables(model, var0).items()}
    tt = Trainer(model, OptimizerConfig(), seed=0)
    ts = tt.init_state(torch.from_numpy(batches[0]), params=params)
    keep = _keep_masks(tmodel, model.state_dict(), batches[1])
    torch.save({"params": params, "batches": torch.from_numpy(batches),
                "heldout": torch.from_numpy(heldout), "keep": keep}, tmp_path / "spec.pt")
    procs = [subprocess.Popen([sys.executable, __file__, str(tmp_path), str(r)], cwd=ROOT,
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]

    # meanwhile: the port's one process and nf_tpu's (2, 2) mesh, whole batches
    for name, p in model.named_parameters():
        p.register_hook(lambda g, k=keep[name]: g * k)
    one = []
    for b in batches[1:4]:
        ts, loss = tt.train_step(ts, torch.from_numpy(b))
        one.append(float(loss))
    one_logp = tt.log_prob(ts, heldout)
    save_checkpoint(str(tmp_path / "one.npz"), model, ts)
    mask_model = tmodel()
    mask_model.load_state_dict({**mask_model.state_dict(), **keep})
    jmesh = JMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    jt = _masked_nf_tpu_trainer(JTrainer(jmodel, JOC(), mesh=jmesh, seed=0),
                                export_jax_variables(mask_model)["params"])
    jts = jt.init_state(key, batches[0])
    jlosses = []
    for k in range(1, 4):
        jts, lj = jt.train_step(jts, batches[k])
        jlosses.append(float(lj))
    jlogp = np.asarray(jt.log_prob(jts, heldout))

    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT)
            assert p.returncode == 0, (out, err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(4)]
    got = ranks[0]
    assert got["split"] and all(r["reloaded"] for r in ranks)
    for a, b in ((0, 2), (1, 3)):       # one model index, two data indices: one state
        for k, t in ranks[a]["state"].items():
            assert torch.equal(t, ranks[b]["state"][k]), k
    full = dict(model.state_dict())
    for name, dim in got["split"].items():   # half the rows on each of a model group
        for r in (0, 1):
            want = full[name].chunk(2, dim)[r]
            assert ranks[r]["state"][name].shape == want.shape
            assert ranks[r]["moments"][name].shape == want.shape
    assert got["collectives"]["all_gather"] > 0
    for r in ranks:
        assert r["losses"] == got["losses"]
    np.testing.assert_allclose(got["losses"], one, atol=1e-4)
    np.testing.assert_allclose(got["losses"], jlosses, atol=1e-4)
    np.testing.assert_allclose(got["logp"], one_logp, atol=1e-3)
    np.testing.assert_allclose(got["logp"], jlogp, atol=1e-3)

    # the file rank 0 wrote: nf_tpu reads it; it is the one process's, leaf by leaf
    plain = JTrainer(jmodel, JOC(), seed=0)    # without the masking transform's state
    jts_tp, step = jload(str(tmp_path / "tp.npz"), plain.init_state(key, batches[0]))
    assert step == 3
    tp_file, one_file = np.load(tmp_path / "tp.npz"), np.load(tmp_path / "one.npz")
    assert json.loads(str(tp_file["__structure__"])) == json.loads(str(one_file["__structure__"]))
    leaves_ = [k for k in one_file.files if k.startswith("leaf_")]
    for k in leaves_:
        # the moments are gradients' averages: held as the gradients are
        # (tests/test_torch_distributed.py), atol and rtol 1e-5
        np.testing.assert_allclose(tp_file[k], one_file[k], atol=1e-5, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(np.asarray(plain.log_prob(jts_tp, heldout)), got["logp"],
                               atol=1e-4)


def _env():
    import os

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return env


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _rank_main(sys.argv[1], int(sys.argv[2]))
