"""Data parallelism over torch.distributed, on the CPU: two gloo ranks,
each a subprocess (this file run as a script), with a ``file://``
rendezvous under ``tmp_path``, one torch thread each and a 120 s limit.

* Two ranks at b rows each take the step one process takes at 2b rows:
  RealNVP 2-D (the flow ``BatchNorm``) and RealNVP 16x16x1 at 1 layer and
  8 filters (``BatchNormNet`` in the conv nets), three Adam steps from
  nf_tpu's initial variables, each rank on its half of every batch (the
  data-dependent init on the first batch, whole, on every rank), against
  the port's one process on the whole batches and nf_tpu's
  ``Trainer(mesh=make_mesh(jax.devices()[:2]))``: the loss within rtol
  2e-5 per step, the first step's gradients within 1e-5 of the one
  process's, held-out log p within 5e-4, every running mean and variance
  within 1e-5 after the first step and the third, and the two ranks'
  states equal bit for bit.
  The gradient entries whose true value is zero (the biases ahead of a
  train-mode batch norm: |g| below 1e-6 of the largest entry in float64)
  are zeroed in all three runs (a gradient hook here, a masking transform
  chained before nf_tpu's optax Adam): f32 leaves rounding noise near
  1e-7 there, above Adam's eps, which Adam turns into steps of up to lr
  in each run's own direction (tests/test_train_realnvp.py,
  ``_torch_parity.NOISE_DRIVEN``), and the eval-mode log p and the
  running means downstream of them would differ by that noise, not by
  the data parallelism.  Raw parameters are not compared.
* The init broadcast: Glow 2-D's data-dependent init on each rank's own
  batch leaves different parameters; after ``Trainer.init_state`` they
  are rank 0's on both (tests/test_distributed_init.py's counterpart).
* ``python -m nf_tpu_torch.parallel.launch`` forms the group from the
  environment (torchrun's variables), and a two-rank CLI run writes
  ``metrics.jsonl``, ``latest.npz`` and the report's JPEG files on rank 0
  only.
* The collectives in one process (a world of one): ``sum_gradients``
  keeps a None gradient None, ``replicate`` carries a bool buffer,
  ``shard_batch`` refuses a batch that does not split, and
  ``all_reduce_sum`` passes the gradient.
* Noise on the ranks of one host: two ranks at b rows each against the
  port's one process at 2b rows with the same seed, three Adam steps each
  from one initial state: MAF with ``resample_masks`` on 4-D density data
  (at D = 2 its masks cannot vary; the masks of every draw equal on both
  ranks and in the one process, and not all alike), ResFlow 2-D (the
  probes this rank's rows of the host's draw, the series lengths shared)
  and FFJORD 2-D (1 CNF, dopri5 at 1e-4, its ODENet's weights scaled by 3
  so that the step sizes follow the rows: every solve's accepted and
  rejected steps equal, the adjoint's parameter adjoints summed over the
  ranks in the error norm); the two ranks' halves of each batch at two
  scales (0.3 and 3); losses within rtol 2e-5.
* The CLI through the launcher on one gloo rank forms no mesh: 0
  all-reduces.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHILD_TIMEOUT = 120

# name: (dims, datatype, layers, filters, rows of the whole batch)
MODELS = {"realnvp-2d": ((2,), "2d", 4, 16, 128),
          "realnvp-16x16x1": ((16, 16, 1), "image", 1, 8, 16)}
# the families that draw noise while they train: name -> NetworkConfig fields;
# MAF on 4-D density data, where the masks' draws vary (at D = 2 every
# hidden degree is 0, so MAF 2-D draws one fixed mask)
NOISE = {"maf": dict(name="maf", layers=2, base_filters=16, resample_masks=True),
         "resflow": dict(name="resflow", layers=2, base_filters=16),
         "ffjord": dict(name="ffjord", layers=1, base_filters=8, stepsize=0.5,
                        solver="dopri5", rtol=1e-4, atol=1e-4)}
FFJORD_GAIN = 3.0    # the ODENet's weights scaled: dynamics whose steps follow the rows
NOISE_ROWS = 64      # the host's batch; 32 a rank
NOISE_DIMS = {"maf": 4, "resflow": 2, "ffjord": 2}


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **extra)
    env.pop("XLA_FLAGS", None)
    return env


def _run_ranks(cmds, cwd, envs=None):
    """Start one process per command, wait for all; returns their stdouts."""
    procs = [subprocess.Popen(cmd, cwd=cwd, env=(envs or [_env()] * len(cmds))[i],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i, cmd in enumerate(cmds)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT)
            assert p.returncode == 0, (out, err)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def _child(mode, work, rank):
    return [sys.executable, __file__, mode, str(work), str(rank)]


# ----------------------------------------------------------------- the ranks
def _rank_main(mode, work, rank):
    """One rank of a two-rank gloo group (this file run as a script)."""
    torch.set_num_threads(1)
    from nf_tpu_torch.config import NetworkConfig, OptimizerConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.parallel import COLLECTIVES, init_distributed, make_mesh, shard_batch
    from nf_tpu_torch.train import Trainer

    work = pathlib.Path(work)
    assert init_distributed("cpu", f"file://{work / 'rendezvous'}", rank, 2)
    mesh = make_mesh()
    assert (mesh.rank, mesh.world, mesh.device.type) == (rank, 2, "cpu")
    if mode in NOISE:
        batches = torch.load(work / "batches.pt")
        out = _noise_run(mode, mesh, [shard_batch(b, mesh) for b in batches[1:]], batches[0])
        torch.save(out, work / f"rank{rank}.pt")
        return
    if mode == "init":
        cfg = NetworkConfig(name="glow", layers=4, base_filters=16)
        batch = torch.from_numpy(np.random.default_rng(rank).standard_normal((64, 2))
                                 .astype(np.float32) * (1 + rank))

        def digest(m):
            return float(sum(p.detach().double().abs().sum() for p in m.parameters()))

        model = build_model("glow", (2,), "2d", cfg, device="cpu")
        model.init(torch.Generator().manual_seed(0))
        model.data_dependent_init(batch)
        raw = digest(model)
        model = build_model("glow", (2,), "2d", cfg, device="cpu")
        Trainer(model, OptimizerConfig(), mesh=mesh, seed=0).init_state(batch)
        print(json.dumps({"rank": rank, "raw": raw, "final": digest(model)}))
        return
    spec = torch.load(work / "spec.pt")
    dims, datatype, layers, filters, _ = MODELS[mode]
    model = build_model("realnvp", dims, datatype,
                        NetworkConfig(name="realnvp", layers=layers, base_filters=filters),
                        device="cpu")
    tt = Trainer(model, OptimizerConfig(), mesh=mesh, seed=0)
    batches = spec["batches"]
    ts = tt.init_state(batches[0], params=spec["params"])
    out = _three_steps(tt, ts, [shard_batch(b, mesh) for b in batches[1:4]], spec["keep"])
    torch.save({**out, "logp": tt.log_prob(ts, spec["heldout"]),
                "collectives": dict(COLLECTIVES)}, work / f"rank{rank}.pt")


def _three_steps(tt, ts, batches, keep):
    """Three steps with the zero-gradient entries' gradients zeroed;
    returns the losses, the first step's gradients and the state after
    the first step and after the third."""
    model = tt.model
    for name, p in model.named_parameters():
        p.register_hook(lambda g, k=keep[name]: g * k)
    losses = []
    for k, batch in enumerate(batches):
        ts, loss = tt.train_step(ts, batch)
        losses.append(float(loss))
        if k == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            first = {n: t.clone() for n, t in model.state_dict().items()}
    return {"losses": losses, "grads": grads, "first": first, "state": model.state_dict()}


def _noise_run(family, mesh, batches, first):
    """Three Adam steps of ``family`` 2-D from seed 0 (the data-dependent
    init on ``first``, the host's whole batch); returns the losses, the
    MAF masks drawn and the CNFs' step counts per step."""
    from nf_tpu_torch.bijectors import made
    from nf_tpu_torch.bijectors.cnf import CNF
    from nf_tpu_torch.config import NetworkConfig, OptimizerConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.train import Trainer

    torch.manual_seed(0)
    dims = (NOISE_DIMS[family],)
    model = build_model(family, dims, "2d", NetworkConfig(**NOISE[family]), device="cpu")
    tt = Trainer(model, OptimizerConfig(), mesh=mesh, seed=0)
    masks = []
    draw = made.MADE.sample_masks

    def recorded(self, g):
        out = draw(self, g)
        masks.append([m.clone() for m in out])
        return out

    made.MADE.sample_masks = recorded
    try:
        ts = tt.init_state(first)
        masks.clear()
        cnfs = [m for m in model.modules() if isinstance(m, CNF)]
        with torch.no_grad():
            for m in cnfs:
                for w in m.net.w:
                    w.mul_(FFJORD_GAIN)
        losses, steps = [], []
        for b in batches:
            for m in cnfs:
                m.stats = type(m.stats)()
            ts, loss = tt.train_step(ts, b)
            losses.append(float(loss))
            steps.append([(m.stats.solves, m.stats.accepted, m.stats.rejected) for m in cnfs])
    finally:
        made.MADE.sample_masks = draw
    return {"losses": losses, "masks": masks, "steps": steps}


# ----------------------------------------------------------------- the tests
def _batches(dims, datatype, rows):
    from _torch_parity import normal, uniform

    if datatype == "image":
        return np.stack([uniform(40 + k, (rows,) + dims) for k in range(5)])
    return np.stack([normal(50 + k, (rows,) + dims) * 1.3 + 0.2 for k in range(5)])


ZERO_GRADIENT = 1e-6   # of the largest first-step gradient entry, in float64


def _keep_masks(make_model, state, batch):
    """1 for each gradient entry of a true value, 0 where the true value
    is zero: |g| <= ZERO_GRADIENT x the largest entry of the first step's
    float64 gradient of ``state`` on ``batch``."""
    m = make_model()
    m.load_state_dict(state)
    m = m.double().train()
    (-m.log_prob(torch.from_numpy(batch).double()).mean()).backward()
    scale = max(float(p.grad.abs().max()) for p in m.parameters())
    return {n: (p.grad.abs() > ZERO_GRADIENT * scale).float() for n, p in m.named_parameters()}


def _masked_nf_tpu_trainer(jt, keep_tree):
    """nf_tpu's Trainer with its optimizer's gradients multiplied by
    ``keep_tree`` first (before the first step traces it)."""
    import jax
    import optax

    def update(updates, state, params=None):
        return jax.tree.map(lambda g, k: g * k, updates, keep_tree), state

    jt.optimizer = optax.chain(optax.GradientTransformation(lambda p: optax.EmptyState(),
                                                            update), jt.optimizer)
    return jt


@pytest.mark.parametrize("mode", sorted(MODELS))
def test_two_ranks_take_the_one_process_step(mode, tmp_path):
    import jax
    from _torch_parity import to_numpy

    from nf_tpu.config import NetworkConfig as JNC
    from nf_tpu.config import OptimizerConfig as JOC
    from nf_tpu.models import build_model as jbuild
    from nf_tpu.parallel import make_mesh as jmesh
    from nf_tpu.train import Trainer as JTrainer
    from nf_tpu_torch.config import NetworkConfig, OptimizerConfig
    from nf_tpu_torch.convert import export_jax_variables, load_jax_variables
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.train import Trainer

    dims, datatype, layers, filters, rows = MODELS[mode]
    data = _batches(dims, datatype, rows)
    batches, heldout = data[:4], data[4]
    kw = dict(name="realnvp", layers=layers, base_filters=filters)
    jmodel = jbuild("realnvp", dims, datatype=datatype, cfg=JNC(**kw))
    key = jax.random.PRNGKey(0)
    var0 = to_numpy(jmodel.init(key))

    def tmodel():
        return build_model("realnvp", dims, datatype, NetworkConfig(**kw), device="cpu")

    model = tmodel()
    # a copy: the dict load_jax_variables returns holds the model's own tensors
    params = {k: v.clone() for k, v in load_jax_variables(model, var0).items()}
    tt = Trainer(model, OptimizerConfig(), seed=0)
    ts = tt.init_state(torch.from_numpy(batches[0]), params=params)
    keep = _keep_masks(tmodel, model.state_dict(), batches[1])
    assert 0 < sum(int((k == 0).sum()) for k in keep.values()) < \
        sum(k.numel() for k in keep.values()) // 10
    torch.save({"params": params, "batches": torch.from_numpy(batches),
                "heldout": torch.from_numpy(heldout), "keep": keep}, tmp_path / "spec.pt")
    procs = [subprocess.Popen(_child(mode, tmp_path, r), cwd=ROOT, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]

    # meanwhile: the port's one process and nf_tpu's two-device mesh, whole batches
    one = _three_steps(tt, ts, [torch.from_numpy(b) for b in batches[1:4]], keep)
    one_logp = tt.log_prob(ts, heldout)
    mask_model = tmodel()
    mask_model.load_state_dict({**mask_model.state_dict(), **keep})
    keep_tree = export_jax_variables(mask_model)["params"]
    jt = _masked_nf_tpu_trainer(JTrainer(jmodel, JOC(), mesh=jmesh(jax.devices()[:2]), seed=0),
                                keep_tree)
    jts = jt.init_state(key, batches[0])
    jlosses, jstates = [], []
    for k in range(1, 4):
        jts, lj = jt.train_step(jts, batches[k])
        jlosses.append(float(lj))
        ref = tmodel()
        load_jax_variables(ref, to_numpy(jts.var))
        jstates.append(ref.state_dict())
    jlogp = torch.from_numpy(np.array(jt.log_prob(jts, heldout)))

    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT)
            assert p.returncode == 0, (out, err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for key_, a in ranks[0]["state"].items():
        assert torch.equal(a, ranks[1]["state"][key_]), key_
    assert ranks[0]["losses"] == ranks[1]["losses"]
    got = ranks[0]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=2e-5)
    np.testing.assert_allclose(got["losses"], jlosses, rtol=2e-5)
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g, one["grads"][name], atol=1e-5, rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(got["logp"], one_logp, atol=5e-4)
    np.testing.assert_allclose(got["logp"], jlogp, atol=5e-4)
    stats = [k for k in got["state"] if k.endswith(("running_mean", "running_var"))]
    assert len(stats) >= 2 * layers
    for when, ours, want in (("first", got["first"], (one["first"], jstates[0])),
                             ("third", got["state"], (one["state"], jstates[2]))):
        for k in stats:
            for ref in want:
                np.testing.assert_allclose(ours[k], ref[k], atol=1e-5, err_msg=f"{when} {k}")
    # per step: the gradients' one flat all-reduce, the loss's, two for each
    # batch norm's statistics and two more in the backward of each whose
    # input carries a gradient; the init's broadcasts (one per dtype)
    n_bn = sum(k.endswith("running_mean") for k in got["state"])
    per_step, rest = divmod(got["collectives"]["all_reduce"], 3)
    assert rest == 0 and 2 + 2 * n_bn < per_step <= 2 + 4 * n_bn, (per_step, n_bn)
    assert got["collectives"]["broadcast"] == len({t.dtype for t in got["state"].values()})


@pytest.mark.parametrize("family", sorted(NOISE))
def test_ranks_of_a_host_draw_the_one_process_noise(family, tmp_path):
    from _torch_parity import normal

    # the ranks' halves at two scales, so their own error norms would
    # choose other steps than the whole batch's
    half = (NOISE_ROWS // 2, NOISE_DIMS[family])
    batches = torch.from_numpy(np.stack([np.concatenate([normal(70 + k, half) * 0.3,
                                                         normal(80 + k, half) * 3.0])
                                         for k in range(4)]))
    torch.save(batches, tmp_path / "batches.pt")
    procs = [subprocess.Popen(_child(family, tmp_path, r), cwd=ROOT, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    one = _noise_run(family, None, list(batches[1:]), batches[0])
    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT)
            assert p.returncode == 0, (out, err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=2e-5)
    if family == "maf":     # 3 steps x 2 layers x 2 MADEs, the same masks everywhere
        assert len(one["masks"]) == 12 and len(ranks[0]["masks"]) == 12
        assert any(not torch.equal(a[0], one["masks"][0][0]) for a in one["masks"][1:])
        for got in (ranks[0]["masks"], ranks[1]["masks"]):
            for a, b in zip(got, one["masks"]):
                assert all(torch.equal(x, y) for x, y in zip(a, b))
    if family == "ffjord":  # the forward's and the adjoint's solves, step for step
        assert ranks[0]["steps"] == ranks[1]["steps"] == one["steps"], \
            (ranks[0]["steps"], ranks[1]["steps"], one["steps"])
        assert all(solves == 2 for step in one["steps"] for solves, _, _ in step)


def test_cli_on_one_rank_forms_no_mesh(tmp_path):
    args = ["network=realnvp", "network.layers=2", "network.base_filters=8",
            "run.distrib=moons", "train.samples=32", "train.steps=2", "run.display=1",
            "run.platform=cpu"]
    env = _env(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    cmd = [sys.executable, "-m", "nf_tpu_torch.parallel.launch",
           str(ROOT / "nf_tpu_torch" / "main.py")] + args
    out, = _run_ranks([cmd], tmp_path, [env])
    assert "process group: backend gloo, world 1, 0 all-reduces, 0 broadcasts" in out, out


def test_init_broadcasts_rank0s_state(tmp_path):
    outs = _run_ranks([_child("init", tmp_path, r) for r in range(2)], ROOT)
    res = {d["rank"]: d for d in (json.loads(o.strip().splitlines()[-1]) for o in outs)}
    assert set(res) == {0, 1}
    assert abs(res[0]["raw"] - res[1]["raw"]) > 1e-6, res    # dd-init on different batches
    assert res[0]["final"] == res[1]["final"], res            # ... erased by the broadcast
    assert res[0]["final"] == res[0]["raw"]                   # rank 0's own


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_launch_runs_the_cli_data_parallel(tmp_path):
    args = ["network=realnvp", "network.layers=2", "network.base_filters=8",
            "run.distrib=moons", "train.samples=32", "train.steps=3", "run.display=1",
            "run.platform=cpu"]
    port = str(_free_port())
    envs = [_env(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=port) for r in range(2)]
    cmd = [sys.executable, "-m", "nf_tpu_torch.parallel.launch",
           str(ROOT / "nf_tpu_torch" / "main.py")] + args
    outs = _run_ranks([cmd, cmd], tmp_path, envs)
    for out in outs:
        assert "process group: backend gloo, world 2," in out, out
    runs = sorted((tmp_path / "logs").iterdir())
    panels = [f"{n}_{s}.jpg" for n in ("y_data", "y_dist", "y_sample", "z_sample")
              for s in ("000001", "latest")]
    assert len(runs) == 1 and sorted(p.name for p in runs[0].iterdir()
                                      if not p.name.startswith("events.")) \
        == sorted(["latest.npz", "metrics.jsonl"] + panels)
    recs = [json.loads(line) for line in (runs[0] / "metrics.jsonl").read_text().splitlines()]
    assert [(r["tag"], r["step"]) for r in recs] == [("2d/train/loss", 1)]
    assert int(np.load(runs[0] / "latest.npz")["__step__"]) == 3


def test_launch_without_a_group_refuses(tmp_path):
    env = _env()
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    out = subprocess.run([sys.executable, "-m", "nf_tpu_torch.parallel.launch", "x.py"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 2 and "no process group" in out.stderr


def test_collectives_in_one_process(tmp_path):
    import torch.distributed as dist

    from nf_tpu_torch.bijectors.norm import ActNorm
    from nf_tpu_torch.parallel import (COLLECTIVES, Mesh, global_mean, init_distributed,
                                       make_mesh, replicate, shard_batch, sum_gradients)
    from nf_tpu_torch.parallel.distributed import all_reduce_sum, host_seed

    assert not dist.is_initialized()
    assert init_distributed("cpu", f"file://{tmp_path / 'rendezvous'}", 0, 1)
    try:
        before = dict(COLLECTIVES)
        mesh = make_mesh()
        assert mesh == Mesh(0, 1, torch.device("cpu"), None)
        norm = ActNorm(3)
        norm.initialized.fill_(True)
        norm.bias.data = torch.tensor([1.0, -2.0, 3.0])
        replicate(norm, mesh)
        assert norm.initialized.dtype == torch.bool and bool(norm.initialized)
        assert norm.bias.tolist() == [1.0, -2.0, 3.0]
        rows = torch.arange(6.0).view(6, 1)
        assert torch.equal(shard_batch(rows, mesh), rows)
        assert torch.equal(shard_batch(rows, Mesh(1, 2, mesh.device)), rows[3:])
        with pytest.raises(ValueError, match="does not split"):
            shard_batch(rows[:5], Mesh(1, 2, mesh.device))
        a, b = torch.nn.Parameter(torch.ones(2)), torch.nn.Parameter(torch.ones(3))
        a.grad = torch.tensor([0.5, -1.5])
        sum_gradients([a, b], mesh)
        assert a.grad.tolist() == [0.5, -1.5] and b.grad is None
        assert float(global_mean(torch.tensor(2.5), mesh)) == 2.5
        x = torch.tensor([1.0, 2.0], requires_grad=True)
        y = all_reduce_sum(x * 2)
        assert y.tolist() == [2.0, 4.0]
        (3 * y).sum().backward()
        assert x.grad.tolist() == [6.0, 6.0]
        # sum_gradients, global_mean, all_reduce_sum's forward and backward
        assert COLLECTIVES["all_reduce"] - before["all_reduce"] == 4
        assert COLLECTIVES["broadcast"] - before["broadcast"] == 2   # f32 and bool
        assert host_seed(5, 0) != host_seed(5, 1)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _rank_main(sys.argv[1], sys.argv[2], int(sys.argv[3]))
