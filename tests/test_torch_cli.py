"""The port's training CLI (``nf_tpu_torch/main.py``) against nf_tpu's
``main.py``, on the CPU, each in a working directory of its own.

One nf_tpu checkpoint at step 0 (nf_tpu's ``Trainer``, after its
data-dependent init) starts both CLIs through ``run.ckpt_path``, on the
same data (the loaders draw the same batches), then each resumes with
``run.resume=auto`` to a later step:

* RealNVP 2-D on moons (2 layers, 8 filters, 64 samples, 6 steps then 8),
  ``train.chunk`` 1 and 2;
* RealNVP on ``mnist16`` with ``dequantize`` (1 layer, 8 filters,
  B = 16, 2 steps then 3).

``run.display=0.01`` writes a metric record each step.  Held: the same
(tag, step) sequence in ``metrics.jsonl``, values within rtol 1e-4, in
the first run and after the resume (which re-enters the run directory and
restarts the data stream from its first batch, as nf_tpu's does); each
``latest.npz`` loads in the other package and gives the log p the package
that wrote it gives (1e-5 of the largest |log p|); and the two trainings'
held-out log p within 5e-4 under the batch statistics, and in eval mode
for moons.  The image model's two trainings differ in eval mode by Adam's
steps on the zero-gradient biases (f32 rounding noise near 1e-7, above
Adam's eps, moves them by up to lr a step in each run's own direction:
tests/test_torch_distributed.py, tests/test_train_realnvp.py), which the
running means carry into the eval-mode log p (6.5e-2 at |log p| = 103);
the batch statistics take them out.

Also: the CLI without ``run.platform`` and without a card raises
``RuntimeError``; ``run.debug=true`` raises ``FloatingPointError`` naming
the layer when a parameter is NaN, and with finite weights gives the same
losses and checkpoint fingerprint as a run without it; an unknown
``run.platform`` raises ``ValueError``.
"""
import copy
import glob
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CASES = {   # name: (overrides, steps, resumed steps)
    "moons-chunk1": (["network=realnvp", "network.layers=2", "network.base_filters=8",
                      "run.distrib=moons", "train.samples=64", "train.chunk=1"], 6, 8),
    "moons-chunk2": (["network=realnvp", "network.layers=2", "network.base_filters=8",
                      "run.distrib=moons", "train.samples=64", "train.chunk=2"], 6, 8),
    "mnist16-dequantize": (["network=realnvp", "network.layers=1", "network.base_filters=8",
                            "run.distrib=mnist16", "run.dequantize=true", "train.samples=16",
                            "train.chunk=1"], 2, 3),
}
COMMON = ["run.display=0.01", "run.seed=3"]


@pytest.fixture
def jax_config_restored(monkeypatch, tmp_path):
    """nf_tpu's main sets the persistent compile cache under HOME: keep it
    in tmp_path and set jax's config back after the test."""
    import jax

    monkeypatch.setenv("HOME", str(tmp_path))
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _nf_side(argv):
    """nf_tpu's model, Trainer and a TrainState like the CLI's, from ``argv``."""
    import jax

    from nf_tpu.config import parse_cli
    from nf_tpu.data import FlowDataLoader
    from nf_tpu.models import build_model
    from nf_tpu.train import Trainer

    cfg = parse_cli(argv)
    dl = FlowDataLoader(cfg.run.distrib, batch_size=cfg.train.samples, seed=cfg.run.seed,
                        dequantize=cfg.run.dequantize)
    model = build_model(cfg.network.name, dl.dims, datatype=dl.dtype, cfg=cfg.network)
    tr = Trainer(model, cfg.optimizer, seed=cfg.run.seed)
    ts = tr.init_state(jax.random.PRNGKey(cfg.run.seed), dl.next_batch())
    return model, tr, ts, dl


def _port_side(argv):
    from nf_tpu_torch.config import parse_cli
    from nf_tpu_torch.data import FlowDataLoader
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.train import Trainer

    cfg = parse_cli(argv)
    dl = FlowDataLoader(cfg.run.distrib, batch_size=cfg.train.samples, seed=cfg.run.seed,
                        dequantize=cfg.run.dequantize)
    model = build_model(cfg.network.name, dl.dims, dl.dtype, cfg.network, device="cpu")
    tr = Trainer(model, cfg.optimizer, seed=cfg.run.seed)
    return model, tr, tr.init_state(), dl


def _heldout(dl):
    for _ in range(3):
        dl.next_batch()
    return dl.next_batch()


def _logps(path, nf, port, x):
    """Eval-mode log p of ``x`` under the checkpoint ``path`` read by each
    package, and the port's log p under its batch statistics."""
    from nf_tpu.train import load_checkpoint as jload
    from nf_tpu_torch.train import load_checkpoint

    jmodel, jtr, jts, _ = nf
    jts, _ = jload(path, jts)
    model, tr, ts, _ = port
    load_checkpoint(path, model, ts)
    train_mode = copy.deepcopy(model).train()
    with torch.no_grad():
        batch_stats = train_mode.log_prob(torch.from_numpy(x))
    return np.asarray(jtr.log_prob(jts, x)), tr.log_prob(ts, x).numpy(), batch_stats.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_matches_nf_tpus_main(case, tmp_path, monkeypatch, jax_config_restored):
    import main as jmain
    from nf_tpu.train import save_checkpoint as jsave
    from nf_tpu_torch import main as tmain

    overrides, steps, resumed = CASES[case]
    argv = overrides + COMMON
    jmodel, jtr, jts, jdl = _nf_side(argv)
    start = str(tmp_path / "start.npz")
    jsave(start, jts, 0)

    runs = {}
    for who, fn, extra in (("nf_tpu", jmain.main, []),
                           ("port", tmain.main, ["run.platform=cpu"])):
        cwd = tmp_path / who
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        first = fn(argv + extra + [f"train.steps={steps}", f"run.ckpt_path={start}"])
        n_first = len(_records(first))
        again = fn(argv + extra + [f"train.steps={resumed}", "run.resume=auto"])
        assert again == first, "run.resume=auto must re-enter the run directory"
        assert len(glob.glob(str(cwd / "logs" / "*"))) == 1
        ck = np.load(os.path.join(cwd, first, "latest.npz"))
        assert int(ck["__step__"]) == resumed
        runs[who] = (os.path.join(cwd, first), n_first)

    (jdir, jn), (tdir, tn) = runs["nf_tpu"], runs["port"]
    jrec, trec = _records(jdir), _records(tdir)
    assert tn == jn
    assert [(r["tag"], r["step"]) for r in trec] == [(r["tag"], r["step"]) for r in jrec]
    steps_logged = [r["step"] for r in trec if r["tag"].endswith("/train/loss")]
    assert steps_logged[-1] == resumed and len(steps_logged) >= 3
    np.testing.assert_allclose([r["value"] for r in trec], [r["value"] for r in jrec],
                               rtol=1e-4)
    if "mnist16" in case:
        tags = {r["tag"] for r in trec}
        assert tags == {"image/train/loss", "image/train/bits_per_dim",
                        "image/train/bits_per_dim_discrete"}

    x = _heldout(jdl)
    nf, port = (jmodel, jtr, jts, None), _port_side(argv)
    j_on_j, t_on_j, bs_j = _logps(os.path.join(jdir, "latest.npz"), nf, port, x)
    j_on_t, t_on_t, bs_t = _logps(os.path.join(tdir, "latest.npz"), nf, port, x)
    scale = float(np.abs(j_on_j).max())
    np.testing.assert_allclose(t_on_j, j_on_j, atol=1e-5 * scale)   # nf_tpu's file in the port
    np.testing.assert_allclose(j_on_t, t_on_t, atol=1e-5 * scale)   # the port's in nf_tpu
    np.testing.assert_allclose(bs_t, bs_j, atol=5e-4)
    if "moons" in case:   # 1.2e-4 apart here; the image model's 6.5e-2 (the noise)
        np.testing.assert_allclose(t_on_t, j_on_j, atol=5e-4)


def test_cli_needs_a_card_or_run_platform(tmp_path, monkeypatch):
    from nf_tpu_torch import main as tmain

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="run.platform=cpu"):
        tmain.main(["network=realnvp", "run.distrib=moons", "train.steps=1"])
    with pytest.raises(ValueError, match="run.platform"):
        tmain.main(["network=realnvp", "run.distrib=moons", "run.platform=tpu"])
    assert not (tmp_path / "logs").exists()


DEBUG = ["network=realnvp", "network.layers=2", "network.base_filters=8", "run.distrib=moons",
         "train.samples=32", "train.steps=3", "run.display=0.01", "run.platform=cpu"]


def test_debug_names_the_layer_of_a_nan(tmp_path, monkeypatch):
    from nf_tpu_torch import main as tmain
    from nf_tpu_torch.train import save_checkpoint

    model, tr, ts, dl = _port_side(DEBUG)
    tr.init_state(dl.next_batch())
    with torch.no_grad():
        model.bijector.layers[1].s_log_scale.fill_(float("nan"))
    bad = str(tmp_path / "nan.npz")
    save_checkpoint(bad, model, ts)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FloatingPointError, match=r"layer1:AffineCoupling\.forward"):
        tmain.main(DEBUG + ["run.debug=true", f"run.ckpt_path={bad}"])
    assert not torch.is_anomaly_enabled()
    run_dir = tmain.main(DEBUG + [f"run.ckpt_path={bad}"])   # no probes: it runs on
    assert np.isnan([r["value"] for r in _records(run_dir)]).all()


def test_debug_changes_nothing_with_finite_weights(tmp_path, monkeypatch):
    from nf_tpu_torch import main as tmain

    out = {}
    for debug in (False, True):
        cwd = tmp_path / str(debug)
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        run_dir = tmain.main(DEBUG + [f"run.debug={debug}"])
        ck = np.load(cwd / run_dir / "latest.npz")
        out[debug] = ([r["value"] for r in _records(cwd / run_dir)], str(ck["__structure__"]))
    assert out[True] == out[False]
    assert len(out[True][0]) == 3
