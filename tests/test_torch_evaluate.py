"""The port's held-out evaluators (``nf_tpu_torch/evaluate.py``) against
nf_tpu's ``scripts/eval_nll.py`` and ``scripts/eval_image_nll.py``, on the
CPU, over one checkpoint file per case.

nf_tpu writes each file (``Trainer.init_state``, one Adam step,
``save_checkpoint``); its script, imported by path and run in ``tmp_path``
with ``HOME`` there (the scripts turn on JAX's compile cache, whose config
is set back afterwards), and the port's ``main`` with ``platform=cpu``,
in a directory of its own, both read it:

* densities: RealNVP and ResFlow with ``logdet=exact`` (the ``unbias``
  eval probes cannot match) on ``normals``; MAF with ``resample`` on
  ``swiss`` (D = 3: at D = 2 every mask draw is the same), nf_tpu's
  masks for each batch's key ``fold_in(PRNGKey(4242), row)`` injected into
  the port's ``MADE.sample_masks``.  The held-out NLL within 1e-5
  relative of the JSON the script wrote; the port writes
  ``PARITY_nf_tpu_torch_<tag>.json`` and no ``PARITY_nf_tpu_*`` file.
* images on ``mnist16``: RealNVP with ``layers=1``, scanned and remat
  (the script's defaults) and unrolled, 2 draws; Flow++ with
  ``vardequant``, nf_tpu's eps for each batch's key
  ``fold_in(fold_in(PRNGKey(777001), draw * 100000 + image), 0)`` (the
  head is chain child 0) injected into ``VariationalDequant.injected_eps``.
  Both bits/dim within 1e-5 relative.

To fit the file's time, the networks' defaults are narrowed in both
packages (``NETWORK_DEFAULTS``: RealNVP, ResFlow and MAF 2 layers of 8
filters, Flow++ 8 filters and 2 mixtures; the image cases take
``layers=1``) and both image modules' held-out set cut to 512 images
(two batches): the scripts read both at run time.

Also: the refusal (``SystemExit`` with nf_tpu's message) when real IDX
files sit under ``data_root``; a ``RuntimeError`` without a card unless
``platform=cpu`` / ``device="cpu"``; ``evaluate.py`` imports no ``jax``
and nothing of nf_tpu.
"""
import ast
import functools
import importlib.util
import json
import os
import pathlib
import struct
import sys

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(layers=2, base_filters=8)
IMAGE_HELDOUT = 512        # two batches of 256 (N_HELDOUT is 2048)
RTOL = 1e-5


@functools.cache
def script(name):
    spec = importlib.util.spec_from_file_location(f"nf_tpu_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def narrowed(monkeypatch, tmp_path):
    """Both packages' network defaults narrowed, HOME and the working
    directory in tmp_path, jax's compile-cache config set back after."""
    from nf_tpu import config as jconfig
    from nf_tpu_torch import config as tconfig

    for defaults in (jconfig.NETWORK_DEFAULTS, tconfig.NETWORK_DEFAULTS):
        for name in ("realnvp", "resflow", "maf"):
            monkeypatch.setitem(defaults, name, {**defaults[name], **SMALL})
        monkeypatch.setitem(defaults, "flow++", {**defaults["flow++"], "base_filters": 8,
                                                 "mixtures": 2})
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield tmp_path
    for k, v in saved.items():
        jax.config.update(k, v)


def nf_checkpoint(path, network, dims, datatype, batches, **cfg_kw):
    """nf_tpu's Trainer.init_state on batches[0], one Adam step on
    batches[1], then nf_tpu's save_checkpoint."""
    from nf_tpu.config import NETWORK_DEFAULTS, NetworkConfig, OptimizerConfig
    from nf_tpu.models import build_model
    from nf_tpu.train import Trainer, save_checkpoint

    cfg = NetworkConfig(name=network, **{**NETWORK_DEFAULTS[network], **cfg_kw})
    model = build_model(network, dims, datatype=datatype, cfg=cfg)
    tr = Trainer(model, OptimizerConfig(), seed=0)
    ts = tr.init_state(jax.random.PRNGKey(0), batches[0])
    ts, _ = tr.train_step(ts, batches[1])
    save_checkpoint(str(path), ts, int(ts.step))
    return str(path)


def run_script(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    return script(name).main()


def capture_restore(monkeypatch):
    """The trainers the port's evaluator restores, in order."""
    from nf_tpu_torch import evaluate

    trainers = []
    restore = evaluate.restore

    def recorded(*args):
        out = restore(*args)
        trainers.append(out[0])
        return out

    monkeypatch.setattr(evaluate, "restore", recorded)
    return trainers


def inject_maf_masks(monkeypatch):
    """Each batch's generator hands the port's MADEs the masks nf_tpu draws
    for the batch's key, layer by layer (``nf_layer_keys``) and net_s /
    net_t as chain children 0 / 1.  Draws outside a batch (the
    data-dependent init's, which the checkpoint overwrites) are the port's."""
    from _torch_parity import nf_layer_keys

    from nf_tpu.bijectors import made as jmade
    from nf_tpu_torch import evaluate
    from nf_tpu_torch.bijectors import made as tmade

    trainers = capture_restore(monkeypatch)
    pending, keys = [], []
    make = evaluate.noise_generator
    sample = tmade.MADE.sample_masks

    def noise_generator(device, *ints):
        assert not pending, "a batch left masks undrawn"
        key = jax.random.fold_in(jax.random.PRNGKey(ints[0]), ints[1])
        keys.append(ints)
        for m, k in nf_layer_keys(trainers[-1].model.bijector, key):
            if isinstance(m, tmade.AutoregressiveTransform):
                sampler = jmade.MADE(m.d, m.net_s.num_hidden, m.net_s.hidden_dims[0],
                                     resample_masks=True)
                for j in (0, 1):
                    masks = sampler._sample_masks_traced(jax.random.fold_in(k, j))
                    pending.append([torch.from_numpy(np.array(a).T.copy()) for a in masks])
        return make(device, *ints)

    monkeypatch.setattr(evaluate, "noise_generator", noise_generator)
    monkeypatch.setattr(tmade.MADE, "sample_masks",
                        lambda self, g: pending.pop(0) if pending else sample(self, g))
    return keys, pending


TWO_D = {   # case: (network, data set, eval_nll.py's extra arguments, checkpoint config)
    "realnvp": ("realnvp", "normals", [], {}),
    "resflow-exact": ("resflow", "normals", ["exact"], dict(logdet="exact")),
    # at D = 2 every draw of MADE's masks is the same: D = 3 draws apart
    "maf-resample": ("maf", "swiss", ["resample"], dict(resample_masks=True)),
}


@pytest.mark.parametrize("case", sorted(TWO_D))
def test_heldout_nll_matches_eval_nll(case, narrowed, monkeypatch):
    from nf_tpu.data.toy import TOY_SAMPLERS
    from nf_tpu_torch import evaluate

    network, dataset, extra, cfg_kw = TWO_D[case]
    fn, dims, _ = TOY_SAMPLERS[dataset]
    batches = [fn(256, np.random.default_rng(s)) for s in (1, 2)]
    ckpt = nf_checkpoint(narrowed / "ckpt.npz", network, dims, "2d", batches, **cfg_kw)
    run_script(monkeypatch, "eval_nll", [network, ckpt, dataset] + extra)
    tag = f"{network}_resample" if "resample" in extra else network
    want = json.loads((narrowed / f"PARITY_nf_tpu_{tag}.json").read_text())

    if "resample" in extra:
        keys, pending = inject_maf_masks(monkeypatch)
    port_dir = narrowed / "port"
    port_dir.mkdir()
    monkeypatch.chdir(port_dir)
    got = evaluate.main(["nll", network, ckpt, dataset] + extra + ["platform=cpu"])
    assert sorted(os.listdir(port_dir)) == [f"PARITY_nf_tpu_torch_{tag}.json"]
    assert json.loads((port_dir / f"PARITY_nf_tpu_torch_{tag}.json").read_text()) == got
    if "resample" in extra:
        assert not pending
        assert keys == [(evaluate.RESAMPLE_KEY, i)
                        for i in range(0, evaluate.HELDOUT_N, evaluate.BATCH)]
    assert got["framework"] == "nf_tpu_torch" and want["framework"] == "nf_tpu"
    assert {k: v for k, v in got.items() if k not in ("framework", "heldout_nll_nats")} == \
        {k: v for k, v in want.items() if k not in ("framework", "heldout_nll_nats")}
    assert got["steps"] == 1
    np.testing.assert_allclose(got["heldout_nll_nats"], want["heldout_nll_nats"], rtol=RTOL)


def image_batches():
    from nf_tpu.data.images import load_images

    x, _ = load_images("mnist16", "data", seed=5, synthetic_n=64)
    return x[:32], x[32:]


@pytest.mark.parametrize("scan", ["true", "false"], ids=["scan-remat", "unrolled"])
def test_heldout_image_nll_matches_eval_image_nll(scan, narrowed, monkeypatch):
    from nf_tpu_torch import evaluate

    for mod in (script("eval_image_nll"), evaluate):
        monkeypatch.setattr(mod, "N_HELDOUT", IMAGE_HELDOUT)
    flag = scan == "true"
    ckpt = nf_checkpoint(narrowed / "ckpt.npz", "realnvp", (16, 16, 1), "image",
                         image_batches(), layers=1, scan=flag, remat=flag)
    argv = [ckpt, "network=realnvp", "dataset=mnist16", "layers=1", "draws=2",
            f"scan={scan}", f"remat={scan}"]
    want = run_script(monkeypatch, "eval_image_nll", argv)
    got = evaluate.main(["image"] + argv + ["platform=cpu"])
    check_image(got, want, draws=2)


def check_image(got, want, draws):
    assert set(got) == set(want)
    assert got["n_heldout"] == IMAGE_HELDOUT and got["noise_draws"] == draws
    for key in ("ckpt", "network", "dataset", "trained_steps", "n_heldout", "noise_draws",
                "vardequant"):
        assert got[key] == want[key], key
    for key in ("heldout_nll_nats", "heldout_nll_per_draw", "bits_per_dim_continuous",
                "bits_per_dim_discrete"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)
    assert got["bits_per_dim_discrete"] - got["bits_per_dim_continuous"] == pytest.approx(8.0)


def test_vardequant_heldout_matches_eval_image_nll(narrowed, monkeypatch):
    """Flow++ with variational dequantization: each batch's eps is nf_tpu's
    draw for the script's key, injected into the port's head."""
    from nf_tpu_torch import evaluate
    from nf_tpu_torch.bijectors.vardequant import VariationalDequant

    for mod in (script("eval_image_nll"), evaluate):
        monkeypatch.setattr(mod, "N_HELDOUT", IMAGE_HELDOUT)
    dims = (16, 16, 1)
    ckpt = nf_checkpoint(narrowed / "ckpt.npz", "flow++", dims, "image", image_batches(),
                         layers=1, scan=False, remat=False, var_dequant=True)
    argv = [ckpt, "network=flow++", "dataset=mnist16", "layers=1", "draws=2", "scan=false",
            "remat=false", "vardequant=true"]
    want = run_script(monkeypatch, "eval_image_nll", argv)

    trainers = capture_restore(monkeypatch)
    seeds = []
    make = evaluate.noise_generator

    def noise_generator(device, *ints):
        seed, n = ints
        seeds.append(n)
        head = trainers[-1].model.bijector.layers[0]
        assert isinstance(head, VariationalDequant)
        rows = min(evaluate.IMAGE_BATCH, IMAGE_HELDOUT - n % evaluate.DRAW_STRIDE)
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), n), 0)
        head.injected_eps = torch.from_numpy(np.array(jax.random.normal(key, (rows,) + dims)))
        return make(device, *ints)

    monkeypatch.setattr(evaluate, "noise_generator", noise_generator)
    got = evaluate.main(["image"] + argv + ["platform=cpu"])
    assert seeds == [k * evaluate.DRAW_STRIDE + i for k in range(2)
                     for i in range(0, IMAGE_HELDOUT, evaluate.IMAGE_BATCH)]
    assert got["vardequant"] is True
    check_image(got, want, draws=2)


def write_idx(path, n=4):
    path.parent.mkdir(parents=True)
    rows = np.random.default_rng(0).integers(0, 256, size=(n, 28, 28), dtype=np.uint8)
    path.write_bytes(struct.pack(">IIII", 2051, n, 28, 28) + rows.tobytes())


def test_refuses_real_image_files(narrowed, monkeypatch):
    from nf_tpu_torch import evaluate

    write_idx(narrowed / "real" / "mnist" / "train-images-idx3-ubyte")
    argv = ["missing.npz", "dataset=mnist16", f"data_root={narrowed / 'real'}"]
    with pytest.raises(SystemExit) as want:
        run_script(monkeypatch, "eval_image_nll", argv)
    with pytest.raises(SystemExit) as got:
        evaluate.main(["image"] + argv + ["platform=cpu"])
    assert got.value.code == want.value.code
    assert str(got.value.code).startswith("real mnist16 files present")
    with pytest.raises(SystemExit):
        evaluate.heldout_image_nll("missing.npz", dataset="mnist", data_root=str(narrowed / "real"),
                                   device="cpu")


def test_raises_without_a_card(narrowed, monkeypatch):
    from nf_tpu_torch import evaluate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: evaluate.heldout_nll("realnvp", "missing.npz"),
                 lambda: evaluate.heldout_image_nll("missing.npz"),
                 lambda: evaluate.main(["nll", "realnvp", "missing.npz"]),
                 lambda: evaluate.main(["image", "missing.npz", "dataset=mnist16"])):
        with pytest.raises(RuntimeError, match="platform=cpu|device='cpu'"):
            call()
    # asked for the CPU, the evaluator goes on to read the file
    with pytest.raises(FileNotFoundError):
        evaluate.main(["nll", "realnvp", "missing.npz", "platform=cpu"])
    with pytest.raises(ValueError, match="platform"):
        evaluate.main(["nll", "realnvp", "missing.npz", "platform=tpu"])
    for argv in ([], ["score"], ["nll", "realnvp"], ["image", "dataset=mnist"],
                 ["image", "x.npz", "dataset"], ["image", "x.npz", "sacn=true"]):
        with pytest.raises(SystemExit):
            evaluate.main(argv)
    assert not list(narrowed.glob("PARITY_*"))


def test_imports_no_jax_and_nothing_of_nf_tpu():
    tree = ast.parse((ROOT / "nf_tpu_torch" / "evaluate.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
    assert names and not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "nf_tpu",
                                                                  "scripts", "main")]
