"""Held-out evaluation of a checkpoint (counterpart of nf_tpu's
``scripts/eval_nll.py`` and ``scripts/eval_image_nll.py``):

    python -m nf_tpu_torch.evaluate nll <network> <ckpt.npz> [dataset] [logdet] [resample]
    python -m nf_tpu_torch.evaluate image <ckpt.npz> [network=realnvp] [dataset=mnist]
        [draws=4] [scan=true] [remat=true] [layers=N] [allow_image=false]
        [vardequant=false] [data_root=data]

Both run on the CUDA card; ``platform=cpu`` (the CLI's ``run.platform``)
runs them on the CPU, and without it and without a card they raise.  The
checkpoint is a file in nf_tpu's format, from either package: the model is
built from ``NETWORK_DEFAULTS`` with the options given, ``Trainer.init_state``
runs on the first held-out rows (its data-dependent init), then
``load_checkpoint`` replaces every parameter, buffer and optimizer state
(and raises ``ValueError`` when the file holds another structure).  The
score is ``Trainer.log_prob``, the eval-mode eager chain, in batches.

* ``nll``: the mean -log p in nats over ``HELDOUT_N`` rows of a toy density
  drawn from ``default_rng(HELDOUT_SEED)``, nf_tpu's rows bit for bit.
  ``logdet`` overrides ResFlow's eval estimator ("exact" for a
  deterministic score); ``resample`` redraws MAF's masks on every batch.
  The JSON is printed and written to ``PARITY_nf_tpu_torch_<tag>.json`` in
  the working directory (``<network>`` or ``<network>_resample``): never
  to nf_tpu's ``PARITY_nf_tpu_<tag>.json``, whose committed files at the
  repo's root a run there would overwrite.
* ``image``: bits/dim over ``N_HELDOUT`` images of the synthetic generator
  under a seed disjoint from the training streams', snapped to the 8-bit
  grid and averaged over ``draws`` uniform dequantizations, each drawn
  from ``default_rng(IMAGE_HELDOUT_SEED + 1)`` as nf_tpu draws them.  With
  ``vardequant`` the head takes the raw pixels and -log p is already the
  discrete ELBO, so the continuous figure is the discrete one less 8.
  Where real MNIST / CIFAR files are under ``data_root`` it refuses, as
  nf_tpu's does: the checkpoint trained on them, and the held-out set is
  synthetic.  The JSON is printed.

The noise nf_tpu folds into JAX keys comes here from torch generators,
each seeded from the same integers (``noise_generator``): MAF's masks from
(RESAMPLE_KEY, row) and the vardequant eps from (IMAGE_HELDOUT_SEED,
draw * DRAW_STRIDE + image).  Those streams are the port's own, as are
ResFlow's ``unbias`` and FFJORD's eval probes; no seed gives nf_tpu's
draws, so comparisons inject them.
"""
from __future__ import annotations

import json
import math
import sys
import time

import numpy as np
import torch

from .config import NETWORK_DEFAULTS, NetworkConfig, OptimizerConfig, platform_device
from .data import IMAGE_DATASETS, TOY_SAMPLERS, load_images
from .models import build_model, resolve_device
from .train import Trainer, load_checkpoint

# scripts/eval_nll.py:28-29, :49, :55-56
HELDOUT_SEED = 9999
HELDOUT_N = 16384
INIT_ROWS = 1024
BATCH = 4096
RESAMPLE_KEY = 4242
# scripts/eval_image_nll.py:24-25, :83-103: the seed is disjoint from the
# loader's stream seeds
IMAGE_HELDOUT_SEED = 777_001
N_HELDOUT = 2048
IMAGE_BATCH = 256
IMAGE_DRAWS = 4
DRAW_STRIDE = 100_000

IMAGE_OPTIONS = ("network", "dataset", "draws", "scan", "remat", "layers", "allow_image",
                 "vardequant", "data_root")
USAGE = ("usage: python -m nf_tpu_torch.evaluate nll <network> <ckpt.npz> [dataset] [logdet] "
         "[resample] [platform=cpu]\n"
         "       python -m nf_tpu_torch.evaluate image <ckpt.npz> [key=value ...] "
         f"[platform=cpu]; keys: {', '.join(IMAGE_OPTIONS)}")


def noise_generator(device, *ints) -> torch.Generator:
    """A generator on ``device`` seeded from ``ints``, the integers nf_tpu
    folds into its key for the same draw."""
    seed = int(np.random.SeedSequence(ints).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def restore(network, dims, datatype, cfg, first, ckpt, device):
    """(trainer, state, the file's step): the model built on ``device``,
    ``init_state`` on ``first`` (None: no data-dependent init), then the
    checkpoint loaded over every parameter, buffer and optimizer state."""
    model = build_model(network, dims, datatype=datatype, cfg=cfg, device=device)
    trainer = Trainer(model, OptimizerConfig(), seed=0)
    ts = trainer.init_state(first)
    step = load_checkpoint(ckpt, model, ts)
    return trainer, ts, step


def _neg_sum(logp: torch.Tensor) -> float:
    """-sum(log p) of a batch, summed on the host in f32 as nf_tpu's scripts
    sum their numpy arrays."""
    return float(-logp.cpu().numpy().sum())


def heldout_nll(network, ckpt, dataset="normals", logdet=None, resample=False,
                device=None) -> dict:
    """The held-out NLL in nats of a 2-D / 3-D density checkpoint
    (``scripts/eval_nll.py``)."""
    device = resolve_device(device)
    fn, dims, _ = TOY_SAMPLERS[dataset]
    ho = fn(HELDOUT_N, np.random.default_rng(HELDOUT_SEED))
    cfg = NetworkConfig(name=network, **NETWORK_DEFAULTS[network])
    if logdet is not None:
        cfg.logdet = logdet
    if resample:        # MAF's reference behaviour: masks redrawn every call
        cfg.resample_masks = True
    trainer, ts, step = restore(network, dims, "2d", cfg, ho[:INIT_ROWS], ckpt, device)
    nll = 0.0
    for i in range(0, HELDOUT_N, BATCH):
        gen = noise_generator(device, RESAMPLE_KEY, i) if resample else None
        nll += _neg_sum(trainer.log_prob(ts, ho[i:i + BATCH], gen))
    nll /= HELDOUT_N
    out = {"framework": "nf_tpu_torch", "network": network, "dataset": dataset,
           "steps": step, "heldout_nll_nats": nll}
    if resample:
        out["resample_masks"] = True
    return out


def image_config(network="realnvp", scan=True, remat=True, layers=None, allow_image=False,
                 vardequant=False) -> NetworkConfig:
    """The image evaluator's network config: ``NETWORK_DEFAULTS`` with the
    full-scale run's memory flags and the opt-ins."""
    cfg = NetworkConfig(name=network, **NETWORK_DEFAULTS[network])
    cfg.scan, cfg.remat = scan, remat
    if layers is not None:
        cfg.layers = int(layers)
    cfg.allow_image = allow_image
    cfg.var_dequant = vardequant
    return cfg


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def heldout_image_nll(ckpt, network="realnvp", dataset="mnist", draws=IMAGE_DRAWS, scan=True,
                      remat=True, layers=None, allow_image=False, vardequant=False,
                      data_root="data", device=None) -> dict:
    """Held-out bits/dim of an image checkpoint (``scripts/eval_image_nll.py``)."""
    device = resolve_device(device)
    cfg = image_config(network, scan, remat, layers, allow_image, vardequant)
    x, is_real = load_images(dataset, data_root, seed=IMAGE_HELDOUT_SEED,
                             synthetic_n=N_HELDOUT)
    if is_real:
        raise SystemExit(
            f"real {dataset} files present under data/: the checkpoint was "
            "trained on them, but this evaluator's held-out set is "
            "synthetic. Evaluate with a held-out split of the real data "
            "instead.")
    x8 = np.floor(x[:N_HELDOUT] * 255.0 + 0.5) / 255.0      # snapped to the 8-bit grid
    dims = IMAGE_DATASETS[dataset]
    trainer, ts, step = restore(network, dims, "image", cfg, x8[:IMAGE_BATCH], ckpt, device)
    rng = np.random.default_rng(IMAGE_HELDOUT_SEED + 1)
    _synchronize(device)
    t0 = time.time()
    nll_draws = []
    for k in range(draws):
        acc = 0.0
        if vardequant:
            # the head takes the raw quantized pixels and its log-det carries
            # -log q(u | x) - D log 256: -log p is the discrete ELBO
            for i in range(0, N_HELDOUT, IMAGE_BATCH):
                gen = noise_generator(device, IMAGE_HELDOUT_SEED, k * DRAW_STRIDE + i)
                acc += _neg_sum(trainer.log_prob(ts, x8[i:i + IMAGE_BATCH], gen))
        else:
            u = rng.random(x8.shape)
            y = (x8 * 255.0 + u) / 256.0
            for i in range(0, N_HELDOUT, IMAGE_BATCH):
                acc += _neg_sum(trainer.log_prob(ts, y[i:i + IMAGE_BATCH]))
        nll_draws.append(acc / N_HELDOUT)
    _synchronize(device)
    minutes = (time.time() - t0) / 60
    nll = float(np.mean(nll_draws))
    bpd = nll / (math.prod(dims) * np.log(2.0))
    if vardequant:
        discrete = bpd          # the -D log 256 is inside the chain
        bpd = bpd - 8.0
    else:
        discrete = bpd + 8.0
    return {
        "ckpt": ckpt, "network": network, "dataset": dataset,
        "trained_steps": int(step), "n_heldout": N_HELDOUT,
        "noise_draws": draws,
        "heldout_nll_nats": nll,
        "heldout_nll_per_draw": nll_draws,
        "bits_per_dim_continuous": float(bpd),
        "bits_per_dim_discrete": float(discrete),
        "vardequant": vardequant,
        "eval_minutes": minutes,
    }


def _flag(value: str) -> bool:
    return value == "true"


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in ("nll", "image"):
        raise SystemExit(USAGE)
    command, args = argv[0], argv[1:]
    platform = None
    rest = []
    for a in args:
        if a.startswith("platform="):
            platform = a.split("=", 1)[1]
        else:
            rest.append(a)
    device = platform_device(platform)
    if command == "nll":
        if len(rest) < 2:
            raise SystemExit(USAGE)
        network, ckpt = rest[:2]
        dataset = rest[2] if len(rest) > 2 else "normals"
        resample = "resample" in rest[3:]
        extra = [a for a in rest[3:] if a != "resample"]
        out = heldout_nll(network, ckpt, dataset, logdet=extra[0] if extra else None,
                          resample=resample, device=device)
        print(json.dumps(out))
        tag = f"{network}_resample" if resample else network
        with open(f"PARITY_nf_tpu_torch_{tag}.json", "w") as f:
            json.dump(out, f, indent=2)
        return out
    if not rest or "=" in rest[0] or any("=" not in a for a in rest[1:]):
        raise SystemExit(USAGE)
    kv = dict(a.split("=", 1) for a in rest[1:])
    unknown = sorted(set(kv) - set(IMAGE_OPTIONS))
    if unknown:
        raise SystemExit(f"unknown option(s) {unknown}\n{USAGE}")
    out = heldout_image_nll(
        rest[0], network=kv.get("network", "realnvp"), dataset=kv.get("dataset", "mnist"),
        draws=int(kv.get("draws", IMAGE_DRAWS)), scan=_flag(kv.get("scan", "true")),
        remat=_flag(kv.get("remat", "true")), layers=kv.get("layers"),
        allow_image=_flag(kv.get("allow_image", "false")),
        vardequant=_flag(kv.get("vardequant", "false")),
        data_root=kv.get("data_root", "data"), device=device)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
