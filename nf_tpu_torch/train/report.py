"""The visual report (counterpart of ``nf_tpu/train/report.py``): the data,
latent and sample scatters and the density map of a 2-D model, the latent
and sample scatters of a 3-D one, and grids of data and sampled images.

It runs on rank 0 only.  Every panel goes to ``writer.image`` under
nf_tpu's tags on every report tick; with ``save_files`` it is also
written as ``<name>_<step:06d>.jpg`` and copied to ``<name>_latest.jpg``
under nf_tpu's names.  Samples are drawn from a generator seeded from the
step on the model's device, in place of nf_tpu's ``PRNGKey(step)``.  The
panels are drawn by ``utils/plotting.py`` (numpy, no titles).
"""
from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from ..parallel.distributed import is_host0
from ..utils import plotting
from .metrics import MetricWriter

GRID = 256          # the density map's cells a side, over [-1, 1]^2


def _save(run_dir, name, step, image, save_files):
    if not save_files:
        return
    out = os.path.join(run_dir, f"{name}_{step:06d}.jpg")
    plotting.save_image(out, image)
    shutil.copyfile(out, os.path.join(run_dir, f"{name}_latest.jpg"))


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def density_grid(m: int = GRID) -> np.ndarray:
    """(m * m, 2) cell centres over [-1, 1]^2 in nf_tpu's order: rows from
    y = +1 down, x from -1 across."""
    ix = (np.arange(m) + 0.5) / m * 2.0 - 1.0
    iy = (np.arange(m) + 0.5) / m * -2.0 + 1.0
    gx, gy = np.meshgrid(ix, iy)
    return np.stack([gx.ravel(), gy.ravel()], axis=1).astype(np.float32)


def sample_generator(trainer, step: int) -> torch.Generator:
    """The report's sampling generator: seeded from the step, on the
    model's device."""
    return torch.Generator(device=trainer.model.device).manual_seed(int(step))


def report(trainer, ts, writer: MetricWriter, y_data, step: int, run_dir: str,
           save_files: bool = False, name: str = "flow"):
    if not is_host0():
        return
    y_data = _numpy(y_data)
    if y_data.ndim == 2 and y_data.shape[1] == 2:
        dtype = "2d"
    elif y_data.ndim == 2 and y_data.shape[1] == 3:
        dtype = "3d"
    else:
        dtype = "image"
    title = f"{name}_{step}_steps"
    n = y_data.shape[0]

    if dtype == "2d":
        img = plotting.scatter_plot(y_data[:, 0], y_data[:, 1], title=title)
        writer.image("2d/data/y", img, step)
        _save(run_dir, "y_data", step, img, save_files)

        z = _numpy(trainer.forward(ts, y_data)[0])
        pz = np.exp(-0.5 * (z ** 2).sum(1) - np.log(2 * np.pi))
        img = plotting.scatter_plot(z[:, 0], z[:, 1], colors=pz, title=title)
        writer.image("2d/train/z", img, step)
        _save(run_dir, "z_sample", step, img, save_files)

        y, py = (_numpy(t) for t in trainer.sample(ts, max(100, n),
                                                    sample_generator(trainer, step)))
        img = plotting.scatter_plot(y[:, 0], y[:, 1], colors=py, title=title)
        writer.image("2d/test/y", img, step)
        _save(run_dir, "y_sample", step, img, save_files)

        logp = _numpy(trainer.log_prob(ts, density_grid()))
        py_map = np.exp(logp).reshape(GRID, GRID)
        img = plotting.image_plot(py_map, title=title, extent=[-1, 1, -1, 1])
        writer.image("2d/test/map", img, step)
        _save(run_dir, "y_dist", step, img, save_files)

    elif dtype == "3d":
        z = _numpy(trainer.forward(ts, y_data)[0])
        pz = np.exp(-0.5 * (z ** 2).sum(1) - 1.5 * np.log(2 * np.pi))
        img = plotting.scatter_plot(z[:, 0], z[:, 1], z[:, 2], colors=pz, title=title)
        writer.image("3d/train/z", img, step)
        _save(run_dir, "z_sample", step, img, save_files)

        y, py = (_numpy(t) for t in trainer.sample(ts, max(100, n),
                                                    sample_generator(trainer, step)))
        img = plotting.scatter_plot(y[:, 0], y[:, 1], y[:, 2], colors=py, title=title)
        writer.image("3d/test/y", img, step)
        _save(run_dir, "y_sample", step, img, save_files)

    else:  # image
        grid = plotting.make_grid(np.clip(y_data[:64], 0.0, 1.0))
        writer.image("image/test/data", (grid * 255).astype(np.uint8), step)
        _save(run_dir, "y_data", step, grid, save_files)

        y, _ = trainer.sample(ts, 64, sample_generator(trainer, step))
        y = np.clip(_numpy(y), 0.0, 1.0)
        grid = plotting.make_grid(y)
        writer.image("image/test/sample", (grid * 255).astype(np.uint8), step)
        _save(run_dir, "y_image", step, grid, save_files)
