"""The port's report (``nf_tpu_torch/train/report.py``, ``utils/plotting.py``,
``utils/jpeg.py``) against nf_tpu's ``train/report.py``, on the CPU.

Both reports run on one converted RealNVP state (nf_tpu's variables after
its data-dependent init): 2-D on moons (4 layers, 16 filters, 64 rows),
3-D on ``swiss`` and the image branch on ``mnist16`` (1 layer, 8
filters).  The panels' inputs are captured by replacing each package's
drawing functions (``scatter_plot``, ``image_plot``, ``make_grid``), and
the port's latent draw takes nf_tpu's ``normal(PRNGKey(step), ...)``, so
the samples are the port's inverse of nf_tpu's latent.  Held: the data,
z and p(z), the samples and their p(y), and the 256 x 256 map's log p
within 1e-4 of the largest |log p| (the values within 2e-5 of their
largest magnitude), the image grids within 1e-4, and the writer's tags in
nf_tpu's order.  ``make_grid`` equals nf_tpu's value for value.  Every
JPEG the port writes decodes in PIL (present here, not on the card) at the
panel's size with a PSNR of 30 dB or more against the array, and the
port's own header parse reads its SOF0 size.
"""
import io
import os

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

STEP = 7
CASES = {  # branch: (distrib, dims, datatype, layers, filters, rows)
    "2d": ("moons", (2,), "2d", 4, 16, 64),
    "3d": ("swiss", (3,), "3d", 4, 16, 64),
    "image": ("mnist16", (16, 16, 1), "image", 1, 8, 64),
}


class _Writer:
    """A MetricWriter stand-in that records the image tags."""

    def __init__(self):
        self.tags = []

    def image(self, tag, img, step):
        assert img.dtype == np.uint8 and img.ndim == 3
        self.tags.append((tag, step))


def _capture(monkeypatch, plotting):
    """Replace ``plotting``'s drawing functions with recorders of their
    inputs; returns the list they append to."""
    seen = []

    def scatter(xs, ys, zs=None, colors=None, title=""):
        seen.append(("scatter", [np.asarray(a, np.float64) for a in (xs, ys, zs, colors)
                                 if a is not None]))
        return np.zeros((4, 4, 3), np.uint8)

    def image(values, title="", extent=None):
        seen.append(("image", [np.asarray(values, np.float64)]))
        return np.zeros((4, 4, 3), np.uint8)

    grid = plotting.make_grid

    def make_grid(images, *a, **kw):
        out = grid(images, *a, **kw)
        seen.append(("grid", [np.asarray(out, np.float64)]))
        return out

    monkeypatch.setattr(plotting, "scatter_plot", scatter)
    monkeypatch.setattr(plotting, "image_plot", image)
    monkeypatch.setattr(plotting, "make_grid", make_grid)
    return seen


def _states(branch):
    """nf_tpu's Trainer and TrainState, the port's Trainer and TrainState
    on the same variables, and a data batch."""
    from _torch_parity import to_numpy

    from nf_tpu.config import NetworkConfig as JNC
    from nf_tpu.config import OptimizerConfig as JOC
    from nf_tpu.data import FlowDataLoader
    from nf_tpu.models import build_model as jbuild
    from nf_tpu.train import Trainer as JTrainer
    from nf_tpu_torch.config import NetworkConfig, OptimizerConfig
    from nf_tpu_torch.convert import load_jax_variables
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.train import Trainer

    distrib, dims, datatype, layers, filters, rows = CASES[branch]
    kw = dict(name="realnvp", layers=layers, base_filters=filters)
    data = FlowDataLoader(distrib, batch_size=rows, seed=1).next_batch()
    jt = JTrainer(jbuild("realnvp", dims, datatype=datatype, cfg=JNC(**kw)), JOC(), seed=0)
    jts = jt.init_state(jax.random.PRNGKey(0), data)
    model = build_model("realnvp", dims, datatype, NetworkConfig(**kw), device="cpu")
    tt = Trainer(model, OptimizerConfig(), seed=0)
    ts = tt.init_state(params=load_jax_variables(model, to_numpy(jts.var)))
    return jt, jts, tt, ts, np.asarray(data), dims


def test_make_grid_is_nf_tpus():
    from nf_tpu.utils.plotting import make_grid as jgrid
    from nf_tpu_torch.utils.plotting import make_grid

    imgs = np.random.default_rng(0).uniform(size=(13, 5, 7, 3)).astype(np.float32)
    for kw in ({}, dict(nrow=4, pad=2, pad_value=0.25)):
        a, b = make_grid(imgs, **kw), jgrid(imgs, **kw)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("branch", sorted(CASES))
def test_report_panels_match_nf_tpu(branch, monkeypatch, tmp_path):
    import nf_tpu.train.report as jreport
    import nf_tpu.utils.plotting as jplot
    import nf_tpu_torch.models.base as tbase
    import nf_tpu_torch.train.report as treport
    import nf_tpu_torch.utils.plotting as tplot

    jt, jts, tt, ts, data, dims = _states(branch)
    jseen = _capture(monkeypatch, jplot)
    jw = _Writer()
    jreport.report(jt, jts, jw, data, STEP, str(tmp_path), save_files=False)

    def nf_latent(generator, shape, device):   # nf_tpu's PRNGKey(step) draw
        assert generator.initial_seed() == STEP
        return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(STEP), shape)))

    monkeypatch.setattr(tbase, "_normal", nf_latent)
    tseen = _capture(monkeypatch, tplot)
    tw = _Writer()
    treport.report(tt, ts, tw, data, STEP, str(tmp_path), save_files=False)

    assert tw.tags == jw.tags and len(tw.tags) == {"2d": 4, "3d": 2, "image": 2}[branch]
    assert [k for k, _ in tseen] == [k for k, _ in jseen]
    for (kind, ours), (_, theirs) in zip(tseen, jseen):
        for a, b in zip(ours, theirs):
            assert a.shape == b.shape
            if kind == "image":     # the density map: compare log p
                la, lb = np.log(a), np.log(b)
                np.testing.assert_allclose(la, lb, atol=1e-4 * np.abs(lb).max())
            elif kind == "grid":
                np.testing.assert_allclose(a, b, atol=1e-4)
            else:
                np.testing.assert_allclose(a, b, atol=2e-5 * max(np.abs(b).max(), 1e-30))
    if branch == "2d":
        assert tseen[-1][1][0].shape == (256, 256)
        assert tseen[2][1][0].shape == (100,)          # max(100, n) samples
    if branch == "image":
        assert tseen[0][1][0].shape == (8 * 17 + 1, 8 * 17 + 1, 1)


@pytest.mark.parametrize("branch", sorted(CASES))
def test_report_files_decode(branch, monkeypatch, tmp_path):
    from PIL import Image

    import nf_tpu_torch.train.report as treport
    from nf_tpu_torch.utils import jpeg, plotting

    _, _, tt, ts, data, _ = _states(branch)
    saved = {}
    save = plotting.save_image

    def record(path, array):
        saved[os.path.basename(path)] = plotting.to_uint8(array)
        save(path, array)

    monkeypatch.setattr(plotting, "save_image", record)
    treport.report(tt, ts, _Writer(), data, STEP, str(tmp_path), save_files=True)
    names = {"2d": ["y_data", "z_sample", "y_sample", "y_dist"], "3d": ["z_sample", "y_sample"],
             "image": ["y_data", "y_image"]}[branch]
    assert sorted(saved) == sorted(f"{n}_{STEP:06d}.jpg" for n in names)
    assert sorted(os.listdir(tmp_path)) == sorted(
        [f"{n}_{STEP:06d}.jpg" for n in names] + [f"{n}_latest.jpg" for n in names])
    for name, want in saved.items():
        raw = (tmp_path / name).read_bytes()
        assert raw == (tmp_path / name.replace(f"{STEP:06d}", "latest")).read_bytes()
        got = np.asarray(Image.open(io.BytesIO(raw)))
        assert got.shape == want.shape, name
        assert jpeg.read_header(raw) == (want.shape[0], want.shape[1],
                                         1 if want.ndim == 2 else 3)
        mse = np.mean((got.astype(np.float64) - want.astype(np.float64)) ** 2)
        psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
        print(f"{name}: {want.shape}, {len(raw)} bytes, PSNR {psnr:.1f} dB")
        assert psnr >= 30.0, (name, psnr)


def test_jpeg_header_parse_refuses_a_truncated_file():
    from nf_tpu_torch.utils import jpeg

    raw = jpeg.encode(np.full((9, 11, 3), 200, np.uint8))
    assert jpeg.read_header(raw) == (9, 11, 3)
    for bad in (raw[:-2], raw[2:], raw[:2] + raw[-2:]):
        with pytest.raises(ValueError):
            jpeg.read_header(bad)
