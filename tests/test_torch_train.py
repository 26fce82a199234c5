"""The port's Trainer against nf_tpu's on the CPU.

* ``make_optimizer``: the staircase schedule, Adam and the hand-written
  RMSprop against optax over a fixed gradient sequence, with and without
  weight decay, atol 1e-6 on the parameters.
* Three Adam steps of the same model on the same batches, after the same
  init and data-dependent init: losses within rtol 1e-5 per step, the
  first step's gradients within atol 1e-5 + rtol 1e-5 of ``jax.grad``
  (s_bias's gradient sums thousands of terms to about 15), and the state
  after the steps.  For the image RealNVP at 16x16x1 (layers = 1,
  base_filters = 8, every coupling through the coupling kernel's Function
  and its analytic backward) and for RealNVP 2-D density (D = 2,
  layers = 2); the same for Glow 2-D, Flow++ 2-D (mixtures = 2), MAF 2-D
  (layers = 2, base_filters = 8) and the image Glow at 16x16x3 (layers = 1,
  base_filters = 8, four couplings through the coupling kernel's Function).
  In those four a gradient entry past 1e-5 of nf_tpu's is held instead
  within atol 1e-5 + rtol 1e-5 of the float64 gradient of the same state,
  or no further from it than nf_tpu's f32 entry: at 16x16x3 an entry of
  the first 1x1 conv's L (a sum over 4,096 pixels that cancels to -1.9)
  is 9.5e-5 from float64 in nf_tpu and 9.1e-6 in the port.

The state check is tight where the gradient is real: parameter entries
whose first gradient exceeds 1e-4, and the variances (running_var,
batch_var), within 1e-5.  Some parameters have a zero true gradient: the
biases ahead of a train-mode batch norm, and each head's t-channel biases
ahead of the next flow BatchNorm.  Their f32 gradients are rounding noise
near 1e-7, above Adam's eps = 1e-8, so Adam moves them by up to about lr
per step in a direction each framework draws from its own noise.  They
leave the loss unchanged in train mode but shift the means downstream.
So those entries are held within 2 x 3 steps x lr (+ margin) = 1e-3, and
the running / batch means, which add up a few such shifts, within 2e-3.
"""
import numpy as np
import optax
import pytest
import torch
from _torch_parity import close, normal, trainer_parity, uniform

from nf_tpu.config import OptimizerConfig as JOptimizerConfig


def _configs(**kw):
    from nf_tpu_torch.config import OptimizerConfig
    return JOptimizerConfig(**kw), OptimizerConfig(**kw)


def test_lr_schedule_is_optax_staircase():
    from nf_tpu_torch.train import lr_schedule

    jcfg, cfg = _configs(lr=3e-3, decay_steps=4, decay_ratio=0.3)
    ref = optax.exponential_decay(jcfg.lr, jcfg.decay_steps, jcfg.decay_ratio,
                                  staircase=True)
    sched = lr_schedule(cfg)
    for k in range(14):
        assert abs(sched(k) - float(ref(k))) <= 1e-9


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
@pytest.mark.parametrize("name", ["adam", "rmsprop"])
def test_optimizer_matches_optax(name, weight_decay):
    from nf_tpu.train.trainer import make_optimizer as jmake
    from nf_tpu_torch.train import lr_schedule, make_optimizer

    jcfg, cfg = _configs(name=name, lr=1e-2, decay_steps=3, decay_ratio=0.5,
                         weight_decay=weight_decay)
    p0 = {"a": normal(0, (5, 3)), "b": normal(1, (4,))}
    jopt = jmake(jcfg)
    jp, jst = dict(p0), jopt.init(p0)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt, sched = make_optimizer(cfg, list(tp.values())), lr_schedule(cfg)
    for k in range(7):
        g = {"a": normal(10 + k, (5, 3)), "b": normal(20 + k, (4,), 1e-3)}
        up, jst = jopt.update(g, jst, jp)
        jp = optax.apply_updates(jp, up)
        for key, p in tp.items():
            p.grad = torch.from_numpy(g[key])
        for group in opt.param_groups:
            group["lr"] = sched(k)
        opt.step()
        for key, p in tp.items():
            close(p.detach(), jp[key], 1e-6)


def test_trainer_image_realnvp_matches_nf_tpu():
    dims = (16, 16, 1)
    batches = np.stack([uniform(30 + k, (16,) + dims) for k in range(4)])
    trainer_parity(dims, "image", 1, 8, batches)


def test_trainer_density_realnvp_matches_nf_tpu():
    batches = np.stack([normal(40 + k, (64, 2)) * 1.3 + 0.2 for k in range(4)])
    trainer_parity((2,), "2d", 2, 8, batches)


@pytest.mark.parametrize("name,dims,layers", [("glow", (2,), 2), ("flow++", (2,), 2),
                                               ("glow", (16, 16, 3), 1), ("maf", (2,), 2)],
                         ids=["glow-2d", "flowpp-2d", "glow-img16x16x3", "maf-2d"])
def test_trainer_matches_nf_tpu(name, dims, layers):
    """The other ported families through the same three Adam steps."""
    if len(dims) == 3:
        batches = np.stack([uniform(60 + k, (16,) + dims) for k in range(4)])
    else:
        batches = np.stack([normal(70 + k, (64,) + dims) * 1.3 + 0.2 for k in range(4)])
    trainer_parity(dims, "image" if len(dims) == 3 else "2d", layers, 8, batches, name,
                    f64_arbiter=True)


def test_trainer_runs_train_mode_after_an_eval_program():
    """eval_program puts the shared module in eval mode; the next step is
    a train step all the same, and the program serves in eval mode."""
    from nf_tpu_torch.config import NetworkConfig, OptimizerConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.train import Trainer

    model = build_model("realnvp", (16, 16, 1), "image",
                        NetworkConfig(layers=1, base_filters=8), device="cpu")
    tt = Trainer(model, OptimizerConfig(lr=1e-3), seed=0)
    batches = torch.from_numpy(np.stack([uniform(50 + k, (8, 16, 16, 1)) for k in range(3)]))
    ts = tt.init_state(batches[0])
    ts, losses = tt.train_steps(ts, batches[:2])
    assert losses.shape == (2,) and torch.isfinite(losses).all() and ts.step == 2
    prog = model.eval_program()
    assert not model.training
    bn = next(m for m in model.modules() if type(m).__name__ == "BatchNorm")
    running = bn.running_mean.clone()
    ts, _ = tt.train_step(ts, batches[2])
    assert model.training and not torch.equal(bn.running_mean, running)
    running = bn.running_mean.clone()
    lp = prog.log_prob(batches[0])
    assert not model.training and torch.equal(bn.running_mean, running)
    torch.testing.assert_close(lp, tt.log_prob(ts, batches[0]))
    y, log_py = tt.sample(ts, 4, torch.Generator().manual_seed(0))
    assert y.shape == (4, 16, 16, 1) and torch.isfinite(log_py).all()


def test_unported_options_raise():
    """scan, remat and compute_dtype="bfloat16" (refused before the port
    had them) build nf_tpu's structure and serve its log p within 3e-4
    (bf16: nf_tpu's program op by op, tests/test_torch_mixed_precision.py);
    an unknown matmul_precision and optimizer still raise."""
    from _torch_parity import flag_parity

    from nf_tpu_torch.config import NetworkConfig, OptimizerConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.train import make_optimizer

    for kw in (dict(scan=True), dict(remat=True), dict(scan=True, remat=True)):
        flag_parity("realnvp", (16, 16, 1), "image", 3e-4, layers=4, base_filters=8, **kw)
    flag_parity("realnvp", (16, 16, 1), "image", 3e-4, layers=1, base_filters=8, eager=True,
                compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="matmul_precision"):
        build_model("realnvp", (2,), "2d", NetworkConfig(matmul_precision="tf32"),
                    device="cpu")
    with pytest.raises(ValueError, match="unsupported optimizer"):
        make_optimizer(OptimizerConfig(name="sgd"), [torch.zeros(1, requires_grad=True)])


def test_image_build_model_defaults_to_the_card():
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model("realnvp", (16, 16, 1), "image", NetworkConfig(layers=1, base_filters=8))
