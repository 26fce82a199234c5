"""Training engine (counterpart of ``nf_tpu/train/trainer.py``): optimizer,
train step, K-step chunk, eval-mode log-density and sampling.

The parameters and buffers live in the model (``nn.Module``); a
``TrainState`` holds the step counter and the optimizer.  A step is
forward in train mode, loss = -mean(log p) in nats, backward, then the
optimizer's update at the step's learning rate.  Nothing in a step reads a
value back to the host: the learning rate is computed from the host's step
counter and the losses stay on the device.

``make_optimizer`` keeps ``optax``'s semantics:
* the learning rate decays in stairs, lr * ratio ** (k // decay_steps) at
  update k = 0, 1, ... (``optax.exponential_decay(staircase=True)``);
* Adam is ``torch.optim.Adam``: eps outside the square root and bias
  correction, as ``optax.adam``;
* RMSprop is the hand-written ``RMSprop`` below: ``optax.rmsprop`` decays
  by 0.9 with eps INSIDE the square root, where ``torch.optim.RMSprop``
  decays by 0.99 with eps outside;
* weight decay is coupled and applied before the optimizer
  (``optax.add_decayed_weights``): L2 added to the gradient, which is
  Adam's ``weight_decay``.

The per-step PRNG: ``nf_tpu`` folds the step into its key; here
``step_generator`` seeds one ``torch.Generator`` per step from
``(seed, step)`` on the model's device, and the step hands it to the
layers that draw noise while they train (``Bijector.takes_generator``:
MAF's ``resample_masks``, FFJORD's Hutchinson probe, variational
dequantization).  ``init_state`` hands the data-dependent init a
generator of its own, seeded from ``(seed, "dd")`` (``nf_tpu``'s
``fold_in(key, 1)``); ``log_prob`` takes one as ``nf_tpu``'s ``rng``, and
``sample`` hands its generator to the layers that draw.  The two
frameworks' draws differ, so parity tests inject the noise.

Checkpoints: ``train/checkpoint.py`` writes and reads ``nf_tpu``'s file
format, the optimizer state in ``optax``'s form.

Data parallelism (``mesh``, ``parallel/mesh.py``): R ranks at b rows each
take the step one process takes at R·b rows.  Each rank's loss is its
local mean; its forward and backward run under ``global_batch(mesh)``, so
every batch norm's statistics are those of all ranks' rows, their
gradient flowing through the reduction; the gradients are then averaged
by ONE all-reduce of a flat buffer (``average_gradients``), and the loss
returned is the global mean, reduced on the device.  ``init_state`` runs
the data-dependent init on each rank's own batch, then broadcasts rank
0's parameters and buffers (``replicate``), as ``nf_tpu``'s
``broadcast_one_to_all``.  The step generator folds the rank into its
seed when the world is larger than one (``host_seed``), so per-step noise
differs by rank, as ``nf_tpu``'s multi-process trainer folds its key.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..models.base import FlowModel
from ..nets.layers import global_batch
from ..parallel.distributed import host_seed
from ..parallel.sharding import average_gradients, global_mean, replicate


def lr_schedule(cfg) -> Callable[[int], float]:
    """Learning rate of update k = 0, 1, ...: staircase exponential decay."""
    return lambda k: cfg.lr * cfg.decay_ratio ** (k // cfg.decay_steps)


# the data-dependent init's stream: SeedSequence(seed, spawn_key=(DD_KEY,)),
# apart from every step's (seed, step)
DD_KEY = int.from_bytes(b"dd", "big")

# optax.rmsprop's defaults, which nf_tpu uses
RMSPROP_DECAY = 0.9
RMSPROP_EPS = 1e-8


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop``: nu = decay nu + (1 - decay) g^2 from nu = 0,
    p -= lr g / sqrt(nu + eps), with coupled weight decay added to g."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(RMSPROP_DECAY).add_((1.0 - RMSPROP_DECAY) * g * g)
                p.sub_(group["lr"] * g * torch.rsqrt(nu + RMSPROP_EPS))


def make_optimizer(cfg, params) -> torch.optim.Optimizer:
    """Adam or RMSprop over ``params`` at the schedule's first rate; the
    trainer sets each update's rate from ``lr_schedule``."""
    if cfg.name == "adam":
        return torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.beta1, cfg.beta2), eps=1e-8,
                                weight_decay=cfg.weight_decay)
    if cfg.name == "rmsprop":
        return RMSprop(params, lr=cfg.lr, weight_decay=cfg.weight_decay)
    raise ValueError(f"unsupported optimizer {cfg.name!r}")


@dataclass
class TrainState:
    step: int
    optimizer: torch.optim.Optimizer


class Trainer:
    def __init__(self, model: FlowModel, opt_cfg, mesh=None, seed: int = 42):
        self.model = model
        self.opt_cfg = opt_cfg
        self.mesh = mesh
        self.seed = seed
        self.schedule = lr_schedule(opt_cfg)
        # the per-step generators' seed: the rank folded in past one rank
        self.step_seed = (host_seed(seed, mesh.rank) if mesh is not None and mesh.world > 1
                          else seed)

    # ------------------------------------------------------------------ init
    def init_state(self, sample_batch: Optional[torch.Tensor] = None,
                   params: Optional[dict] = None) -> TrainState:
        """Draw the parameters from the trainer's seed (or load ``params``,
        a state dict as ``FlowModel.init`` or ``convert.load_jax_variables``
        return it), run the data-dependent init on ``sample_batch`` when
        given, with ``dd_generator()``, and make the optimizer.  Under a
        mesh every rank then takes rank 0's parameters and buffers."""
        model = self.model
        if params is None:
            model.init(torch.Generator(device=model.device).manual_seed(self.seed))
        else:
            model.load_state_dict(params)
        if sample_batch is not None:
            model.data_dependent_init(self._batch(sample_batch), self.dd_generator())
        if self.mesh is not None:
            replicate(model, self.mesh)
        return TrainState(0, make_optimizer(self.opt_cfg, list(model.parameters())))

    def _generator(self, seq: np.random.SeedSequence) -> torch.Generator:
        seed = int(seq.generate_state(1)[0])
        return torch.Generator(device=self.model.device).manual_seed(seed)

    def dd_generator(self) -> torch.Generator:
        """The data-dependent init's generator, on the model's device."""
        return self._generator(np.random.SeedSequence(self.seed, spawn_key=(DD_KEY,)))

    # ----------------------------------------------------------------- steps
    def step_generator(self, step: int) -> torch.Generator:
        """The generator of update ``step``, on the model's device: seeded
        from ``(seed, step)`` (the seed with the rank folded in past one
        rank), so each step draws anew and a step run again draws the
        same."""
        return self._generator(np.random.SeedSequence((self.step_seed, step)))

    def _batch(self, batch) -> torch.Tensor:
        return torch.as_tensor(batch).to(device=self.model.device, dtype=torch.float32)

    def train_step(self, ts: TrainState, batch):
        """One update; returns (ts, loss) with the loss a 0-d device tensor.
        The model is put in train mode first (``eval_program`` leaves it in
        eval mode).  Under a mesh ``batch`` is this rank's rows and the
        loss the mean over all ranks' rows."""
        model = self.model
        model.train()
        opt = ts.optimizer
        opt.zero_grad(set_to_none=True)
        with global_batch(self.mesh):
            loss = -model.log_prob(self._batch(batch), self.step_generator(ts.step)).mean()
            loss.backward()
        if self.mesh is not None:
            average_gradients(model.parameters(), self.mesh)
            loss = global_mean(loss, self.mesh)
        lr = self.schedule(ts.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        ts.step += 1
        return ts, loss.detach()

    def train_steps(self, ts: TrainState, batches):
        """K steps over ``batches`` (K, B, ...), a plain loop; returns
        (ts, losses (K,)) with the losses on the device."""
        batches = self._batch(batches)
        losses = []
        for k in range(batches.shape[0]):
            ts, loss = self.train_step(ts, batches[k])
            losses.append(loss)
        return ts, torch.stack(losses)

    # ------------------------------------------------------------------ eval
    @torch.no_grad()
    def log_prob(self, ts: TrainState, batch,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Eval-mode log p(batch), (B,).  ``generator`` feeds the layers that
        draw in eval (variational dequantization needs one: a fresh
        dequantization sample per call; FFJORD's probes)."""
        self.model.eval()
        return self.model.log_prob(self._batch(batch), generator)

    @torch.no_grad()
    def forward(self, ts: TrainState, batch):
        """Eval-mode (z, log|det dz/dx|) of ``batch``, each (B, ...)."""
        self.model.eval()
        return self.model(self._batch(batch))

    @torch.no_grad()
    def sample(self, ts: TrainState, n: int, generator: torch.Generator):
        """Eval-mode draw of n samples: (y, log p(y)); ``generator`` draws the
        latent, then feeds the layers that draw (FFJORD's probes)."""
        self.model.eval()
        return self.model.sample(n, generator)
