"""Training CLI of nf_tpu_torch (counterpart of nf_tpu's ``main.py``):

    python -m nf_tpu_torch.main network=realnvp run.distrib=moons train.steps=1000
    python -m nf_tpu_torch.main ... run.platform=cpu          # on the CPU

and data-parallel over R ranks, one process each, started by torchrun or
by the launcher (which forms the process group first):

    torchrun --nproc-per-node R -m nf_tpu_torch.main ...
    RANK=r WORLD_SIZE=R LOCAL_RANK=r MASTER_ADDR=... MASTER_PORT=... \\
        python -m nf_tpu_torch.parallel.launch nf_tpu_torch/main.py ...

Every field of ``nf_tpu_torch/config.py`` takes a dotted ``key=value``
override, as nf_tpu's.  The run directory is
``logs/<network>_<distrib>_<timestamp>``; it holds ``metrics.jsonl`` (and
TensorBoard events where ``tensorboard`` imports) and ``latest.npz`` in
nf_tpu's checkpoint format.  ``run.resume=auto`` continues the newest run
of the same network and data in its directory, ``run.resume=<dir>`` that
run, ``run.ckpt_path`` loads one file.  The loop, its log, metric and
checkpoint cadences and the metric tags are nf_tpu's; a resumed run
starts the data stream from its first batch, as nf_tpu's does.
Under a process group each rank draws its own data shard, and rank 0
writes the run directory.
"""
from __future__ import annotations

import glob
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from nf_tpu_torch.config import parse_cli, platform_device, to_dict
from nf_tpu_torch.data import FlowDataLoader
from nf_tpu_torch.models import build_model
from nf_tpu_torch.parallel import COLLECTIVES, init_distributed, is_host0, make_mesh
from nf_tpu_torch.parallel.distributed import rank, world_size
from nf_tpu_torch.train import Trainer, load_checkpoint, save_checkpoint
from nf_tpu_torch.train.metrics import MetricWriter
from nf_tpu_torch.utils import Logging
from nf_tpu_torch.utils.debug import check_chain

logger = Logging(__file__)


def _device(cfg) -> torch.device:
    device = platform_device(cfg.run.platform)
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("nf_tpu_torch.main trains on the CUDA card and none is "
                           "available; pass run.platform=cpu to train on the CPU")
    return torch.device(device or "cuda")


def _run_dir(cfg):
    """(run directory, checkpoint to resume from or None), from
    ``run.resume``; rank 0's under a process group."""
    run_dir = None
    resume_ckpt = None
    if cfg.run.resume:
        if cfg.run.resume == "auto":
            cands = glob.glob(os.path.join(
                "logs", f"{cfg.network.name}_{cfg.run.distrib}_*", "latest.npz"))
            if cands:
                resume_ckpt = max(cands, key=os.path.getmtime)
                run_dir = os.path.dirname(resume_ckpt)
            else:
                logger.warn("run.resume=auto found no prior checkpoint; starting fresh")
        else:
            run_dir = cfg.run.resume
            p = os.path.join(run_dir, "latest.npz")
            if os.path.exists(p):
                resume_ckpt = p
            else:
                raise FileNotFoundError(f"run.resume={run_dir!r} has no latest.npz")
    if run_dir is None:
        run_dir = os.path.join("logs", f"{cfg.network.name}_{cfg.run.distrib}_"
                               + time.strftime("%Y-%m-%d_%H-%M-%S"))
    if dist.is_initialized():
        agreed = [run_dir, resume_ckpt]
        dist.broadcast_object_list(agreed, src=0)
        run_dir, resume_ckpt = agreed
    return run_dir, resume_ckpt


def main(argv=None):
    cfg = parse_cli(sys.argv[1:] if argv is None else argv)
    device = _device(cfg)
    formed = not dist.is_initialized() and init_distributed(cfg.run.platform)
    print("***** parameters ****")
    print(json.dumps(to_dict(cfg), indent=2))
    print("*********************\n")
    anomaly = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(cfg.run.debug)
    try:
        return train(cfg, device)
    finally:
        torch.autograd.set_detect_anomaly(anomaly)
        if formed:
            dist.destroy_process_group()


def train(cfg, device: torch.device) -> str:
    """The training loop of ``main``; returns the run directory."""
    run_dir, resume_ckpt = _run_dir(cfg)
    if is_host0():
        os.makedirs(run_dir, exist_ok=True)

    dataset = FlowDataLoader(
        cfg.run.distrib,
        batch_size=cfg.train.samples,
        total_steps=cfg.train.steps,
        shuffle=True,
        seed=cfg.run.seed,
        data_root=cfg.run.data_root,
        shard_id=rank(),
        num_shards=world_size(),
        dequantize=cfg.run.dequantize,
    )

    model = build_model(cfg.network.name, dataset.dims, datatype=dataset.dtype,
                        cfg=cfg.network, device=device)
    if cfg.run.debug:
        # every layer's output and log-det checked finite (utils/debug.py)
        check_chain(model.bijector)
    mesh = make_mesh() if dist.is_initialized() else None
    trainer = Trainer(model, cfg.optimizer, mesh=mesh, seed=cfg.run.seed)
    ts = trainer.init_state(dataset.next_batch())

    start_step = 0
    ckpt = cfg.run.ckpt_path or resume_ckpt
    if ckpt is not None:
        start_step = load_checkpoint(ckpt, model, ts)
        logger.info(f"resumed from {ckpt} at step {start_step}")

    writer = MetricWriter(run_dir)
    display = cfg.run.display
    step = start_step
    logger.info(f"training {cfg.network.name} on {cfg.run.distrib} ({world_size()} "
                f"{device.type} devices, data tier {dataset.tier}, run dir {run_dir})")

    chunk = max(1, int(cfg.train.chunk))
    data_iter = iter(dataset)
    done = False
    while not done and step < cfg.train.steps:
        t0 = time.perf_counter()
        if chunk == 1:
            try:
                data = next(data_iter)
            except StopIteration:
                break
            ts, loss = trainer.train_step(ts, data)
            step += 1
        else:
            stack = []
            for _ in range(chunk):
                try:
                    stack.append(next(data_iter))
                except StopIteration:
                    done = True
                    break
            if not stack:
                break
            ts, losses = trainer.train_steps(ts, np.stack(stack))
            loss = losses[-1]
            step += len(stack)

        if step <= start_step + chunk or step % (display * 10) < chunk:
            loss_val = float(loss)  # a device sync only on log ticks
            dt = (time.perf_counter() - t0) / chunk
            logger.info(f"[{step}/{cfg.train.steps}] loss={loss_val:.5f} [{dt:.3f} s/it]")

        if step <= start_step + chunk or step % (display * 100) < chunk:
            writer.scalar(f"{dataset.dtype}/train/loss", float(loss), step)
            if dataset.dtype == "image":
                # bits/dim = NLL (nats) / (D ln 2)
                d = int(np.prod(dataset.dims))
                bpd = float(loss) / (d * np.log(2.0))
                writer.scalar("image/train/bits_per_dim", bpd, step)
                if cfg.run.dequantize:
                    # discrete 8-bit bits/dim: + log2(256) for the
                    # dequantization's change of measure
                    writer.scalar("image/train/bits_per_dim_discrete", bpd + 8.0, step)
            # nf_tpu's report(...) (sample and density panels, image
            # files) runs here; not ported yet (ROADMAP.md, queue 1, item 10)
            writer.flush()

        if step <= start_step + chunk or step % (display * 1000) < chunk:
            save_checkpoint(os.path.join(run_dir, "latest.npz"), model, ts)

    save_checkpoint(os.path.join(run_dir, "latest.npz"), model, ts)
    writer.close()
    if mesh is not None:
        logger.info(f"process group: backend {dist.get_backend()}, world {mesh.world}, "
                    f"{COLLECTIVES['all_reduce']} all-reduces, "
                    f"{COLLECTIVES['broadcast']} broadcasts")
    logger.info("done")
    return run_dir


if __name__ == "__main__":
    main()
