"""Multi-process launcher (counterpart of ``nf_tpu/parallel/launch.py``):

    python -m nf_tpu_torch.parallel.launch <script.py> [args...]

One such process runs per rank, as torchrun starts them.  It forms the
process group from the environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), on the device that the
script's ``run.platform=`` argument names (NCCL on the card, gloo on the
CPU), then runs the script in this process as ``__main__``, e.g.
``nf_tpu_torch/main.py network=realnvp run.distrib=moons``, and takes the
group down after it.
"""
from __future__ import annotations

import runpy
import sys

import torch.distributed as dist

from .distributed import init_distributed


def main():
    args = sys.argv[1:]
    if not args:
        print("usage: python -m nf_tpu_torch.parallel.launch <script.py> [args...]",
              file=sys.stderr)
        raise SystemExit(2)
    platform = None
    for a in args[1:]:
        if a.startswith("run.platform="):
            platform = a.split("=", 1)[1]
    if not init_distributed(platform):
        print("nf_tpu_torch.parallel.launch: no process group to form (set RANK, "
              "WORLD_SIZE, MASTER_ADDR and MASTER_PORT)", file=sys.stderr)
        raise SystemExit(2)
    sys.argv = args
    try:
        runpy.run_path(args[0], run_name="__main__")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
