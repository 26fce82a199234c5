#!/usr/bin/env python3
"""How far nf_tpu's own f32 EvalProgram moves with XLA's CPU threading, at
the shapes ``test_torch_fused_stack.py::test_wide_ffma_layout_matches_reference``
walks, beside how far the port's plain version (which the walk holds to
2e-5) lies from it.

    python3 tests/stack_thread_spread.py      # from the root of the repository
    python3 tests/stack_thread_spread.py glow 1300 256    # one shape

Runs nf_tpu's program (seed 1, four couplings, 70 samples, as the test
does) in three processes, pinned to 1 core with Eigen's threading off, to
6 cores and to every core, and prints one JSON line per shape: the largest
difference of z and log-det, forward and inverse, between any two of the
three runs, between the plain version's forward and each run's, and
between the plain version's inverse and the every-core run's (from that
run's z).  Needs only the
CPU.
"""
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

CASES = [("realnvp", 400, 32), ("glow", 400, 32), ("realnvp", 400, 256), ("realnvp", 63, 256),
         ("glow", 150, 32), ("glow", 1300, 256)]
RUNS = {"1 core": ("0", "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"),
        "6 cores": ("0-5", ""), "every core": (None, "")}


def one(name, D, F, out):
    """nf_tpu's program at one threading: z, log-det forward and inverse
    into ``out`` (.npz)."""
    from _torch_parity import jax_model, normal

    jmodel, var = jax_model(name, D, 4, F, seed=1)
    prog = jmodel.eval_program(var)
    x = normal(40 + D, (70, D))
    z, ld = prog.forward(x)
    y, ldi = prog.inverse(np.asarray(z))
    np.savez(out, z=np.asarray(z), ld=np.asarray(ld), y=np.asarray(y), ldi=np.asarray(ldi))


def plain(name, D, F, z):
    import torch
    from _torch_parity import jax_model, normal, torch_model

    from nf_tpu_torch.ops.cuda import fused_stack as tfs

    tmodel = torch_model(name, D, 4, F, jax_model(name, D, 4, F, seed=1)[1])
    spec = tfs.extract_stack_spec(tmodel.bijector, tmodel.dims)
    packed, const_ld = tfs.pack_stack(tmodel.bijector, spec)
    x = torch.from_numpy(normal(40 + D, (70, D)))
    fz, fld = tfs.fused_stack_reference(packed, const_ld, x, "forward")
    iy, ild = tfs.fused_stack_reference(packed, const_ld, torch.from_numpy(z), "inverse")
    return dict(z=fz.numpy(), ld=fld.numpy(), y=iy.numpy(), ldi=ild.numpy())


def main():
    if len(sys.argv) == 5:
        one(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return
    cases = CASES
    if len(sys.argv) == 4:
        cases = [(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))]
    with tempfile.TemporaryDirectory() as tmp:
        for name, D, F in cases:
            got = {}
            for run, (cores, flags) in RUNS.items():
                out = os.path.join(tmp, f"{run.replace(' ', '_')}.npz")
                env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags)
                cmd = [sys.executable, os.path.abspath(__file__), name, str(D), str(F), out]
                if cores is not None:
                    cmd = ["taskset", "-c", cores] + cmd
                subprocess.run(cmd, env=env, cwd=ROOT, check=True, capture_output=True)
                got[run] = dict(np.load(out))
            runs = list(got)
            spread = {k: max(float(np.abs(got[a][k] - got[b][k]).max())
                             for a in runs for b in runs) for k in ("z", "ld", "y", "ldi")}
            # the plain version's inverse starts from the every-core run's z
            ref = plain(name, D, F, got["every core"]["z"])
            apart = {run: {k: float(np.abs(ref[k] - got[run][k]).max())
                           for k in ("z", "ld")} for run in runs}
            apart_inv = {k: float(np.abs(ref[k] - got["every core"][k]).max())
                         for k in ("y", "ldi")}
            print(json.dumps(dict(model=name, D=D, F=F, nf_tpu_spread=spread,
                                  plain_from_nf_tpu_forward=apart,
                                  plain_from_nf_tpu_inverse=apart_inv,
                                  largest={k: float(np.abs(got["every core"][k]).max())
                                           for k in ("z", "ld", "y", "ldi")})), flush=True)


if __name__ == "__main__":
    main()
