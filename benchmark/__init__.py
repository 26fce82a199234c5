"""The benchmark of nf_tpu_torch, the PyTorch and CUDA port, on one card.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once.  Everything of a
cell is data found by name: its configuration (`configs/`), traffic mix
(`traffic/`) and the density it draws from (`densities/`), output-check
limits (`limits/`), reference (`reference/`), work counts (`work/`) and each
metric's reader (`metrics/`).
"""
