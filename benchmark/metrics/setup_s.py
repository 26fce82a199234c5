"""setup_s: from the process's start to the first timed request: imports,
the card's start, the model and its state, the served program's packing,
the kernels' build or load, and one warm request of each (kind, rows)
entry of the cell's mix."""


def read(run):
    return run.setup_s
