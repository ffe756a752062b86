"""setup_s: process start to window start (imports, library load or build,
weights, warm-up of the cell's own shapes); host clock."""


def read(run, name):
    return run["setup_s"]
