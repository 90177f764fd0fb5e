"""`meiosis_ms`: milliseconds a generation in the dense backend's meiosis: `DenseSimulation._reproduce`'s fetch of the parents, kernel 4 (`parallel.mesh.meiose_window`, `csrc/meiose_packed.cu`) and the resident CV alleles (`dense/packed.py`'s `cv_child`), fenced under `--stage_sync`; the
StageTimer stage `reproduce/meiosis` of the traced run over its
generations. Nothing when the run has no such stage."""


def read(ctx):
    t = ctx["stages"].get("reproduce/meiosis")
    return None if t is None else 1e3 * t / ctx["gens"]
