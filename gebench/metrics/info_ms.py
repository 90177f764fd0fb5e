"""`info_ms`: milliseconds a generation of the `.info` layer's host work in
the traced run, on both threads it takes: the stage `info_files` (each
population's `_save_info`, which hands the file's host fields to the
program's background writer, and its trajectory row) and the CPU seconds
of the writer's own calls (`Simulation._save_info_sync`: the text formatted
and written, beside the next generation; generation 0's files among them);
over the run's generations. A slower writer shows here even where it
overlaps the device. Nothing when the run has no such stage."""

CLOCK = ("geneevolve_tpu_torch.core.engine", "Simulation._save_info_sync")


def read(ctx):
    t = ctx["stages"].get("info_files")
    if t is None:
        return None
    return 1e3 * (t + ctx["clocked"]["info_ms"]) / ctx["gens"]
