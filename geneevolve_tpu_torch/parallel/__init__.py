"""Work spread over several devices: the (ind, loci) mesh of ranks and the
sharded packed steps (`mesh`), the collectives they run (`comm`), starting
the ranks (`launch`), nodes and their output rows (`multihost`), and
device-side mate pairing (`mating_device`)."""

from geneevolve_tpu_torch.parallel.mesh import (  # noqa: F401
    make_deme_step,
    make_mesh,
    make_sharded_step,
    shard_state,
)
