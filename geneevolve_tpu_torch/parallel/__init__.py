"""Work that the JAX package runs on its device mesh: so far device-side
mate pairing (`mating_device`). The mesh itself (`parallel/mesh.py`,
`parallel/multihost.py` of the JAX package) is not ported yet."""
