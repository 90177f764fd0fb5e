"""Command line: the reference GeneEvolve flag set, run on a CUDA device.

    python -m geneevolve_tpu_torch --file_gen_info ... --file_hap_name ... [flags]

Runs one or several populations (`--next_population`, with migration and
`--gamma`) with the segment engine (the default; resident CV matrix, or
the ledger gather path when it does not fit or when several populations
run) or, under `--backend dense`, with the bit-packed dense engine, and
saves or resumes checkpoints. `--mesh` shards either backend's
individuals over ranks, one a card (`parallel/`), and the dense backend's
packed words over 'loci': under torchrun this process joins the process
group torchrun describes, else it starts the ranks itself. Without a CUDA
device the run fails: it never falls back to the CPU.
"""

from __future__ import annotations

import sys
import time

from geneevolve_tpu_torch.config import (
    ConfigError,
    build_mesh,
    local_devices,
    mesh_shape,
    parse_args,
    print_config,
)

_HELP = """geneevolve-tpu-torch — the geneevolve-tpu engines on PyTorch/CUDA

 Accepts the GeneEvolve flag set (see `python -m geneevolve_tpu --help`).
 This port runs on a CUDA device:
   --file_gen_info --file_hap_name --file_ref_vcf --file_recom_map
   --file_mutation_map --file_cv_info --file_cvs --va --vd --vc --ve --vf
   --omega --lambda --beta --RM --MM --vt_type --avoid_inbreeding
   --seed --prefix --no_output --debug
 Several populations, on both backends:
   --next_population (starts the next population's flags)
   --file_migration (one row a generation: the n_pop x n_pop matrix)
   --gamma (per phenotype: environmental offsets between populations)
 Checkpoints, on both backends (the JAX package's format):
   --checkpoint_every N (<prefix>.ckpt.npz after generation 0 and every N)
   --resume <file> (continue a run bit-identically from a checkpoint)
   --stage_sync (device fence per stage: device-true timing)
   --profile <dir> (torch.profiler trace of the whole run, with its spans)
   --backend segment (default) | dense (bit-packed genome planes)
 Genotype files, on both backends:
   --out_hap --out_vcf --out_plink --out_plink01 --file_output_generations
   --out_interval (segment backend: the IBD ledger as .int files)
 The segment backend's A/D reads a resident CV matrix, or paints the CVs
 (and, with several populations, each chromatid's root population) from
 the ledger when it does not fit the card, when several populations run,
 or under GE_NO_RESIDENT_CV=1.
 --device_mating (assortative pairing on the device; both backends)
 --mesh auto|ind=N[,loci=M] (individuals sharded over ranks, one a card
   over NCCL; outputs byte-identical to one card; under `torchrun
   --nproc_per_node N -m geneevolve_tpu_torch` the ranks join torchrun's
   group, else this process starts them; `auto`: every card on 'ind').
   The segment backend replicates over 'loci'. The dense backend also
   splits its packed words over 'loci': a chromosome's words are padded
   to a multiple of 32 loci, and the genome's word count must divide by
   M (refused otherwise, as the JAX package refuses it); rank 0 writes
   whole genotype files and checkpoints.
"""


def main(argv=None, device=None) -> int:
    """Run one scenario. `device` defaults to "cuda"; tests pass "cpu" to
    run the kernels' plain versions."""
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not argv or any(a in ("--help", "-h", "?") for a in argv):
        print(_HELP)
        return 0
    t0 = time.time()
    try:
        cfg = parse_args(argv)
    except ConfigError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "geneevolve_tpu_torch needs a CUDA device; none is available"
            )
        device = "cuda"
    if cfg.mesh:
        from geneevolve_tpu_torch.parallel import multihost

        # under torchrun: join its group (rank 0 alone prints)
        rank, _world = multihost.maybe_init_distributed(device)
        if rank == 0:
            print_config(cfg)
        try:
            _run_mesh(cfg, device)
        except ConfigError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        if rank == 0:
            print(f" Total time: {time.time() - t0:.1f} s")
        return 0
    print_config(cfg)
    if cfg.backend == "dense":
        from geneevolve_tpu_torch.dense.backend import DenseSimulation as Sim
    else:
        from geneevolve_tpu_torch.core.engine import Simulation as Sim

    sim = Sim(cfg, device=device)
    sim.run()
    print(f" Total time: {time.time() - t0:.1f} s")
    return 0


def _mesh_line(shape, device: str, backend: str) -> str:
    dims = {"ind": shape[0], "loci": shape[1]}
    return (f" Device mesh: {dims} on {shape[0] * shape[1]} x "
            f"{device} ranks over {backend}")


def _run_mesh(cfg, device: str) -> None:
    """Run `cfg` on its --mesh: in the process group this process belongs
    to, or on ranks it starts (one a card over NCCL; on the CPU gloo
    ranks, and `auto` one rank, as JAX has one CPU device)."""
    import torch

    from geneevolve_tpu_torch.parallel import launch, multihost

    rank, _world = multihost.process_info()
    if torch.distributed.is_initialized():
        mesh = build_mesh(cfg.mesh, device)
        if rank == 0:
            print(_mesh_line(mesh.shape, device, mesh.backend), flush=True)
        _simulate(rank, cfg, mesh)
        return
    backend = multihost.default_backend(device)
    spec = cfg.mesh
    if spec == "auto" and torch.device(device).type == "cpu":
        spec = "ind=1"
    shape = mesh_shape(spec, local_devices(device))
    print(_mesh_line(shape, device, backend), flush=True)
    launch.launch(_mesh_rank, shape[0] * shape[1], (cfg, shape, device),
                  device=device, backend=backend)


def _simulate(rank: int, cfg, mesh) -> None:
    if cfg.backend == "dense":
        from geneevolve_tpu_torch.dense.backend import DenseSimulation as Sim
    else:
        from geneevolve_tpu_torch.core.engine import Simulation as Sim

    Sim(cfg, mesh=mesh, verbose=rank == 0).run()


def _mesh_rank(rank: int, cfg, shape, device: str) -> None:
    from geneevolve_tpu_torch.parallel.mesh import make_mesh

    _simulate(rank, cfg, make_mesh(shape, device))


if __name__ == "__main__":
    raise SystemExit(main())
