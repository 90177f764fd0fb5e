"""Scenario configuration and GeneEvolve-compatible CLI parsing (the
port's copy of geneevolve_tpu/config.py; `build_mesh` builds the port's
rank mesh in place of the JAX `Mesh`).

Mirrors the semantics of the reference flag parser
(`src/parameters.cpp:15-213`): `--next_population` partitions
subsequent per-population flags, per-phenotype flags are repeatable, and the
defaults are va=vd=-1 ("use cv_info variances as-is"), vc=0, ve=1, vf=0,
omega=beta=lambda=1, gamma=0, vt_type=1 (`parameters.cpp:153-209`,
`parameters.h:105`).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class PhenotypeConfig:
    """Per-phenotype settings (one set per --file_cv_info)."""

    file_cv_info: str
    file_cvs: str
    va: float = -1.0  # -1 => use raw cv_info effect sizes (no rescale)
    vd: float = -1.0  # -1 => raw; 0 => dominance off
    vc: float = 0.0  # common (sibling) env variance
    ve: float = 1.0  # unique env variance
    vf: float = 0.0  # familial (vertical transmission) variance
    omega: float = 1.0  # weight in mating value
    beta: float = 1.0  # vertical-transmission coefficient (adjusted at gen 0)
    lambda_: float = 1.0  # weight in selection value


@dataclass
class PopulationConfig:
    """Per-population settings (one block per --next_population)."""

    file_gen_info: str = ""
    file_hap_name: str = ""  # hap/legend/indv address file
    file_ref_vcf: str = ""  # VCF address file
    file_recom_map: str = ""
    file_mutation_map: str = ""
    mm_percent: float = 0.0  # probability of a second spouse (--MM)
    rm: bool = False  # random mating instead of assortative (--RM)
    phenotypes: List[PhenotypeConfig] = field(default_factory=list)


@dataclass
class ScenarioConfig:
    """Full simulation scenario (CLI-equivalent of the reference Parameters)."""

    populations: List[PopulationConfig] = field(default_factory=list)
    gamma: List[float] = field(default_factory=list)  # per-phenotype pop env effect
    file_migration: str = ""
    avoid_inbreeding: bool = False
    vt_type: int = 1  # 1: transmit prev phen; 2: transmit prev F
    seed: int = 0  # 0 => time-based
    prefix: str = "out"
    out_hap: bool = False
    out_plink: bool = False
    out_plink01: bool = False
    out_vcf: bool = False
    out_interval: bool = False
    no_output: bool = False  # accepted for Examples.zip compat (reference v1.1.0 flag)
    file_output_generations: str = ""
    debug: bool = False
    profile_dir: str = ""  # write a profiler trace of the main loop here
    checkpoint_every: int = 0  # write <prefix>.ckpt.npz every N generations
    resume: str = ""  # checkpoint file to restore and continue from
    device_mating: bool = False  # run mate pairing on device
    stage_sync: bool = False  # fence the device after each stage so the
    # StageTimer breakdown is device-true (adds sync barriers that break
    # async overlap; for profiling only)
    mesh: str = ""  # device mesh: "auto" (all local devices on the ind
    # axis) or "ind=N[,loci=M]"; empty = single-device. The reference is a
    # single process (`Main.cpp:26-88`); this is the multi-chip scaling
    # surface (results are bit-identical to the unsharded run).
    backend: str = "segment"  # genome backend: segment (reference-parity
    # interval ledger) | dense (materialized bit-packed planes, the
    # flagship-throughput path; single population, no .int output)

    @property
    def n_pop(self) -> int:
        return len(self.populations)

    @property
    def n_pheno(self) -> int:
        return len(self.populations[0].phenotypes) if self.populations else 0

    @property
    def ref_is_vcf(self) -> bool:
        # when both are given, VCF wins (`Simulation.cpp:182-189`)
        return any(p.file_ref_vcf for p in self.populations)


class ConfigError(ValueError):
    pass


# flags that take one value and land in the current population block
_POP_SCALAR_FLAGS = {
    "--file_gen_info": "file_gen_info",
    "--file_hap_name": "file_hap_name",
    "--file_ref_vcf": "file_ref_vcf",
    "--file_recom_map": "file_recom_map",
    "--file_mutation_map": "file_mutation_map",
}

# repeatable per-phenotype flags -> attribute on PhenotypeConfig
_PHENO_FLAGS = {
    "--va": "va",
    "--vd": "vd",
    "--vc": "vc",
    "--ve": "ve",
    "--vf": "vf",
    "--omega": "omega",
    "--beta": "beta",
    "--lambda": "lambda_",
}


def parse_args(argv: List[str]) -> ScenarioConfig:
    """Parse a GeneEvolve-style argv (without the program name)."""
    n_pop = 1 + sum(1 for a in argv if a == "--next_population")

    # raw per-pop accumulation (phenotype lists may be filled out of order)
    pops = [PopulationConfig() for _ in range(n_pop)]
    cv_info: List[List[str]] = [[] for _ in range(n_pop)]
    cvs: List[List[str]] = [[] for _ in range(n_pop)]
    pheno_vals = {k: [[] for _ in range(n_pop)] for k in _PHENO_FLAGS.values()}
    gamma: List[float] = []
    cfg = ScenarioConfig(populations=pops)

    ipop = 0
    i = 0

    def take_value(flag: str) -> str:
        nonlocal i
        i += 1
        if i >= len(argv):
            raise ConfigError(f"missing value for {flag}")
        return argv[i]

    while i < len(argv):
        a = argv[i]
        if a == "--next_population":
            ipop += 1
        elif a in _POP_SCALAR_FLAGS:
            setattr(pops[ipop], _POP_SCALAR_FLAGS[a], take_value(a))
        elif a == "--MM":
            pops[ipop].mm_percent = float(take_value(a))
        elif a == "--RM":
            pops[ipop].rm = True
        elif a == "--vt_type":
            cfg.vt_type = int(take_value(a))
        elif a == "--file_cv_info":
            cv_info[ipop].append(take_value(a))
        elif a == "--file_cvs":
            cvs[ipop].append(take_value(a))
        elif a in _PHENO_FLAGS:
            pheno_vals[_PHENO_FLAGS[a]][ipop].append(float(take_value(a)))
        elif a == "--gamma":
            gamma.append(float(take_value(a)))
        elif a == "--file_migration":
            cfg.file_migration = take_value(a)
        elif a == "--avoid_inbreeding":
            cfg.avoid_inbreeding = True
        elif a == "--seed":
            cfg.seed = int(float(take_value(a)))
        elif a == "--debug":
            cfg.debug = True
        elif a == "--profile":
            cfg.profile_dir = take_value(a)
        elif a == "--prefix":
            cfg.prefix = take_value(a)
        elif a == "--out_hap":
            cfg.out_hap = True
        elif a == "--out_plink":
            cfg.out_plink = True
        elif a == "--out_plink01":
            cfg.out_plink01 = True
        elif a == "--out_vcf":
            cfg.out_vcf = True
        elif a == "--out_interval":
            cfg.out_interval = True
        elif a == "--no_output":
            cfg.no_output = True
        elif a == "--file_output_generations":
            cfg.file_output_generations = take_value(a)
        elif a == "--checkpoint_every":
            cfg.checkpoint_every = int(take_value(a))
        elif a == "--resume":
            cfg.resume = take_value(a)
        elif a == "--device_mating":
            cfg.device_mating = True
        elif a == "--stage_sync":
            cfg.stage_sync = True
        elif a == "--backend":
            cfg.backend = take_value(a)
        elif a == "--mesh":
            cfg.mesh = take_value(a)
        elif a in ("--help", "-h", "?", "nothing"):
            pass
        else:
            raise ConfigError(f"unknown parameter [{a}]")
        i += 1

    # assemble phenotypes with defaults
    for p in range(n_pop):
        npheno = len(cv_info[p])
        if len(cvs[p]) != npheno:
            raise ConfigError(
                f"each phenotype needs one --file_cvs (population {p + 1})"
            )
        defaults = PhenotypeConfig(file_cv_info="", file_cvs="")
        for attr, per_pop in pheno_vals.items():
            vals = per_pop[p]
            if vals and len(vals) != npheno:
                raise ConfigError(
                    f"each phenotype needs one --{attr.rstrip('_')} "
                    f"(population {p + 1})"
                )
        for j in range(npheno):
            ph = PhenotypeConfig(file_cv_info=cv_info[p][j], file_cvs=cvs[p][j])
            for attr, per_pop in pheno_vals.items():
                vals = per_pop[p]
                setattr(ph, attr, vals[j] if vals else getattr(defaults, attr))
            pops[p].phenotypes.append(ph)

    cfg.gamma = gamma if gamma else [0.0] * (len(pops[0].phenotypes) or 0)
    if cfg.seed == 0:
        cfg.seed = (time.time_ns() % 100000000) + 1
    validate(cfg)
    return cfg


def parse_mesh_spec(spec: str):
    """'auto' -> None (all local devices on the ind axis) or
    'ind=N[,loci=M]' -> (N, M). Raises ConfigError on bad syntax."""
    if spec == "auto":
        return None
    shape = {"ind": 0, "loci": 1}
    for part in spec.split(","):
        if "=" not in part:
            raise ConfigError(
                f"[--mesh] expects 'auto' or 'ind=N[,loci=M]', got '{spec}'"
            )
        k, _, v = part.partition("=")
        if k not in shape:
            raise ConfigError(f"[--mesh] unknown axis '{k}' (ind, loci)")
        try:
            shape[k] = int(v)
        except ValueError:
            raise ConfigError(f"[--mesh] axis size must be an integer: '{part}'")
        if shape[k] < 1:
            raise ConfigError(f"[--mesh] axis size must be >= 1: '{part}'")
    if not shape["ind"]:
        raise ConfigError("[--mesh] requires an ind=N axis")
    return (shape["ind"], shape["loci"])


def local_devices(device: str = "cuda") -> int:
    """What a --mesh spec may use: the ranks of a joined process group;
    else this machine's cards, or on the CPU its cores."""
    import os

    import torch
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return len(os.sched_getaffinity(0))


def mesh_shape(spec: str, n_dev: int):
    """(ind, loci) of a --mesh spec over `n_dev` devices ('auto': all of
    them on 'ind'); raises ConfigError when the spec needs more."""
    shape = parse_mesh_spec(spec)
    if shape is None:
        shape = (n_dev, 1)
    if shape[0] * shape[1] > n_dev:
        raise ConfigError(
            f"[--mesh] {spec} needs {shape[0] * shape[1]} devices; "
            f"only {n_dev} visible"
        )
    return shape


def build_mesh(spec: str, device: str = "cuda"):
    """The port's mesh (`parallel.mesh.Mesh`) named by a --mesh spec over
    the joined process group (None if the spec is empty); its ranks must
    be exactly the devices the spec asks for."""
    if not spec:
        return None
    import torch.distributed as dist

    from geneevolve_tpu_torch.parallel.mesh import make_mesh

    shape = mesh_shape(spec, local_devices(device))
    world = dist.get_world_size()
    if shape[0] * shape[1] != world:
        raise ConfigError(
            f"[--mesh] {spec} needs {shape[0] * shape[1]} devices; the "
            f"process group has {world} ranks"
        )
    return make_mesh(shape, device)


def _num(v: float) -> str:
    """C++ default-stream float formatting (6 significant digits, no
    trailing zeros): '1', '0.5', '-1'."""
    return f"{v:g}"


def print_config(cfg: ScenarioConfig, out=None) -> None:
    """Echo the parsed configuration at startup, matching
    `Parameters::print` (`src/parameters.cpp:384-447`)."""
    import sys

    w = (out or sys.stdout).write
    onoff = lambda b: "On" if b else "Off"
    w("\n Options:\n\n")
    for i, pop in enumerate(cfg.populations, start=1):
        w(f"  Population {i}:\n")
        w(f"      --file_gen_info          : [{pop.file_gen_info}]\n")
        w(f"      --file_hap_name          : [{pop.file_hap_name}]\n")
        w(f"      --file_ref_vcf           : [{pop.file_ref_vcf}]\n")
        w(f"      --file_recom_map         : [{pop.file_recom_map}]\n")
        w(f"      --file_mutation_map      : [{pop.file_mutation_map}]\n")
        w(f"      --MM                     : [{_num(pop.mm_percent)}]\n")
        w(f"      --RM                     : [{onoff(pop.rm)}]\n")
        w(f"      --vt_type                : [{cfg.vt_type}]\n")
        for j, ph in enumerate(pop.phenotypes, start=1):
            w(f"      phenotype: {j}\n")
            w(f"        --file_cv_info         : [{ph.file_cv_info}]\n")
            w(f"        --file_cvs             : [{ph.file_cvs}]\n")
            w(f"        --va                   : [{_num(ph.va)}]\n")
            w(f"        --vd                   : [{_num(ph.vd)}]\n")
            w(f"        --vc                   : [{_num(ph.vc)}]\n")
            w(f"        --ve                   : [{_num(ph.ve)}]\n")
            w(f"        --vf                   : [{_num(ph.vf)}]\n")
            w(f"        --omega                : [{_num(ph.omega)}]\n")
            w(f"        --lambda               : [{_num(ph.lambda_)}]\n")
            w(f"        --beta                 : [{_num(ph.beta)}]\n")
    w("  Immigration parameters\n")
    w(f"      --file_migration         : [{cfg.file_migration}]\n")
    w(
        "  Environmental effects specific to each population "
        "(for each phenotype)\n"
    )
    for g in cfg.gamma:
        w(f"      --gamma                  : [{_num(g)}]\n")
    w("  Output parameters\n")
    w(f"      --out_hap                : [{onoff(cfg.out_hap)}]\n")
    w(f"      --out_plink              : [{onoff(cfg.out_plink)}]\n")
    w(f"      --out_plink01            : [{onoff(cfg.out_plink01)}]\n")
    w(f"      --out_vcf                : [{onoff(cfg.out_vcf)}]\n")
    w(f"      --out_interval           : [{onoff(cfg.out_interval)}]\n")
    w(f"      --file_output_generations: [{cfg.file_output_generations}]\n")
    w("  Other parameters\n")
    w(f"      --prefix                 : [{cfg.prefix}]\n")
    w(f"      --avoid_inbreeding       : [{onoff(cfg.avoid_inbreeding)}]\n")
    w(f"      --seed                   : [{cfg.seed}]\n")
    w(f"      --debug                  : [{onoff(cfg.debug)}]\n")
    w("\n")


def validate(cfg: ScenarioConfig) -> None:
    """Same checks as `Parameters::check` (`parameters.cpp:215-382`)."""
    if not cfg.populations or not cfg.populations[0].file_gen_info:
        raise ConfigError("missing parameter [--file_gen_info]")
    nphen = len(cfg.populations[0].phenotypes)
    for p, pop in enumerate(cfg.populations, start=1):
        if not pop.file_gen_info:
            raise ConfigError(f"missing [--file_gen_info] in population {p}")
        if not pop.file_hap_name and not pop.file_ref_vcf:
            raise ConfigError(
                f"missing reference file ([--file_hap_name]/[--file_ref_vcf]) "
                f"in population {p}"
            )
        if not pop.file_recom_map:
            raise ConfigError(f"missing [--file_recom_map] in population {p}")
        if len(pop.phenotypes) == 0:
            raise ConfigError(f"missing [--file_cv_info] in population {p}")
        if len(pop.phenotypes) != nphen:
            raise ConfigError(
                "the number of phenotypes should be the same for each population"
            )
        for ph in pop.phenotypes:
            if not (ph.va > 0 or ph.va == -1):
                raise ConfigError("[--va] should be positive (or -1)")
            if not (ph.vd >= 0 or ph.vd == -1):
                raise ConfigError("[--vd] should not be negative (or -1)")
            if ph.vc < 0:
                raise ConfigError("[--vc] should not be negative")
            if ph.ve < 0:
                raise ConfigError("[--ve] should not be negative")
            if ph.vf < 0:
                raise ConfigError("[--vf] should not be negative")
        if not (0 <= pop.mm_percent <= 1):
            raise ConfigError("[--MM] should be between 0 and 1")
    if len(cfg.gamma) != nphen:
        raise ConfigError(
            f"the number of [--gamma] must equal the number of phenotypes ({nphen})"
        )
    if cfg.n_pop > 1 and not cfg.file_migration:
        raise ConfigError(
            "with more than one population, [--file_migration] is required"
        )
    if cfg.backend not in ("segment", "dense"):
        raise ConfigError("[--backend] must be 'segment' or 'dense'")
    if cfg.mesh:
        parse_mesh_spec(cfg.mesh)  # syntax check (device count at runtime)
    if cfg.backend == "dense":
        if cfg.out_interval:
            raise ConfigError(
                "[--backend dense] has no segment ledger; --out_interval "
                "needs the segment backend"
            )
