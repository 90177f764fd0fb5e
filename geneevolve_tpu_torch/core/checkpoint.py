"""Generation-granular checkpoint/resume (the port's copy of
geneevolve_tpu/core/checkpoint.py, numpy only; the format is the same, so
a checkpoint written by either package resumes in the other).

The reference has no checkpointing; its documented workaround is dumping
genotype outputs and restarting them as a new founder panel (PDF §3.7
item 2). Here the full simulation state is a small pytree — segment ledgers,
mutation lists, phenotype components, pedigree arrays, per-generation
trajectories and the frozen gen-0 scaling constants — so a native
save/restore costs one compressed npz per checkpoint and resume is exact:
a resumed run continues bit-identically (stage-folded RNG keys depend only
on (seed, gen, stage), never on history).

CLI: `--checkpoint_every N` writes `<prefix>.ckpt.npz` every N generations;
`--resume <file>` restores and continues.
"""

from __future__ import annotations

import io
import os
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from geneevolve_tpu_torch.core.engine import Simulation

FORMAT_VERSION = 2  # v2: genome state stacked over chromosomes, scalar caps


def save(sim: "Simulation", gen: int, path: str) -> None:
    """Write the complete simulation state after generation `gen`."""
    data = {
        "format_version": FORMAT_VERSION,
        "gen": gen,
        "seed": sim.cfg.seed,
        "backend": sim.cfg.backend,
        "n_pop": sim.n_pop,
        "n_pheno": sim.n_pheno,
        "s_cap": sim.s_cap,
        "m_cap": sim.m_cap,
    }
    for p in sim.pops:
        pre = f"pop{p.index}"
        st = p.state
        data[f"{pre}.n"] = st.n
        # genome arrays via the backend hook (the JAX package slices the
        # padding rows off; the port keeps them, see its hooks)
        for k, v in sim._ckpt_genome_arrays(st).items():
            data[f"{pre}.{k}"] = v
        data[f"{pre}.sex"] = st.sex
        data[f"{pre}.ids"] = st.ids
        for k, v in st.ped.items():
            data[f"{pre}.ped.{k}"] = v
        for k, v in st.comp.items():
            data[f"{pre}.comp.{k}"] = v
        data[f"{pre}.mv"] = st.mv
        data[f"{pre}.sv"] = st.sv
        data[f"{pre}.svf"] = st.svf
        data[f"{pre}.prev_phen"] = p.prev_phen
        data[f"{pre}.prev_F"] = p.prev_F
        data[f"{pre}.var_a_gen0"] = p.var_a_gen0
        data[f"{pre}.var_d_gen0"] = p.var_d_gen0
        data[f"{pre}.sv_gen0"] = np.array([p.sv_mean_gen0, p.sv_var_gen0])
        data[f"{pre}.beta"] = np.array([ph.beta for ph in p.phenos])
        for k, v in p.traj.items():
            data[f"{pre}.traj.{k}"] = v
    if not getattr(sim, "is_root", True):
        return  # under a mesh rank 0 writes (every rank gathers above)
    buf = io.BytesIO()
    np.savez_compressed(buf, **data)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)  # atomic: no torn checkpoints on interrupt


def load(sim: "Simulation", path: str) -> int:
    """Restore state written by `save`; returns the generation to resume
    *after* (i.e. the next step is gen+1)."""
    z = np.load(path, allow_pickle=False)
    if int(z["format_version"]) != FORMAT_VERSION:
        raise RuntimeError(
            f"checkpoint format {int(z['format_version'])} != {FORMAT_VERSION}"
        )
    if int(z["n_pop"]) != sim.n_pop or int(z["n_pheno"]) != sim.n_pheno:
        raise RuntimeError("checkpoint does not match the scenario config")
    if "backend" in z.files and str(z["backend"]) != sim.cfg.backend:
        raise RuntimeError(
            f"checkpoint was written by the {z['backend']} backend; "
            f"this run uses {sim.cfg.backend}"
        )
    if int(z["seed"]) != sim.cfg.seed:
        raise RuntimeError(
            "checkpoint seed differs from --seed; resumed trajectories would "
            "not continue the same run"
        )
    sim.s_cap = int(z["s_cap"])
    sim.m_cap = int(z["m_cap"])
    for p in sim.pops:
        pre = f"pop{p.index}"
        ped_keys = ("father", "mother", "ff", "fm", "mf", "mm")
        comp_keys = [
            k.split(".", 2)[2]
            for k in z.files
            if k.startswith(f"{pre}.comp.")
        ]
        host = dict(
            n=int(z[f"{pre}.n"]),
            sex=z[f"{pre}.sex"],
            ids=z[f"{pre}.ids"],
            ped={k: z[f"{pre}.ped.{k}"] for k in ped_keys},
            comp={k: z[f"{pre}.comp.{k}"] for k in comp_keys},
            mv=z[f"{pre}.mv"],
            sv=z[f"{pre}.sv"],
            svf=z[f"{pre}.svf"],
        )
        p.state = sim._ckpt_make_state(z, pre, host)
        p.prev_phen = z[f"{pre}.prev_phen"]
        p.prev_F = z[f"{pre}.prev_F"]
        p.var_a_gen0 = z[f"{pre}.var_a_gen0"]
        p.var_d_gen0 = z[f"{pre}.var_d_gen0"]
        p.sv_mean_gen0, p.sv_var_gen0 = (float(x) for x in z[f"{pre}.sv_gen0"])
        for ph, b in zip(p.phenos, z[f"{pre}.beta"]):
            ph.beta = float(b)
        for k in list(p.traj):
            p.traj[k] = z[f"{pre}.traj.{k}"]
    return int(z["gen"])
