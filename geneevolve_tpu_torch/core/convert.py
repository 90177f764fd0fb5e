"""Population state to and from numpy arrays, under the JAX package's field
names, so a generation's state can be carried between the JAX package and
this one:

- `state_*`: the segment engine's `PopState` (`seg_st`, `seg_hap`, `mut`,
  `cv`, plus the host fields);
- `dense_state_*`: the dense backend's `DensePopState` (`hap`, per-phenotype
  `cv` list, plus the host fields); `dense_shard_from_numpy` gives one
  rank's part of it on a mesh (`dense.backend.plane_block`) and
  `dense_shard_to_numpy` the whole state back from every rank's part;
- `packed_state_*`: the packed step's dict (`hap`, `cv`, `cv_idx`, `eff`,
  `clip`); `packed_shard_from_numpy` gives one rank's shard of it on a
  mesh (`parallel.mesh.shard_state`), so both packages step the same
  founders.

Packed words are uint32 in the JAX package and int32 here: the arrays are
reinterpreted (`.view`), never converted, so every bit pattern survives.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from geneevolve_tpu_torch.core.engine import PopState

if TYPE_CHECKING:
    from geneevolve_tpu_torch.dense.backend import DensePopState

HOST_FIELDS = ("sex", "ids", "ped", "comp", "mv", "sv", "svf")
PLANES = ("seg_st", "seg_hap", "mut", "cv")


def state_from_numpy(d: dict, device="cuda") -> PopState:
    """`d` holds `n`, the planes as arrays ((nchr, rows, 2, ...), rows >=
    n; `cv` None or absent on the gather path) and the host fields."""
    planes = {k: None if d.get(k) is None
              else torch.as_tensor(np.array(d[k]), device=device)
              for k in PLANES}
    host = {k: d[k] for k in HOST_FIELDS if k in d}
    return PopState(n=int(d["n"]), **planes, **host)


def state_to_numpy(st: PopState) -> dict:
    out = {k: None if getattr(st, k) is None else getattr(st, k).cpu().numpy()
           for k in PLANES}
    out["n"] = st.n
    out.update({k: getattr(st, k) for k in HOST_FIELDS})
    return out


def _words_in(a, device) -> torch.Tensor:
    """uint32 (or int32) words -> int32 tensor, bits unchanged."""
    return torch.as_tensor(np.array(a).view(np.int32),
                           device=device)


def _words_out(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def dense_state_from_numpy(d: dict, device="cuda") -> DensePopState:
    """`d` holds `n`, `hap` ((rows, 2, mw) uint32 words), `cv` (a list of
    (rows, 2, ncv_j) uint8 arrays, one per phenotype) and the host
    fields."""
    from geneevolve_tpu_torch.dense.backend import DensePopState

    host = {k: d[k] for k in HOST_FIELDS if k in d}
    return DensePopState(
        n=int(d["n"]), hap=_words_in(d["hap"], device),
        cv=[torch.as_tensor(np.array(c), device=device) for c in d["cv"]],
        **host,
    )


def dense_state_to_numpy(st: DensePopState) -> dict:
    out = {"n": st.n, "hap": _words_out(st.hap),
           "cv": [c.cpu().numpy() for c in st.cv]}
    out.update({k: getattr(st, k) for k in HOST_FIELDS})
    return out


def dense_shard_from_numpy(d: dict, mesh) -> DensePopState:
    """This rank's part of a dense state given whole (as
    `dense_state_from_numpy` takes it): its block of rows of the planes and
    CV matrices and its window of the words, on the mesh's device, with
    the whole row count in `rows`."""
    from geneevolve_tpu_torch.dense.backend import take_block

    st = dense_state_from_numpy(d, device="cpu")
    st.rows = st.hap.shape[0]
    st.hap = take_block(st.hap, mesh).to(mesh.device)
    st.cv = [take_block(c, mesh).to(mesh.device) for c in st.cv]
    return st


def dense_shard_to_numpy(st: DensePopState, mesh) -> dict:
    """The whole dense state as numpy (words as uint32) from every rank's
    part (collectives every rank joins)."""
    from geneevolve_tpu_torch.dense.backend import gather_block

    rows = st.rows
    out = {"n": st.n,
           "hap": _words_out(gather_block(st.hap, rows, mesh)),
           "cv": [gather_block(c, rows, mesh).cpu().numpy() for c in st.cv]}
    out.update({k: getattr(st, k) for k in HOST_FIELDS})
    return out


def packed_state_from_numpy(d: dict, device="cuda") -> dict:
    """The packed step's state dict from numpy: `hap` uint32 words, `cv`
    uint8, `cv_idx` int32, `eff` float32, `clip` an integer."""
    return {
        "hap": _words_in(d["hap"], device),
        "cv": torch.as_tensor(np.array(d["cv"]), device=device),
        "cv_idx": torch.as_tensor(np.array(d["cv_idx"], np.int32),
                                  device=device),
        "eff": torch.as_tensor(np.array(d["eff"], np.float32),
                               device=device),
        "clip": torch.tensor(int(d["clip"]), dtype=torch.int64,
                             device=device),
    }


def packed_state_to_numpy(state: dict) -> dict:
    return {
        "hap": _words_out(state["hap"]),
        "cv": state["cv"].cpu().numpy(),
        "cv_idx": state["cv_idx"].cpu().numpy(),
        "eff": state["eff"].cpu().numpy(),
        "clip": int(state["clip"]),
    }


def packed_shard_from_numpy(d: dict, mesh) -> dict:
    """This rank's shard of a packed state given as whole arrays (as
    `packed_state_from_numpy` takes them), on the mesh's device."""
    from geneevolve_tpu_torch.parallel.mesh import shard_state

    return shard_state(packed_state_from_numpy(d, device="cpu"), mesh)
