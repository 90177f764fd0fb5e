"""Population state to and from numpy arrays, under the JAX `PopState`
field names (`seg_st`, `seg_hap`, `mut`, `cv`, plus the host fields), so a
generation's state can be carried between the JAX package and this one."""

from __future__ import annotations

import numpy as np
import torch

from geneevolve_tpu_torch.core.engine import PopState

HOST_FIELDS = ("sex", "ids", "ped", "comp", "mv", "sv", "svf")
PLANES = ("seg_st", "seg_hap", "mut", "cv")


def state_from_numpy(d: dict, device="cpu") -> PopState:
    """`d` holds `n`, the four planes as arrays ((nchr, rows, 2, ...),
    rows >= n) and the host fields."""
    planes = {k: torch.as_tensor(np.array(d[k]), device=device)
              for k in PLANES}
    host = {k: d[k] for k in HOST_FIELDS if k in d}
    return PopState(n=int(d["n"]), **planes, **host)


def state_to_numpy(st: PopState) -> dict:
    out = {k: getattr(st, k).cpu().numpy() for k in PLANES}
    out["n"] = st.n
    out.update({k: getattr(st, k) for k in HOST_FIELDS})
    return out
