"""Host-side photometric factor pool shared by the scheduler and the Mapper
(own copy of ``deepfactors_tpu/mapping/mapper_pools.py``; the reprojection
and geometric pools come with their slices)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class FactorPool(NamedTuple):
    """Photometric factor pool, one row per pool slot."""

    src: np.ndarray            # [P] int32 source keyframe slot
    dst: np.ndarray            # [P] int32 target slot (kf or frame)
    dst_is_frame: np.ndarray   # [P] bool
    level: np.ndarray          # [P] int32 current pyramid level
    active: np.ndarray         # [P] bool


def _empty_pool(P: int) -> FactorPool:
    return FactorPool(
        src=np.zeros(P, np.int32),
        dst=np.zeros(P, np.int32),
        dst_is_frame=np.zeros(P, bool),
        level=np.zeros(P, np.int32),
        active=np.zeros(P, bool),
    )
