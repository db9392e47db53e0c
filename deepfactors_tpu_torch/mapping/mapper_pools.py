"""Host-side factor pools shared by the scheduler and the Mapper (own copy
of ``deepfactors_tpu/mapping/mapper_pools.py``)."""
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


class RepPool(NamedTuple):
    """Reprojection factor pool."""

    src: np.ndarray     # [P]
    dst: np.ndarray     # [P]
    active: np.ndarray  # [P]
    kp0: np.ndarray     # [P, M, 2]
    kp1: np.ndarray     # [P, M, 2]
    mvalid: np.ndarray  # [P, M]


def _empty_rep_pool(P: int, M: int) -> RepPool:
    return RepPool(
        src=np.zeros(P, np.int32), dst=np.zeros(P, np.int32),
        active=np.zeros(P, bool),
        kp0=np.zeros((P, M, 2), np.float32),
        kp1=np.zeros((P, M, 2), np.float32),
        mvalid=np.zeros((P, M), bool),
    )


class GeoPool(NamedTuple):
    """Sparse geometric factor pool."""

    src: np.ndarray     # [P]
    dst: np.ndarray     # [P]
    active: np.ndarray  # [P]
    points: np.ndarray  # [P, N, 2]


def _empty_geo_pool(P: int, N: int) -> GeoPool:
    return GeoPool(
        src=np.zeros(P, np.int32), dst=np.zeros(P, np.int32),
        active=np.zeros(P, bool),
        points=np.zeros((P, N, 2), np.float32),
    )
