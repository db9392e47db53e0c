"""JSON sequence collections (common/image_sequences.h:18-63).

The PyTorch port's own copy of ``deepfactors_tpu/io/sequences.py``.

A sequences file maps collection names to dataset sequences with base
directories, e.g.:

    {"scannet": {"base_dir": "/data/scannet",
                 "sequences": {"scene0565_00": {"path": "scans/scene0565_00",
                                                "format": "scannet"}}}}

``resolve(name)`` returns the driver URL (``io/drivers.py`` scheme) for a
"collection/sequence" name.
"""
from __future__ import annotations

import json
import os
from typing import Dict


class SequenceCollection:
    def __init__(self, path: str):
        with open(path) as f:
            self.data: Dict = json.load(f)

    def collections(self):
        return sorted(self.data.keys())

    def sequences(self, collection: str):
        return sorted(self.data[collection].get("sequences", {}).keys())

    def resolve(self, name: str) -> str:
        """'collection/sequence' -> driver URL (e.g. scannet:///abs/path)."""
        coll, seq = name.split("/", 1)
        c = self.data[coll]
        s = c["sequences"][seq]
        base = c.get("base_dir", "")
        path = os.path.join(base, s["path"]) if base else s["path"]
        fmt = s.get("format", coll)
        return f"{fmt}://{path}"
