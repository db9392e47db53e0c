"""voc_test: a BoW vocabulary's discrimination on a sequence (reference
sources/tools/voc_test.cpp): score each frame against all others; report
self / adjacent against far similarity.

PyTorch port of the JAX package's ``tools/voc_test.py``: detection, the
BoW vectors and the scores run on ``--device``. ``--vocab`` loads a
``.npz`` of either package's voc_builder; without it a random vocabulary
of ``--num_words`` words (the JAX package's draws).

Usage: python -m deepfactors_tpu_torch.tools.voc_test --source <url>
       [--vocab vocab.npz] [--max_frames 40] [--device cpu]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import parse_args
from ..features import detector as det
from ..io import drivers
from ..loop import vocabulary as vb
from .common import device_from_flag


def main(argv, log=print) -> dict:
    """Score the sequence; returns the BoW vectors [n, V], the score matrix
    S [n, n] and the three means (host)."""
    flags = parse_args(list(argv))
    dev = device_from_flag(flags.get("device", "cuda"))
    source = flags.get("source", "synthetic://128x96:20")
    iface = drivers.get_interface_from_url(source, device=dev)
    if "vocab" in flags:
        voc = vb.load_vocabulary(flags["vocab"], device=dev)
    else:
        voc = vb.random_vocabulary(int(flags.get("num_words", 256)),
                                   device=dev)

    cfg = det.DetectorConfig(max_keypoints=int(flags.get("nfeatures", 200)))
    vecs = []
    for i, fd in enumerate(iface.frames()):
        if i >= int(flags.get("max_frames", 40)):
            break
        f = det.detect(torch.as_tensor(fd.img, device=dev), cfg)
        vecs.append(vb.bow_vector(voc, f.descriptor, f.valid))
    db = torch.stack(vecs)
    n = len(vecs)
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    S = torch.stack([vb.similarity(v, db, ok) for v in vecs]).cpu().numpy()
    near = np.mean([S[i, min(i + 1, n - 1)] for i in range(n)])
    far = np.mean([S[i, (i + n // 2) % n] for i in range(n)])
    self_ = np.mean(np.diag(S))
    log(f"frames: {n}  self: {self_:.3f}  adjacent: {near:.3f}  "
        f"far: {far:.3f}")
    log(f"discrimination (adjacent - far): {near - far:.3f}")
    return dict(bow=db.cpu().numpy(), S=S, self=float(self_),
                adjacent=float(near), far=float(far))


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
