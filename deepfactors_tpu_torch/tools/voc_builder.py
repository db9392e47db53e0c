"""voc_builder: train a BoW vocabulary from a source's frames (reference
sources/tools/voc_builder.cpp builds a DBoW2 vocabulary from TUM
sequences).

PyTorch port of the JAX package's ``tools/voc_builder.py``: descriptors
are detected on ``--device`` (``features/detector.detect``), read to the
host, and the binary k-means (``loop/vocabulary.train_vocabulary``) runs on
the host, as in the reference. The ``.npz`` holds ``words`` [V, 8] uint32
and ``idf`` [V] float32, the JAX tool's keys and dtypes, so that each
package loads the other's file.

Usage: python -m deepfactors_tpu_torch.tools.voc_builder --source <url>
       [--num_words 256] [--max_frames 100] [--nfeatures 200]
       --out vocab.npz [--device cpu]
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
    """Detect, train and save; returns the vocabulary (host arrays), the
    descriptor count and the path written."""
    flags = parse_args(list(argv))
    dev = device_from_flag(flags.get("device", "cuda"))
    source = flags.get("source", "synthetic://128x96:40")
    num_words = int(flags.get("num_words", 256))
    max_frames = int(flags.get("max_frames", 100))
    out = flags.get("out", "vocab.npz")

    iface = drivers.get_interface_from_url(source, device=dev)
    cfg = det.DetectorConfig(max_keypoints=int(flags.get("nfeatures", 200)))
    descs = []
    for i, fd in enumerate(iface.frames()):
        if i >= max_frames:
            break
        f = det.detect(torch.as_tensor(fd.img, device=dev), cfg)
        descs.append(f.descriptor[f.valid].cpu().numpy())
    all_descs = np.concatenate(descs).view(np.uint32)
    log(f"collected {len(all_descs)} descriptors from {len(descs)} frames")
    voc = vb.train_vocabulary(all_descs, num_words=num_words, device="cpu")
    vb.save_vocabulary(out, voc)
    log(f"wrote {num_words}-word vocabulary -> {out}")
    words, idf = vb.vocabulary_to_numpy(voc)
    return dict(words=words, idf=idf, descriptors=len(all_descs), out=out)


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
