"""Reference run of the JAX package's demo entry (``df_demo.py``) for the
port's demo (``deepfactors_tpu_torch/demo.py``, ``chip_smoke.py`` phase
10).

Runs ``df_demo.main(argv)`` on the CPU with two repairs patched in, the
two by which the port's demo departs from it (see that module's
docstring):
  - each frame is preprocessed once (``df_demo.py`` hands the
    preprocessed frame to ``process_frame``, which preprocesses it again:
    a remapped source is remapped twice);
  - the decoder's architecture (``base_ch``, ``pred_head``) comes from
    ``--network_path``'s JSON (``load_network_config`` drops it, and a
    network with a "conv" head fails to load).
``--as-is`` runs ``df_demo.py`` without them; ``--trace FILE`` writes the
per-frame decision trace of ``port_tools/decision_trace.py`` (the port's
side: ``demo.run(argv, on_system=...)`` with ``decision_trace.attach``, as
``chip_smoke.py`` phase 10a does); ``--ransac-seed N`` seeds the JAX
mapper's key chain with N in place of its own 42 (how far a run depends on
RANSAC's draws). Prints the demo's own output,
then one line of readings: frames processed, frames lost, the tracked
fraction, keyframes live and built, the ATE and the seconds.

Run from the repository root, e.g. phase 10a's reference:
  python port_tools/demo_data.py tum build/demo_tum
  JAX_PLATFORMS=cpu python port_tools/jax_demo_reference.py \\
      --flagfile data/flags/dataset_odom.flags \\
      --network_path data/nets/room256_32v4.json \\
      --network_weights data/nets/room256_32v4.pkl \\
      --source tum://build/demo_tum --log_dir build/jax_demo_tum
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "port_tools"))


class _Tee(io.StringIO):
    """Keeps what is printed, and passes it on unless quiet."""

    def __init__(self, stream):
        super().__init__()
        self._stream = stream

    def write(self, s):
        if self._stream is not None:
            self._stream.write(s)
        return super().write(s)

    def flush(self):
        if self._stream is not None:
            self._stream.flush()


def run(argv, repaired: bool = True, quiet: bool = False, trace=None,
        on_system=None):
    """``df_demo.main(argv)``, with the repairs unless ``repaired`` is
    False, a decision trace into ``trace`` if given, and ``on_system(df)``
    called with the system before the first frame. Returns (the JAX DeepFactors system, readings dict, the demo's
    printed output)."""
    import df_demo
    from deepfactors_tpu import config as cfgm
    from deepfactors_tpu.system import DeepFactors

    systems, closers = [], []
    init, pf, lnc = (DeepFactors.__init__, DeepFactors.process_frame,
                     cfgm.load_network_config)

    def record_init(self, *a, **kw):
        init(self, *a, **kw)
        systems.append(self)
        if trace is not None:
            import decision_trace
            closers.append(decision_trace.attach(self, trace))
        if on_system is not None:
            on_system(self)

    def process_once(self, ts, img):
        # the frame is already preprocessed by the demo's loop
        self.preprocess_image = lambda x: x
        try:
            return pf(self, ts, img)
        finally:
            del self.preprocess_image

    def network_config(path):
        with open(path) as f:
            j = json.load(f)
        c = lnc(path)
        return c._replace(base_ch=j.get("base_ch", c.base_ch),
                          pred_head=j.get("pred_head", c.pred_head))

    DeepFactors.__init__ = record_init
    if repaired:
        DeepFactors.process_frame = process_once
        cfgm.load_network_config = network_config
    out = _Tee(None if quiet else sys.stdout)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            df_demo.main(list(argv))
    finally:
        DeepFactors.__init__, DeepFactors.process_frame = init, pf
        cfgm.load_network_config = lnc
        for close in closers:
            close()
    seconds = time.perf_counter() - t0
    df = systems[-1]
    text = out.getvalue()
    ate = re.findall(r"ATE RMSE: ([0-9.eE+-]+|inf|nan) m", text)
    readings = dict(
        frames=df.n_frames, lost=df.n_lost_frames,
        tracked=1.0 - df.n_lost_frames / max(df.n_frames, 1),
        keyframes=len(df.mapper.kf_slots),
        keyframes_built=int(df.mapper._next_kid),
        ate=float(ate[-1]) if ate else None, seconds=round(seconds, 1))
    return df, readings, text


def main(argv) -> int:
    repaired = "--as-is" not in argv
    argv = [a for a in argv if a != "--as-is"]
    opts = {}
    for opt in ("--trace", "--ransac-seed"):
        if opt in argv:
            i = argv.index(opt)
            opts[opt] = argv[i + 1]
            del argv[i:i + 2]
    on_system = None
    if "--ransac-seed" in opts:
        import jax

        seed = int(opts["--ransac-seed"])

        def on_system(df):
            df.mapper._rng_key = jax.random.PRNGKey(seed)
    _, readings, _ = run(argv, repaired=repaired, trace=opts.get("--trace"),
                         on_system=on_system)
    print(json.dumps({"jax_demo": readings, "repaired": repaired,
                      "ransac_seed": opts.get("--ransac-seed"),
                      "argv": argv}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
