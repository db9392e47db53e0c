"""The tools of the PyTorch/CUDA port: the counterparts of the JAX
package's ``tools/`` scripts, each run as
``python -m deepfactors_tpu_torch.tools.<name>`` with ``--device`` (default
``cuda``; a card run that finds no CUDA device stops, ``--device cpu`` runs
on the CPU).

Viewers: ``replay_viewer`` (a run directory as one self-contained HTML
page), ``result_viewer`` (depth colormaps, ``map.ply``, the trajectory
plot), ``live_viewer`` (``LiveViewer``, the replay page kept up to date
during a run).

Tools: ``decode_image``, ``test_matching``, ``voc_builder``, ``voc_test``,
``kernel_benchmark``, ``profile_ba``, ``profile_dispatch``,
``profile_event``, ``schur_crossover``; ``bench_config`` holds the bench's
configuration, ``common`` the device check and the stage timer.
"""
