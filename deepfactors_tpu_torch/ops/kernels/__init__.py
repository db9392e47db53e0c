"""The hand-written CUDA kernels and their plain PyTorch twins. Every
wrapper adds one to its module's ``LAUNCHES[name]`` where it launches its
kernel; ``launch_counts`` reads all of them at once."""


def _modules():
    from . import dense_warp, jacobian_stack, sfm_error, sfm_gram
    return sfm_gram, sfm_error, dense_warp, jacobian_stack


def launch_counts() -> dict:
    """Every kernel's launch count since the last reset, by kernel name."""
    return {k: v for m in _modules() for k, v in m.LAUNCHES.items()}


def reset_launch_counts() -> None:
    for m in _modules():
        m.reset_launch_counts()
