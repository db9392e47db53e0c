"""The device memory's peak over the window, in GiB
(``max_memory_allocated`` after ``reset_peak_memory_stats`` at its start)."""


def read(ctx):
    if not ctx.units.get("steps") or ctx.peak_bytes is None:
        return None
    return ctx.peak_bytes / 2 ** 30
