"""Operation and byte counts, from shapes: one file a learner's network
FLOPs (`flops_<algo>.py`), and the two physics kernels' (`kernels.py`)."""


def macs(sizes) -> int:
    """Multiply-adds of one row through a Linear tower of these sizes."""
    return sum(a * b for a, b in zip(sizes, sizes[1:]))
