"""Device ms a traced iteration of the matrix-product kernels (the port's
trace grouping)."""
from port_bench.readers import group, per_iteration_ms


def read(rec):
    return per_iteration_ms(rec, lambda k: group(k) == "matrix products")
