"""Kernel B's share of its roofline: the least time of a launch at the
cell's env count (counts/kernels.py; operations counted with no touching
sphere, so where operations bound it the share is a lower bound) over its
measured device time a launch (`wtw_dynamics*` ops)."""
from port_bench.counts import kernels as K
from port_bench.readers import us_per_launch


def read(rec):
    us, n = us_per_launch(rec, lambda k: "wtw_dynamics" in k)
    if not us:
        return None
    cfg = rec["cell"]["cfg"]
    nb, nj, nv, P, anc = K.robot_dims(cfg["robot"])
    ceil = bool(cfg.get("ceiling", False))
    B = rec["dims"].N
    least = K.least_seconds(B * K.dynamics_bytes(nb, nj, nv, P, ceil),
                            B * K.dynamics_flops(nb, nj, nv, P, anc, ceil))
    return 100.0 * least / (us * 1e-6)
