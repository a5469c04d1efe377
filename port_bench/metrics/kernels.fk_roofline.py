"""Kernel A's share of its roofline: the least time of a launch at the
cell's env count (bytes over HBM bandwidth or fp32 operations over the
fp32 peak, the larger; counts/kernels.py) over its measured device time a
launch (`wtw_fk*` ops)."""
from port_bench.counts import kernels as K
from port_bench.readers import us_per_launch


def read(rec):
    us, n = us_per_launch(rec, lambda k: "wtw_fk" in k)
    if not us:
        return None
    nb, nj, nv, P, _ = K.robot_dims(rec["cell"]["cfg"]["robot"])
    B = rec["dims"].N
    least = K.least_seconds(B * K.fk_bytes(nb, nj, P),
                            B * K.fk_flops(nb, nj, P))
    return 100.0 * least / (us * 1e-6)
