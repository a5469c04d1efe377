"""Device ms a traced iteration of the kernels launched inside the port's
`env.step` profiler ranges (the env step: torques, the physics entry and
kernels, rewards, resets, observations), as `physics.corner_gather_ms`
reads its range."""
from port_bench.readers import device_traced

RANGE = "env.step"


def read(rec):
    if not device_traced(rec):
        return None
    us, calls = rec["summary"]["ranges"].get(RANGE, (0.0, 0))
    if not calls or us <= 0:
        return None
    return us / 1e3 / rec["summary"]["iterations"]
