from .state import PhysicsState, ContactInfo  # noqa: F401
from .heightfield import HeightField, flat_heightfield, make_heightfield  # noqa: F401
from .engine import EngineParams  # noqa: F401
from .batched import physics_step_batched  # noqa: F401
