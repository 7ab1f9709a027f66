from .ops import generation_lanes, population_generation, BACKENDS
from .kernel import pop_generation_kernel, pop_generation_plain
from .ref import pop_generation_ref
