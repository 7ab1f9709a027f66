from .ops import population_generation, BACKENDS
from .kernel import pop_generation_kernel, pop_generation_plain
from .ref import pop_generation_ref
