from .ops import population_variation, BACKENDS
from .kernel import pop_variation_kernel, pop_variation_plain
from .ref import pop_variation_ref
