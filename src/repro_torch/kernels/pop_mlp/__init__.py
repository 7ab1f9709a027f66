from .ops import population_correct, BACKENDS
from .kernel import (pop_mlp_correct, pop_mlp_correct_mc, pop_mlp_correct_mc_plain,
                     pop_mlp_correct_plain)
from .ref import pop_mlp_correct_ref, pop_mlp_correct_tiled
