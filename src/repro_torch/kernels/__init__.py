"""The GA's hot paths, each a dispatcher (ops.py) over a plain PyTorch path
(ref.py) and, where the reference has a Pallas kernel, a hand-written CUDA
kernel (kernel.py wrapping ``repro_torch/csrc``). Backend names and their
resolution live in :mod:`.backend`; the CUDA build and launch counters in
:mod:`._cuda`.
"""
from .backend import (BackendPolicy, resolve_backends, BACKEND_CHOICES,
                      FITNESS_BACKENDS, VARIATION_BACKENDS,
                      GENERATION_BACKENDS, RANKING_BACKENDS)
from .pop_mlp import population_correct, pop_mlp_correct, pop_mlp_correct_ref
from .pop_variation import population_variation, pop_variation_kernel, pop_variation_ref
from .pop_generation import population_generation, pop_generation_kernel, pop_generation_ref
from .pop_ranking import population_ranking, rank_select_rerank, sweep_rank
