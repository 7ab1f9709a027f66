"""The hot paths, each a dispatcher (ops.py) over a plain PyTorch path
(ref.py) and, where the reference has a Pallas kernel, a hand-written CUDA
kernel (kernel.py wrapping ``repro_torch/csrc``): the GA's fitness,
variation, generation and ranking, and the LM-side ops (SSD state scan,
causal flash attention, pow2 linear). Backend names and their resolution
live in :mod:`.backend`, with the opt-in fallback chains and their probe
kernel (:mod:`.probe`); the CUDA build and launch counters in
:mod:`._cuda`.
"""
from .backend import (BackendPolicy, resolve_backends, apply_fallbacks,
                      backend_available, FALLBACK_CHAINS, BACKEND_CHOICES,
                      FITNESS_BACKENDS, VARIATION_BACKENDS,
                      GENERATION_BACKENDS, RANKING_BACKENDS)
from .pow2_matmul import pow2_linear, pow2_matmul, pow2_matmul_ref, pack_weights
from .flash_attention import causal_attention, flash_attention, flash_attention_ref
from .pop_mlp import population_correct, pop_mlp_correct, pop_mlp_correct_ref
from .pop_variation import population_variation, pop_variation_kernel, pop_variation_ref
from .pop_generation import population_generation, pop_generation_kernel, pop_generation_ref
from .pop_ranking import population_ranking, rank_select_rerank, sweep_rank
from .ssd_scan import state_scan, ssd_state_scan, ssd_state_scan_ref
