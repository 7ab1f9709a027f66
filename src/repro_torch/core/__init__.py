"""The paper's training run, ported: discrete genetic-based hardware-aware
training for printed MLPs (pow2 weights, bit-mask pruning, FA-count area,
NSGA-II).
"""
from .genome import MLPTopology, GenomeSpec, GeneTable, max_topology
from .engine import GAConfig, GAState, Problem, pad_problem
from .trainer import GATrainer
from .sweep import SweepResult, SuiteResult, run_grid, grid_cells, run_suite
from .area import mlp_fa_count, population_area
from .mlp import mlp_forward, population_accuracy
from .quantize import quantize_inputs, qrelu
from .pareto import pareto_front, hypervolume_2d, best_within_loss
from .interop import genome_table_from_numpy, state_from_numpy, state_to_numpy
