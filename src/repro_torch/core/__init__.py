"""The paper's training run, ported: discrete genetic-based hardware-aware
training for printed MLPs (pow2 weights, bit-mask pruning, FA-count area,
NSGA-II), with its baselines (float MLP, exact bespoke baseline, calibrated
doping, post-training approximation) and Verilog emission.
"""
from .genome import MLPTopology, GenomeSpec, GeneTable, max_topology
from .engine import GAConfig, GAState, Problem, pad_problem
from .trainer import GATrainer
from .sweep import SweepResult, SuiteResult, run_grid, grid_cells, run_suite
from .islands import IslandConfig, build_island_step, run_islands
from .area import (mlp_fa_count, population_area, baseline_mlp_fa,
                   HardwareCost, EGFET_FA_AREA_CM2, EGFET_FA_POWER_MW)
from .mlp import mlp_forward, mlp_predict, accuracy, population_accuracy
from .quantize import quantize_inputs, qrelu
from .pareto import pareto_front, hypervolume_2d, best_within_loss
from .baselines import (train_float_mlp, exact_bespoke_baseline, calibrated_seeds,
                        post_training_approx, FloatMLP, FloatNet, BespokeBaseline)
from .hdl import emit_verilog, evaluate_genome_python
from .interop import (genome_table_from_numpy, state_from_numpy, state_to_numpy,
                      float_mlp_from_numpy, float_net_from_numpy, float_mlp_to_numpy)
