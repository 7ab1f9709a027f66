from .ops import population_ranking, rank_select_rerank, fold_objectives, BACKENDS
from .sweep import sweep_rank, sweep_ranking
