"""GA-based hardware-approximation-aware training (paper §IV, Fig. 2),
PyTorch port of ``repro.core.trainer``.

``GATrainer`` is a thin stateful adapter over the engine: init, then the
generation loop, with the fitness, variation and generation hot paths on
the hand-written CUDA kernels when the trainer runs on a card (the
default) and on their plain PyTorch paths when asked for the CPU. After a
scanned run (``scan=True``), ``unique_evals`` counts the rows actually
evaluated and ``cache_hits`` the evaluations the cross-generation cache
saved; after ``scan=False`` both are None, as in the reference.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from . import engine, prng
from .engine import GAConfig, GAState, Problem
from .genome import MLPTopology


class GATrainer:
    """Hardware-aware NSGA-II trainer for one (topology, dataset) pair."""

    def __init__(self, topo: MLPTopology, x01, labels,
                 cfg: GAConfig | None = None,
                 baseline_acc: float | None = None,
                 doping_seeds: Optional[Sequence[np.ndarray]] = None,
                 device="cuda"):
        cfg = cfg if cfg is not None else GAConfig()
        self.topo = topo
        self.cfg = cfg
        # chance-level baseline if no float model is supplied
        self.baseline_acc = float(baseline_acc) if baseline_acc is not None else 1.0
        self.problem = Problem.from_data(topo, x01, labels, cfg,
                                         baseline_acc=self.baseline_acc,
                                         device=device)
        self.device = self.problem.device
        self.spec = self.problem.spec
        self.x_int = self.problem.x_int
        self.labels = self.problem.labels
        self.doping_seeds = doping_seeds

    def init_state(self) -> GAState:
        state, n_eval = engine.init_state(
            self.problem, prng.PRNGKey(self.cfg.seed, self.device),
            engine._doping_array(self.doping_seeds, self.device))
        self._init_n_eval = n_eval
        return state

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, generations: int | None = None, verbose: bool = False,
            scan: bool | None = None):
        """Train for ``generations``; returns (final state, history).

        ``scan`` (default ``cfg.scan``) keeps each generation's aux on the
        device and reads it once at the end (``unique_evals``/``cache_hits``
        and an apportioned ``time_s``); ``scan=False`` steps generation by
        generation and records measured timestamps. Same states either way.
        """
        gens = generations if generations is not None else self.cfg.generations
        scan = self.cfg.scan if scan is None else scan
        state = self.init_state()
        history = []
        t0 = time.time()
        if scan and gens > 0:
            state, (best_err, best_area, n_eval, n_hit) = engine.run_scanned(
                self.problem, state, gens)
            self._sync()
            elapsed = time.time() - t0
            self.unique_evals = int(n_eval.sum()) + int(self._init_n_eval)
            self.cache_hits = int(n_hit.sum())
            if verbose:
                err, area = best_err.cpu().numpy(), best_area.cpu().numpy()
                for g in range(gens):
                    if g % self.cfg.log_every == 0 or g == gens - 1:
                        history.append({
                            "gen": g,
                            "best_err": float(err[g]),
                            "best_area": float(area[g]),
                            # apportioned, not measured — see docstring
                            "time_s": elapsed * (g + 1) / gens,
                        })
        else:
            self.unique_evals = None
            self.cache_hits = None
            for g in range(gens):
                state, _ = engine.generation(self.problem, state)
                if verbose and (g % self.cfg.log_every == 0 or g == gens - 1):
                    history.append({
                        "gen": g,
                        "best_err": float(state.obj[:, 0].min()),
                        "best_area": float(state.obj[:, 1].min()),
                        "time_s": time.time() - t0,
                    })
        self._sync()
        self.evaluations = (gens + 1) * self.cfg.pop_size * int(self.labels.shape[0])
        return state, history

    def front(self, state: GAState):
        """Feasible estimated Pareto front (paper Fig. 2 output)."""
        return engine.front_of(state)
