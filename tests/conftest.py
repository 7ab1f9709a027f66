"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests must see the real
single CPU device; only launch/dryrun.py and the subprocess tests in
test_distributed.py use placeholder devices.
"""
import numpy as np
import pytest
import jax


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture(scope="session")
def bc_dataset():
    from repro.data import load_dataset

    return load_dataset("breast_cancer")


@pytest.fixture(scope="session")
def bc_spec(bc_dataset):
    from repro.core.genome import MLPTopology, GenomeSpec

    topo = MLPTopology(bc_dataset.topology)
    return GenomeSpec(topo)


@pytest.fixture(scope="session")
def bc_float(bc_dataset):
    from repro.core.genome import MLPTopology
    from repro.core.baselines import train_float_mlp

    ds = bc_dataset
    return train_float_mlp(MLPTopology(ds.topology), ds.x_train, ds.y_train,
                           ds.x_test, ds.y_test, steps=600)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")
