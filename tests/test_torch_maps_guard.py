"""A guard for the shared test run: it keeps every pytest process below the
kernel's limit on memory mappings (``vm.max_map_count``, 65530 by default).

Each executable that XLA:CPU compiles keeps its JIT code and data mapped
for as long as JAX's caches hold it, a few dozen mappings each. In a run
of the whole suite under ``pytest -n 6`` one xdist worker may run many
compile-heavy tests of the reference (its serve, chaos and checkpoint
tests took one worker to 61051 mappings in 59 tests); the next compile
then fails to map memory and the worker dies (a segfault inside XLA's
compiler, or a ``MemoryError``). After each test, wherever the process holds more than
half the limit, the guard clears JAX's compilation caches, which releases
those mappings (14767 → 692 after ``tests/test_suite.py``); later tests
recompile what they need. The module registers itself as a plugin
(``pytest_plugins``), so the guard runs in every process that collects it,
as every worker of the whole run does.
"""
import gc

import pytest

pytest_plugins = ["test_torch_maps_guard"]


def _max_map_count() -> int:
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return 0          # not Linux: no limit known, no guard


def n_maps() -> int:
    """The memory mappings this process holds now."""
    with open("/proc/self/maps", "rb") as f:
        return f.read().count(b"\n")


LIMIT = _max_map_count() // 2


def release_if_near_the_limit(limit: int) -> bool:
    """Clear JAX's caches when the process holds more than ``limit``
    mappings; whether it did."""
    if not limit or n_maps() <= limit:
        return False
    import jax

    jax.clear_caches()
    gc.collect()
    return True


@pytest.hookimpl(trylast=True)
def pytest_runtest_teardown(item, nextitem):
    release_if_near_the_limit(LIMIT)


def test_guard_releases_the_mappings_of_compiled_executables():
    import jax
    import jax.numpy as jnp

    if not LIMIT:
        pytest.skip("no /proc/sys/vm/max_map_count on this system")
    for n in range(1, 40):                 # forty small executables
        jax.jit(lambda x, n=n: x * n + 1)(jnp.ones(n)).block_until_ready()
    before = n_maps()
    assert not release_if_near_the_limit(before + 1)
    assert release_if_near_the_limit(before - 1)
    assert n_maps() < before
