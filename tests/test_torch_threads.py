"""One intra-op thread for the port's CPU tests.

The port's tests compute on small CPU tensors (a few populations of a few
dozen rows), where torch's default intra-op pool, one thread per core,
costs more than it gives: under ``pytest -n 6`` on an 8-core machine six
workers each spread every small op over eight threads. With one thread
each, all of ``tests/test_torch_*.py`` ran in 225 s instead of 391 s there
(``-n 6``), every test passing as before. The module registers itself as a
plugin (``pytest_plugins``), as ``test_torch_maps_guard`` does, so in every
process that collects it each test of a ``test_torch_*`` module, its
fixtures' setup and teardown included, runs with one intra-op thread; the
count is restored after it. Tests of the JAX package are left as they are.
"""
import contextlib

import pytest
import torch

pytest_plugins = ["test_torch_threads"]

PORT_TESTS = "test_torch_"


@contextlib.contextmanager
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    if item.path.name.startswith(PORT_TESTS):
        with one_intra_op_thread():
            yield
    else:
        yield


def test_port_tests_run_with_one_intra_op_thread():
    assert torch.get_num_threads() == 1


def test_the_thread_count_is_restored():
    with one_intra_op_thread():
        torch.set_num_threads(3)
        with one_intra_op_thread():
            assert torch.get_num_threads() == 1
        assert torch.get_num_threads() == 3
    assert torch.get_num_threads() == 1
