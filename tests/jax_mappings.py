"""Keep a test process under Linux's limit on memory mappings.

XLA:CPU maps each compiled program's code into memory, several hundred
mappings a simulation program, and JAX keeps its programs cached.  A test
process that has compiled a few hundred programs reaches the kernel's limit
(``vm.max_map_count``, 65,530 by default), and its next compile crashes the
process, whichever test that compile belongs to.  Past half the limit,
:func:`release_if_high` drops JAX's cached programs and collects them, which
unmaps them; below it nothing is freed, so tests that share programs do not
compile again.

As a pytest plugin (``pytest_plugins = ["jax_mappings"]`` in
tests/test_torch_pbft.py, which every test process collects) it runs after
every test of the process, the JAX package's own tests included.
"""

from __future__ import annotations

import gc

import jax
import pytest

# half of Linux's default limit on a process's memory mappings
MAPPINGS_HIGH = 32_768


def mappings() -> int:
    """This process's memory mappings (0 where there is no procfs)."""
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


def release_if_high() -> None:
    """Drop JAX's cached programs once the process holds more than
    ``MAPPINGS_HIGH`` mappings."""
    if mappings() > MAPPINGS_HIGH:
        jax.clear_caches()
        gc.collect()


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    try:
        return (yield)
    finally:
        release_if_high()
