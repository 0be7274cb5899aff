"""Shared test configuration.

Installs a minimal fallback for `hypothesis` when the real package is
missing, so tier-1 collection never dies on the import (the property
tests only use `given` / `settings` / `strategies.integers` /
`strategies.sampled_from`). The fallback draws a deterministic,
seeded sample of examples per test — strictly weaker than hypothesis
(no shrinking, no database), but it executes the same properties.
Install `requirements-dev.txt` to run the real thing.
"""
from __future__ import annotations

import sys
import types

try:
    import hypothesis  # noqa: F401  (real package wins when present)
except ImportError:
    import numpy as np

    _DEFAULT_MAX_EXAMPLES = 10

    class _Strategy:
        def __init__(self, draw):
            self._draw = draw

        def example_from(self, rng):
            return self._draw(rng)

    def integers(min_value, max_value):
        return _Strategy(
            lambda rng: int(rng.randint(min_value, max_value + 1)))

    def sampled_from(elements):
        elements = list(elements)
        return _Strategy(lambda rng: elements[rng.randint(len(elements))])

    def booleans():
        return _Strategy(lambda rng: bool(rng.randint(2)))

    def floats(min_value, max_value, **_):
        return _Strategy(
            lambda rng: float(rng.uniform(min_value, max_value)))

    def given(**strategies):
        def deco(fn):
            def wrapper(*args, **kwargs):
                n = getattr(wrapper, "_stub_max_examples",
                            _DEFAULT_MAX_EXAMPLES)
                rng = np.random.RandomState(0xC0FFEE)
                for _ in range(n):
                    drawn = {name: s.example_from(rng)
                             for name, s in strategies.items()}
                    fn(*args, **drawn, **kwargs)
            # Copy identity WITHOUT functools.wraps: __wrapped__ would
            # re-expose the strategy parameters to pytest's fixture
            # resolution, which then errors on "fixture not found".
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            wrapper._stub_given = True
            return wrapper
        return deco

    def settings(max_examples=_DEFAULT_MAX_EXAMPLES, **_):
        def deco(fn):
            fn._stub_max_examples = max_examples
            return fn
        return deco

    _strategies = types.ModuleType("hypothesis.strategies")
    _strategies.integers = integers
    _strategies.sampled_from = sampled_from
    _strategies.booleans = booleans
    _strategies.floats = floats

    _hypothesis = types.ModuleType("hypothesis")
    _hypothesis.given = given
    _hypothesis.settings = settings
    _hypothesis.strategies = _strategies
    _hypothesis.__is_repro_stub__ = True

    sys.modules["hypothesis"] = _hypothesis
    sys.modules["hypothesis.strategies"] = _strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")
