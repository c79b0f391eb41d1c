"""The optimizer recipe and the parameter tree of every other config of
configs/dota/, from the first, against the JAX package's
(tests/test_torch_configs.py's checks, split over two files to keep each
file's time short)."""

import pytest

from test_torch_configs import (CONFIGS, check_optimizer_recipe,  # noqa: F401
                                check_param_tree, one_thread, readings)

NAMES = CONFIGS[0::2]


@pytest.mark.parametrize("name", NAMES)
def test_optimizer_recipe(name, readings):  # noqa: F811
    check_optimizer_recipe(name, *readings[name])


@pytest.mark.parametrize("name", NAMES)
def test_param_tree(name, readings):  # noqa: F811
    check_param_tree(name, *readings[name])
