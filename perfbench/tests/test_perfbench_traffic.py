"""Every input a run makes comes from its seed and from nothing else."""

import numpy as np
import pytest
import torch

from perfbench import inputs

CPU = torch.device("cpu")
SEEDS = [0, 2**31 + 17, 2**40 + 3]
SPEC = {"dtype": "uint16", "range": [1, 10000], "cells": [8, 32], "noise": 150.0}


@pytest.mark.parametrize("seed", SEEDS)
def test_images_are_the_seeds(seed):
    a = inputs.host_images(inputs.generator(seed, "scenes", CPU), 2, 40, 3, SPEC, CPU)
    b = inputs.host_images(inputs.generator(seed, "scenes", CPU), 2, 40, 3, SPEC, CPU)
    c = inputs.host_images(inputs.generator(seed + 1, "scenes", CPU), 2, 40, 3, SPEC, CPU)
    assert a.dtype == np.uint16 and np.array_equal(a, b) and not np.array_equal(a, c)
    assert 1 <= a.min() and a.max() <= 10000


@pytest.mark.parametrize("seed", SEEDS)
def test_chip_pool_is_the_seeds(seed):
    spec = {"bands": {"range": [0, 255], "cells": [8, 32], "noise": 12.0},
            "labels": {"cells": [8], "threshold": 0.75}}

    def pool(s):
        return inputs.chip_pool(inputs.generator(s, "pool", CPU), 6, 32, ["R", "G"], "y", spec, CPU)

    a, b, c = pool(seed), pool(seed), pool(seed + 1)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["R"], c["R"])
    assert set(np.unique(a["y"])) <= {0.0, 1.0}


def test_weights_are_the_seeds():
    specs = [("c.weight", (4, 3, 3, 3), "weight", 27), ("c.bias", (4,), "bias", 0),
             ("n.weight", (4,), "bn_weight_residual", 0), ("n.running_var", (4,), "bn_var", 0)]
    a = inputs.draw_weights(specs, inputs.generator(5, "weights", CPU), CPU)
    b = inputs.draw_weights(specs, inputs.generator(5, "weights", CPU), CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["n.running_var"], torch.ones(4))
    assert (a["n.weight"] - inputs.RESIDUAL_GAIN).abs().max() < inputs.RESIDUAL_GAIN


def test_subseeds_differ_by_tag_and_fit_a_generator():
    s = {inputs.subseed(2**31 + 1, tag) for tag in ("weights", "scenes", "pool", "check")}
    assert len(s) == 4 and all(0 <= x < 2**63 for x in s)
