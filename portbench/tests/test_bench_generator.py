"""The frozen generator: the port's blends, the same pool for the same
seed byte for byte, flips that mirror the catalog."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import generator, spec

from .conftest import ROOT

TRAFFIC = {"sources": [[3, 10, 8]]}


@pytest.mark.parametrize("shape", [(5, 58, 48), (10, 58, 48)])
def test_frozen_copy_gives_the_ports_blend(shape):
    from scarlet_tpu_torch.testing import generate_blend

    for seed in (0, 3, 2_200_000_001):
        ours = generator.generate_blend(np.random.default_rng(seed), shape)
        port = generate_blend(np.random.default_rng(seed), shape)
        for key in ("images", "variance", "psfs"):
            assert np.array_equal(ours[key], port[key]), key
        assert np.array_equal(ours["centers"][:, 0], port["catalog"]["y"])
        assert np.array_equal(ours["centers"][:, 1], port["catalog"]["x"])


def test_same_seed_same_pool_byte_for_byte():
    a = generator.make_pool(4_000_000_007, (5, 58, 48), TRAFFIC)
    b = generator.make_pool(4_000_000_007, (5, 58, 48), TRAFFIC)
    c = generator.make_pool(4_000_000_008, (5, 58, 48), TRAFFIC)
    for key in a:
        assert a[key].tobytes() == b[key].tobytes(), key
    assert a["images"].tobytes() != c["images"].tobytes()


def test_pool_layout_and_source_counts():
    pool = generator.make_pool(11, (5, 58, 48), TRAFFIC)
    assert pool["images"].shape == (32, 5, 58, 48)
    assert pool["centers"].shape == (32, 10, 2)
    # each base blend once in each half, every count 3..10 once a flip
    assert sorted(pool["n_sources"][:8]) == list(range(3, 11))
    assert np.array_equal(pool["n_sources"][:8], pool["n_sources"][8:16])


def test_flips_mirror_the_scene_and_catalog():
    pool = generator.make_pool(12, (5, 58, 48), TRAFFIC)
    H, W = 58, 48
    for t, axes in enumerate(generator.FLIPS):
        j = 8 * t              # base blend 0 in flip t
        k = int(pool["n_sources"][j])
        c0, ct = pool["centers"][0, :k], pool["centers"][j, :k]
        cy = H - 1 - c0[:, 0] if -2 in axes else c0[:, 0]
        cx = W - 1 - c0[:, 1] if -1 in axes else c0[:, 1]
        assert np.array_equal(ct, np.stack([cy, cx], -1))
        if t:
            # a fresh noise draw, the same noiseless scene
            diff = np.flip(pool["images"][0], axes) - pool["images"][j]
            sigma = np.sqrt(pool["variance"][0][:, 0, 0])
            assert 0.5 < np.std(diff[0]) / (np.sqrt(2) * sigma[0]) < 1.5


def test_each_cell_pool_takes_its_config_shape():
    for name, bands in (("hsc_grizy.catalog_b512", 5),
                        ("rubin_euclid_10.catalog_b256", 10)):
        cell = spec.load_cell(name, root=ROOT)
        assert cell.scene == (bands, 58, 48)
        assert len(cell.config["channels"]) == bands
