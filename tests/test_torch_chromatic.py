"""Port vs reference: the chromatic transforms.

``ppt_torch.data.chromatic`` against ``ppt_tpu.data.chromatic``: each
transform, and the recipes' composition of them, on the same features with
``np.random.RandomState``s of one seed gives the same array bit for bit and
leaves the generators in the same state (the same draws in the same
order), at each transform's probability 0 and 1 and at its default.
"""

import numpy as np
import pytest
import torch

from ppt_torch.data import chromatic as tc

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores


def feats(n=500, seed=0):
    rng = np.random.RandomState(seed)
    rgb = rng.randint(0, 256, (n, 3)).astype(np.float32)
    rgb[:7] = [[0, 0, 0], [255, 255, 255], [10, 10, 10], [255, 0, 0], [0, 255, 0], [0, 0, 255],
               [200, 200, 50]]  # grey, and each channel the max
    return np.concatenate([rgb, rng.rand(n, 2).astype(np.float32)], axis=1)


CALLS = [
    ("chromatic_auto_contrast", {}), ("chromatic_auto_contrast", {"p": 1.0}),
    ("chromatic_auto_contrast", {"p": 1.0, "blend_factor": 0.3}),
    ("chromatic_translation", {}), ("chromatic_translation", {"p": 0.0}),
    ("chromatic_jitter", {}), ("chromatic_jitter", {"p": 1.0, "std": 0.05}),
    ("hue_saturation_translation", {}), ("random_drop_feature", {"p": 1.0}),
    ("random_drop_feature", {}),
]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("call", range(len(CALLS)))
def test_transform_matches_the_reference(call, seed):
    from ppt_tpu.data import chromatic as jc

    name, kw = CALLS[call]
    f = feats(seed=seed)
    r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
    want = getattr(jc, name)(f.copy(), r1, **kw)
    got = getattr(tc, name)(f.copy(), r2, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert r1.rand() == r2.rand()


def test_hsv_round_trip_and_normalize_match_the_reference():
    from ppt_tpu.data import chromatic as jc

    f = feats()
    np.testing.assert_array_equal(tc.rgb_to_hsv(f[:, :3]), jc.rgb_to_hsv(f[:, :3]))
    hsv = jc.rgb_to_hsv(f[:, :3])
    np.testing.assert_array_equal(tc.hsv_to_rgb(hsv), jc.hsv_to_rgb(hsv))
    for kw in ({}, {"color_mean": (0.5, 0.4, 0.3), "color_std": (0.2, 0.25, 0.3)}):
        np.testing.assert_array_equal(tc.chromatic_normalize(f, **kw),
                                      jc.chromatic_normalize(f, **kw))


def test_a_recipe_pipeline_matches_the_reference():
    """The S3DIS recipe's order: auto contrast, translation, jitter, hue and
    saturation, drop, normalize; one generator through all of them."""
    from ppt_tpu.data import chromatic as jc

    def pipeline(mod, f, rng):
        f = mod.chromatic_auto_contrast(f, rng, p=1.0)
        f = mod.chromatic_translation(f, rng, p=1.0)
        f = mod.chromatic_jitter(f, rng, p=1.0)
        f = mod.hue_saturation_translation(f, rng)
        f = mod.random_drop_feature(f, rng, p=0.5)
        return mod.chromatic_normalize(f, (0.5, 0.5, 0.5), (0.25, 0.25, 0.25))

    for seed in range(4):
        want = pipeline(jc, feats(seed=seed), np.random.RandomState(seed))
        got = pipeline(tc, feats(seed=seed), np.random.RandomState(seed))
        np.testing.assert_array_equal(got, want)
