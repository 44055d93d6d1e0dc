"""Port vs reference: label-smoothed cross entropy.

f32 on both sides, same expression: rel 1e-6. Also against torch's own
``F.cross_entropy(label_smoothing=...)``, which the reference says it
matches, and its gradient against ``jax.grad`` (1e-6 abs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ppt_tpu.models.losses import smoothed_cross_entropy as jax_ce
from ppt_torch.models.losses import smoothed_cross_entropy

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores


@pytest.mark.parametrize("smoothing", [0.0, 0.2, 0.3])
def test_smoothed_cross_entropy_matches_jax(smoothing):
    rng = np.random.RandomState(int(smoothing * 10))
    logits = (rng.randn(6, 40) * 5).astype(np.float32)
    labels = rng.randint(0, 40, 6).astype(np.int32)
    want = float(jax_ce(jnp.asarray(logits), jnp.asarray(labels), smoothing))
    t = torch.from_numpy(logits).requires_grad_(True)
    got = smoothed_cross_entropy(t, torch.from_numpy(labels), smoothing)
    assert got.dtype == torch.float32
    assert abs(got.item() - want) <= 1e-6 * abs(want)
    lib = F.cross_entropy(t, torch.from_numpy(labels).long(), label_smoothing=smoothing)
    assert abs(got.item() - lib.item()) <= 1e-6 * abs(want)
    got.backward()
    jgrad = jax.grad(lambda l: jax_ce(l, jnp.asarray(labels), smoothing))(jnp.asarray(logits))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), atol=1e-6)


def test_smoothed_cross_entropy_computes_in_f32_from_bf16_logits():
    rng = np.random.RandomState(3)
    logits = torch.from_numpy((rng.randn(4, 10) * 3).astype(np.float32)).bfloat16()
    labels = torch.from_numpy(rng.randint(0, 10, 4))
    got = smoothed_cross_entropy(logits, labels, 0.2)
    want = smoothed_cross_entropy(logits.float(), labels, 0.2)
    assert got.dtype == torch.float32 and float(got) == float(want)
