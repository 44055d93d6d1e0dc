"""Port vs reference: the few-shot linear probe.

``ppt_torch.tasks.linear_probe`` against ``ppt_tpu.tasks.linear_probe``
(optax's L-BFGS) and scikit-learn on seeded gaussian blobs (4 classes, 16
wide, the train and test draws around the same centres):

- five steps of ``_fit_logreg`` against ``torch.optim.LBFGS``, whose
  algorithm it runs with the host reads taken out;
- the fitted ``W`` against sklearn's ``coef_.T`` at a C where both converge
  (C = 0.1), and ``b`` after centring (a common shift of ``b`` leaves the
  softmax unchanged), within ``FIT_TOL`` of the largest coefficient;
- the test accuracy against ``_accuracy_jax`` at every C of the 7-decade
  grid, within one test sample (the two L-BFGS take other paths to the
  same minimum);
- at C = 1e2 on separable one-shot data neither fit converges in 100
  steps, so there the predictions alone are compared;
- the shot subsets index for index, ``probe_once`` and ``run_probe``
  within one test sample a fit, ``main`` from argv on the CPU, and its
  results file byte for byte in the reference's format.
"""

import os

import numpy as np
import pytest
import torch

from ppt_torch.tasks import linear_probe as tlp

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

K, D = 4, 16
GRID = [10.0**k for k in range(-4, 3)]
FIT_TOL = 2e-3  # of the largest coefficient: sklearn's own fit is good to ~1e-4


def blobs(n_per, seed, spread=1.0, k=K):
    centers = np.random.RandomState(0).randn(k, D) * spread
    rng = np.random.RandomState(seed)
    X = np.concatenate([centers[c] + rng.randn(n_per, D) for c in range(k)])
    y = np.repeat(np.arange(k), n_per)
    perm = rng.permutation(len(y))
    return X[perm].astype(np.float32), y[perm]


def torch_args(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_fit_matches_sklearn_where_both_converge():
    from sklearn.linear_model import LogisticRegression

    X, y = blobs(30, 1)
    C = 0.1
    W, b = tlp._fit_logreg(*torch_args(X, y), C, K)
    clf = LogisticRegression(C=C, max_iter=10000, tol=1e-12).fit(X, y)
    scale = np.abs(clf.coef_).max()
    np.testing.assert_allclose(W.numpy(), clf.coef_.T, rtol=0, atol=FIT_TOL * scale)
    np.testing.assert_allclose(b.numpy() - b.numpy().mean(),
                               clf.intercept_ - clf.intercept_.mean(), rtol=0,
                               atol=FIT_TOL * scale)
    assert W.dtype == torch.float32 and W.shape == (D, K) and b.shape == (K,)


@pytest.mark.parametrize("C", [1e-3, 1e-1, 1e1, 1e2])
def test_fit_follows_torch_lbfgs_step_for_step(C):
    """Five steps of ``_fit_logreg`` against ``torch.optim.LBFGS`` (strong
    Wolfe, memory 10) driven by the same closed-form value and gradient of
    the objective on one flat parameter: the same iterates but for f32
    rounding, within 1e-4 of the largest weight (the two differ by 1e-6 to
    9e-6 after five steps; over a hundred they drift apart by rounding
    alone, as two runs of any L-BFGS in f32 do)."""
    import torch.nn.functional as F

    X, y = torch_args(*blobs(30, 1, spread=0.5))
    Xb = torch.cat([X, torch.ones(len(X), 1)], 1)
    onehot = F.one_hot(y.long(), K).float()
    penalty = torch.full((D + 1, 1), 1.0 / C)
    penalty[-1] = 0.0
    theta = torch.zeros(D + 1, K)
    opt = torch.optim.LBFGS([theta], lr=1.0, max_iter=5, max_eval=100, history_size=10,
                            line_search_fn="strong_wolfe")

    def objective():
        z = Xb @ theta
        lse = torch.logsumexp(z, 1, keepdim=True)
        theta.grad = Xb.t() @ (torch.exp(z - lse) - onehot) + penalty * theta
        return lse.sum() - (z * onehot).sum() + 0.5 * (penalty * theta * theta).sum()

    with torch.no_grad():
        opt.step(objective)
    got_w, got_b = tlp._fit_logreg(X, y, C, K, steps=5)
    scale = float(theta[:-1].abs().max())
    torch.testing.assert_close(got_w, theta[:-1], rtol=0, atol=1e-4 * scale)
    torch.testing.assert_close(got_b, theta[-1], rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("C", GRID)
def test_accuracy_follows_the_reference_across_the_grid(C):
    """Overlapping blobs (about 80% separable): the port's accuracy and
    ``_accuracy_jax``'s within one of the 100 test samples."""
    from ppt_tpu.tasks.linear_probe import _accuracy_jax

    tr, te = blobs(30, 1, spread=0.5), blobs(25, 2, spread=0.5)
    got = tlp._accuracy_torch(*torch_args(*tr, *te), C, K)
    want = _accuracy_jax(*tr, *te, C, K)
    assert abs(got - want) <= 1.0 / len(te[1]) + 1e-6, (got, want)


def test_one_shot_separable_at_the_largest_c_compares_predictions():
    """One shot a class, far-apart centres, C = 1e2: the minimum lies far
    out and neither L-BFGS reaches it in 100 steps, so the weights are not
    compared; the test predictions are identical."""
    from ppt_tpu.tasks.linear_probe import _fit_logreg as jax_fit
    import jax.numpy as jnp

    (X, y), (Xte, _) = blobs(1, 1, spread=3.0), blobs(25, 2, spread=3.0)
    W, b = tlp._fit_logreg(*torch_args(X, y), 1e2, K)
    Wj, bj = jax_fit(jnp.asarray(X), jnp.asarray(y), jnp.asarray(1e2, jnp.float32), K)
    got = (torch.from_numpy(Xte) @ W + b).argmax(-1).numpy()
    want = np.argmax(Xte @ np.asarray(Wj) + np.asarray(bj), -1)
    np.testing.assert_array_equal(got, want)


def _write(tmp_path, n_per=40, spread=1.0):
    (Xtr, ytr), (Xte, yte) = blobs(n_per, 1, spread), blobs(20, 2, spread)
    np.savez(tmp_path / "train.npz", feature_list=Xtr, label_list=ytr)
    np.savez(tmp_path / "test.npz", feature_list=Xte, label_list=yte)
    return str(tmp_path / "train.npz"), str(tmp_path / "test.npz"), len(yte)


def test_shot_subsets_are_the_references(tmp_path, monkeypatch):
    """The rows each ``probe_once`` call gets, for every shot and run, are
    the reference's, in order (a class short of rows gives all it has)."""
    from ppt_tpu.tasks import linear_probe as jlp

    (Xtr, ytr), (Xte, yte) = blobs(6, 1), blobs(2, 2)
    ytr = ytr.copy()
    ytr[np.flatnonzero(ytr == 2)[:4]] = 3  # class 2 has 2 rows, class 3 has 10
    np.savez(tmp_path / "train.npz", feature_list=Xtr, label_list=ytr)
    np.savez(tmp_path / "test.npz", feature_list=Xte, label_list=yte)
    seen = {"port": [], "ref": []}

    def recorder(who):
        def probe(Xtr, ytr, *a, **kw):
            seen[who].append((np.asarray(Xtr).copy(), np.asarray(ytr).copy()))
            return 0.5, 1.0
        return probe

    monkeypatch.setattr(tlp, "probe_once", recorder("port"))
    monkeypatch.setattr(jlp, "probe_once", recorder("ref"))
    files = (str(tmp_path / "train.npz"), str(tmp_path / "test.npz"))
    tlp.run_probe(*files, num_run=3, shots=tlp.SHOTS, device="cpu")
    jlp.run_probe(*files, num_run=3, shots=jlp.SHOTS)
    assert len(seen["port"]) == len(seen["ref"]) == 3 * len(tlp.SHOTS)
    for (gx, gy), (wx, wy) in zip(seen["port"], seen["ref"]):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    idx = tlp.shot_indices(ytr, 4, 2, K)
    np.testing.assert_array_equal(Xtr[idx], seen["ref"][2 * 3 + 2][0])


def test_probe_once_follows_the_reference():
    from ppt_tpu.tasks.linear_probe import probe_once

    tr, te = blobs(4, 1, spread=0.6), blobs(25, 2, spread=0.6)
    got, c = tlp.probe_once(*torch_args(*tr, *te), K, num_step=2)
    want, _ = probe_once(*tr, *te, K, num_step=2)
    assert abs(got - want) <= 1.0 / len(te[1]) + 1e-6 and 1e-4 <= c <= 1e2
    # the sklearn backend is the reference's, call for call
    assert tlp.probe_once(*tr, *te, K, num_step=2, backend="sklearn") == probe_once(
        *tr, *te, K, num_step=2, backend="sklearn")


def test_run_probe_follows_the_reference(tmp_path):
    from ppt_tpu.tasks.linear_probe import run_probe

    *files, n_test = _write(tmp_path)
    got = tlp.run_probe(*files, num_run=2, num_step=2, shots=(1, 4), device="cpu")
    want = run_probe(*files, num_run=2, num_step=2, shots=(1, 4))
    assert list(got) == [1, 4]
    for shot in got:
        # each fit within one test sample, so the mean too
        assert abs(got[shot][0] - want[shot][0]) <= 100.0 / n_test + 1e-6, (shot, got, want)
        assert 0.0 <= got[shot][1] <= 100.0


def test_main_from_argv_and_the_reference_file_format(tmp_path, monkeypatch):
    from ppt_tpu.tasks import linear_probe as jlp
    from ppt_tpu.tasks.args import TaskArgs as JaxArgs

    from ppt_torch.tasks.args import parse_args

    feats = tmp_path / "lp_feats"
    feats.mkdir()
    _write(feats)
    argv = ["--output_dir", str(tmp_path), "--num_run", "1", "--num_step", "1", "--device",
            "cpu"]
    results = tlp.main(argv)
    lines = (feats / "linear_probe_results.txt").read_text().splitlines()
    assert [ln.split("-shot:")[0] for ln in lines] == [str(s) for s in tlp.SHOTS]
    assert lines == [f"{s}-shot: {m:.2f} +- {d:.2f}" for s, (m, d) in results.items()]

    # the same numbers through both mains give the same bytes
    fixed = {s: (100.0 / 3 * (i % 3), 1.0 / 7 * i) for i, s in enumerate(tlp.SHOTS)}
    monkeypatch.setattr(tlp, "run_probe", lambda *a, **kw: fixed)
    monkeypatch.setattr(jlp, "run_probe", lambda *a, **kw: fixed)
    tlp.main(parse_args(argv + ["--exp_name", "lp_feats"]))
    got = (feats / "linear_probe_results.txt").read_bytes()
    jlp.main(JaxArgs(output_dir=str(tmp_path), num_run=1, num_step=1))
    assert got == (feats / "linear_probe_results.txt").read_bytes()
    assert os.path.getsize(feats / "linear_probe_results.txt") > 0
