"""Linear probe: few-shot logistic regression over frozen features.

Counterpart of ``ppt_tpu/tasks/linear_probe.py``: reads the ``.npz`` files
that ``tasks/feature_extract.py`` writes, then for each shot count in
``SHOTS`` and each of ``num_run`` seeds draws the per-class subsets (the
reference's draws, index for index), searches the inverse regularisation C
over a 7-decade grid, refines it with ``num_step`` ternary steps on
log10(C), and reports the test accuracy's mean and std per shot count.

The classifier is a full-batch L2-regularised multinomial logistic
regression (sum of the cross entropy plus ``|W|^2 / (2C)``, the bias
unpenalised: sklearn's objective) fitted with ``torch.optim.LBFGS``'s
algorithm and strong-Wolfe line search on the features' device; the
reference fits the same objective with optax's L-BFGS for 100 steps.
``backend="sklearn"`` fits with scikit-learn instead, as the oracle
(imported when called).

    python -m ppt_torch.tasks.linear_probe [--output_dir outputs] [--exp_name lp_feats] \
        [--num_run 10] [--num_step 8] [--device cpu]
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.optim.lbfgs import _strong_wolfe  # the line search torch.optim.LBFGS runs

from ppt_torch.tasks.args import TaskArgs, parse_args
from ppt_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

SHOTS = (1, 2, 4, 8, 16)
HISTORY = 10  # L-BFGS memory, optax's default
EVALS_PER_STEP = 20  # objective evaluations a step may spend in the line search
TOL_GRAD, TOL_CHANGE = 1e-7, 1e-9  # torch.optim.LBFGS's stopping tolerances


def _fit_logreg(X: torch.Tensor, y: torch.Tensor, C: float, num_classes: int,
                steps: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W [d, K], b [K]) minimising the sum of the cross entropy plus
    ``|W|^2 / (2C)`` over ``X`` [n, d] f32 and ``y`` [n], on ``X.device``,
    from zeros, for at most ``steps`` L-BFGS steps.

    ``torch.optim.LBFGS``'s algorithm, step for step: its first step size,
    its strong-Wolfe line search (``_strong_wolfe``, called as it calls it),
    its memory update and stopping rules. Two things differ, both for the
    card, where every step waits on the host: the two-loop recursion keeps
    its coefficients on the device (``LBFGS`` reads each one to the host, 20
    reads a step), and the objective's gradient is written in closed form
    (no autograd graph)."""
    n, d = X.shape
    Xb = torch.cat([X, X.new_ones(n, 1)], 1)  # b as a last weight row, unpenalised
    onehot = F.one_hot(y.long(), num_classes).to(X.dtype)
    penalty = torch.full((d + 1, 1), 1.0 / C, device=X.device, dtype=X.dtype)
    penalty[-1] = 0.0

    def value_grad(theta):
        th = theta.view(d + 1, num_classes)
        z = Xb @ th
        lse = torch.logsumexp(z, 1, keepdim=True)
        shrink = penalty * th
        grad = Xb.t() @ (torch.exp(z - lse) - onehot) + shrink
        value = lse.sum() - (z * onehot).sum() + 0.5 * (shrink * th).sum()
        return float(value), grad.reshape(-1)

    theta = torch.zeros((d + 1) * num_classes, device=X.device, dtype=X.dtype)
    f, g = value_grad(theta)
    evals, max_evals = 1, EVALS_PER_STEP * steps
    memory, h_diag = [], 1.0  # (y, s, 1 / y.s) of the last HISTORY steps
    if g.abs().max() > TOL_GRAD:
        for it in range(steps):
            if it == 0:
                direction = -g
                t = min(1.0, 1.0 / float(g.abs().sum()))
            else:
                yv, s = g - g_prev, direction * t
                ys = yv.dot(s)
                if ys > 1e-10:
                    memory = memory[1 - HISTORY:] + [(yv, s, 1.0 / ys)]
                    h_diag = ys / yv.dot(yv)
                q, alphas = -g, []
                for yv, s, rho in reversed(memory):
                    alphas.append(s.dot(q) * rho)
                    q = q - alphas[-1] * yv
                direction = q * h_diag
                for (yv, s, rho), alpha in zip(memory, reversed(alphas)):
                    direction = direction + (alpha - yv.dot(direction) * rho) * s
                t = 1.0
            gtd = g.dot(direction)
            if gtd > -TOL_CHANGE:
                break
            g_prev, f_prev = g, f
            f, g, t, ls_evals = _strong_wolfe(lambda x, t, dx: value_grad(x + t * dx), theta, t,
                                              direction, f, g, gtd, max_ls=max_evals - evals)
            theta = theta + t * direction
            evals += ls_evals
            if (evals >= max_evals or g.abs().max() <= TOL_GRAD
                    or (direction * t).abs().max() <= TOL_CHANGE or abs(f - f_prev) < TOL_CHANGE):
                break
    th = theta.view(d + 1, num_classes)
    return th[:-1], th[-1]


def _accuracy_torch(Xtr, ytr, Xte, yte, C: float, num_classes: int, steps: int = 100) -> float:
    """Test accuracy of the classifier fitted at ``C``; tensors on one device."""
    W, b = _fit_logreg(Xtr, ytr, C, num_classes, steps)
    pred = (Xte @ W + b).argmax(-1)
    return int((pred == yte).sum()) / yte.numel()


def _accuracy_sklearn(Xtr, ytr, Xte, yte, C: float, num_classes: int, **_) -> float:
    """The oracle: scikit-learn's ``LogisticRegression`` at ``C`` (numpy in)."""
    from sklearn.linear_model import LogisticRegression

    clf = LogisticRegression(C=C, max_iter=1000)
    clf.fit(Xtr, ytr)
    return float(clf.score(Xte, yte))


def probe_once(Xtr, ytr, Xte, yte, num_classes: int, num_step: int = 8,
               backend: str = "torch") -> Tuple[float, float]:
    """The 7-decade grid of C (1e-4 .. 1e2), then ``num_step`` ternary
    steps on log10(C) inside the bracket around the grid's peak, the lower
    third kept on a tie (``ppt_tpu/tasks/linear_probe.py:92-121``).
    Returns (best accuracy, its C)."""
    acc_fn = _accuracy_torch if backend == "torch" else _accuracy_sklearn

    search_list = [10.0**k for k in range(-4, 3)]
    accs = [acc_fn(Xtr, ytr, Xte, yte, C, num_classes) for C in search_list]
    peak = int(np.argmax(accs))
    lo = np.log10(search_list[max(peak - 1, 0)])
    hi = np.log10(search_list[min(peak + 1, len(search_list) - 1)])
    best_acc, best_c = accs[peak], search_list[peak]
    for _ in range(num_step):
        mid_lo = lo + (hi - lo) / 3.0
        mid_hi = hi - (hi - lo) / 3.0
        a_lo = acc_fn(Xtr, ytr, Xte, yte, 10.0**mid_lo, num_classes)
        a_hi = acc_fn(Xtr, ytr, Xte, yte, 10.0**mid_hi, num_classes)
        if a_lo >= a_hi:
            hi = mid_hi
            if a_lo > best_acc:
                best_acc, best_c = a_lo, 10.0**mid_lo
        else:
            lo = mid_lo
            if a_hi > best_acc:
                best_acc, best_c = a_hi, 10.0**mid_hi
    return best_acc, best_c


def shot_indices(labels: np.ndarray, shot: int, run: int, num_classes: int) -> np.ndarray:
    """Run ``run``'s subset: up to ``shot`` rows of each class, drawn class
    by class from ``np.random.RandomState(run)`` without replacement."""
    rng = np.random.RandomState(run)
    idx = []
    for c in range(num_classes):
        pool = np.flatnonzero(labels == c)
        if len(pool) == 0:
            continue
        idx.extend(rng.choice(pool, min(shot, len(pool)), replace=False))
    return np.asarray(idx)


def run_probe(train_npz: str, test_npz: str, num_run: int = 10, num_step: int = 8,
              shots=SHOTS, backend: str = "torch",
              device=None) -> Dict[int, Tuple[float, float]]:
    """The protocol over the two files: ``{shot: (mean, std)}`` of the best
    test accuracies in percent over ``num_run`` subsets. The torch backend
    fits on ``device`` (the card if None)."""
    tr, te = np.load(train_npz), np.load(test_npz)
    Xtr_all, ytr_all = tr["feature_list"], tr["label_list"]
    Xte, yte = te["feature_list"], te["label_list"]
    num_classes = int(max(ytr_all.max(), yte.max())) + 1
    if backend == "torch":
        dev = resolve_device(device)
        Xtr_t, ytr_t = (torch.from_numpy(a).to(dev) for a in (Xtr_all.astype(np.float32),
                                                                ytr_all.astype(np.int64)))
        Xte, yte = (torch.from_numpy(a).to(dev) for a in (Xte.astype(np.float32),
                                                            yte.astype(np.int64)))

    results: Dict[int, Tuple[float, float]] = {}
    for shot in shots:
        accs = []
        for run in range(num_run):
            idx = shot_indices(ytr_all, shot, run, num_classes)
            if backend == "torch":
                sel = torch.from_numpy(idx).to(dev)
                Xtr, ytr = Xtr_t[sel], ytr_t[sel]
            else:
                Xtr, ytr = Xtr_all[idx], ytr_all[idx]
            acc, _ = probe_once(Xtr, ytr, Xte, yte, num_classes, num_step=num_step,
                                backend=backend)
            accs.append(acc * 100.0)
        results[shot] = (float(np.mean(accs)), float(np.std(accs)))
        log.info("%d-shot: %.2f +- %.2f", shot, *results[shot])
    return results


def main(args: Optional[Union[TaskArgs, Sequence[str]]] = None) -> Dict[int, Tuple[float, float]]:
    """The probe over ``<output_dir>/<exp_name or "lp_feats">/{train,test}.npz``;
    writes ``linear_probe_results.txt`` beside them, a line a shot count."""
    if not isinstance(args, TaskArgs):
        args = parse_args(args)
    logging.basicConfig(level=logging.INFO)
    feat_dir = os.path.join(args.output_dir, args.exp_name or "lp_feats")
    results = run_probe(os.path.join(feat_dir, "train.npz"), os.path.join(feat_dir, "test.npz"),
                        num_run=args.num_run, num_step=args.num_step,
                        device=args.device or None)
    out = os.path.join(feat_dir, "linear_probe_results.txt")
    with open(out, "w") as f:
        for shot, (mean, std) in results.items():
            f.write(f"{shot}-shot: {mean:.2f} +- {std:.2f}\n")
    log.info("wrote %s", out)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
