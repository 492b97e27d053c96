"""Multinomial logistic regression without sklearn, for the Trainer's
``head_refit``.

The JAX package fits the posterior head with sklearn's
``LogisticRegression(C=C, max_iter=5000)``: a multinomial model with an L2
penalty on the coefficients, the intercept unpenalised, solved by
L-BFGS from zeros. The card's machine has no sklearn, so this module fits
the same model: it minimises

    (1 / n) sum_i cross_entropy(x_i W^T + b, y_i) + |W|^2 / (2 C n),

sklearn's objective (C times the summed cross-entropy plus half the
squared norm, divided by C n), in float64 with ``torch.optim.LBFGS`` and a
strong-Wolfe line search from W = 0, b = 0, to a largest gradient entry of
``GRAD_TOL``, tighter than sklearn's 1e-4. Starting from zero keeps the
intercepts summing to zero, as sklearn's do (each step's intercept
gradient sums to zero over the classes). Classes are the sorted distinct
labels of the training set, as sklearn's ``classes_``.
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

GRAD_TOL = 1e-8
MAX_ITER = 5000


class LogisticFit(NamedTuple):
    """A fitted model: ``classes`` (K,), ``coef`` (K, D) and ``intercept``
    (K,), float64 numpy arrays."""

    classes: np.ndarray
    coef: np.ndarray
    intercept: np.ndarray

    def predict(self, X) -> np.ndarray:
        """The class of the largest score, X W^T + b (the first of ties)."""
        return self.classes[np.argmax(self.scores(X), axis=1)]

    def scores(self, X) -> np.ndarray:
        """X W^T + b, (n, K) float64."""
        return np.asarray(X, np.float64) @ self.coef.T + self.intercept

    def predict_proba(self, X) -> np.ndarray:
        """The class probabilities, the softmax of the scores (sklearn's
        multinomial ``predict_proba``), (n, K) float64."""
        scores = self.scores(X)
        e = np.exp(scores - scores.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)


def fit(X, y, C: float) -> LogisticFit:
    """Fit the multinomial L2 logistic regression of ``X`` (n, D) on the
    labels ``y`` (n,) with inverse regularisation ``C``."""
    classes, target = np.unique(np.asarray(y), return_inverse=True)
    if len(classes) < 2:
        raise ValueError(f"needs at least 2 classes, got {classes.tolist()}")
    X = torch.as_tensor(np.asarray(X, np.float64))
    target = torch.as_tensor(target, dtype=torch.long)
    n, d = X.shape
    W = torch.zeros((len(classes), d), dtype=torch.float64,
                    requires_grad=True)
    b = torch.zeros(len(classes), dtype=torch.float64, requires_grad=True)
    opt = torch.optim.LBFGS([W, b], lr=1.0, max_iter=MAX_ITER,
                            max_eval=2 * MAX_ITER, tolerance_grad=GRAD_TOL,
                            tolerance_change=1e-15, history_size=10,
                            line_search_fn="strong_wolfe")

    def objective():
        opt.zero_grad()
        loss = F.cross_entropy(X @ W.T + b, target, reduction="sum") / n \
            + (W * W).sum() / (2.0 * C * n)
        loss.backward()
        return loss

    opt.step(objective)
    return LogisticFit(classes, W.detach().numpy().copy(),
                       b.detach().numpy().copy())
