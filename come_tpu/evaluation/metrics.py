"""Evaluation metrics: community NMI and node-classification F1.

Reference parity surface (SURVEY.md C11, §3.5): NMI of argmax
responsibilities vs ground truth, and one-vs-rest logistic-regression
macro/micro-F1 on the embeddings at given train ratios (deepwalk ``scoring``
lineage).  These run on host in numpy/scipy — they are off the training hot
path.  Each function matches its scikit-learn counterpart, which the
reference used (tests compare them where scikit-learn is installed):

* ``nmi_score`` — ``normalized_mutual_info_score`` (arithmetic mean);
* ``f1_scores`` — ``f1_score(average="macro" | "micro")``;
* the classifier — ``OneVsRestClassifier(LogisticRegression(C=1))``: one
  binary L2-regularized logistic regression per label, intercept
  unpenalized, fit by L-BFGS-B.
"""

from __future__ import annotations

import numpy as np


def _entropy(counts: np.ndarray) -> float:
    p = counts[counts > 0] / counts.sum()
    return float(-np.sum(p * np.log(p)))


def nmi_score(labels_true: np.ndarray, labels_pred: np.ndarray) -> float:
    """Normalized mutual information, arithmetic-mean normalization
    (scikit-learn's ``normalized_mutual_info_score`` default), the
    reference's community-quality metric."""
    a = np.asarray(labels_true).reshape(-1)
    b = np.asarray(labels_pred).reshape(-1)
    if a.shape != b.shape:
        raise ValueError(f"label shapes differ: {a.shape} vs {b.shape}")
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    na, nb = ai.max() + 1, bi.max() + 1
    if na == nb == 1:
        return 1.0  # both labelings a single cluster: identical
    cont = np.zeros((na, nb), np.float64)
    np.add.at(cont, (ai, bi), 1.0)
    n = cont.sum()
    pa = cont.sum(1)
    pb = cont.sum(0)
    nz = cont > 0
    mi = float(
        np.sum(
            cont[nz] / n
            * (np.log(cont[nz] * n) - np.log(np.outer(pa, pb)[nz]))
        )
    )
    denom = 0.5 * (_entropy(pa) + _entropy(pb))
    if denom <= 0.0:
        return 0.0
    return float(min(max(mi, 0.0) / denom, 1.0))


def f1_scores(y_true: np.ndarray, y_pred: np.ndarray) -> dict[str, float]:
    """Macro and micro F1 over 0/1 indicator matrices [n, C] (a label
    absent from both truth and prediction scores 0, as in scikit-learn)."""
    t = np.asarray(y_true).astype(bool)
    p = np.asarray(y_pred).astype(bool)
    tp = np.sum(t & p, axis=0).astype(np.float64)
    fp = np.sum(~t & p, axis=0).astype(np.float64)
    fn = np.sum(t & ~p, axis=0).astype(np.float64)
    denom = 2 * tp + fp + fn
    per = np.divide(2 * tp, denom, out=np.zeros_like(tp), where=denom > 0)
    tot = 2 * tp.sum() + fp.sum() + fn.sum()
    return {
        "macro_f1": float(per.mean()) if per.size else 0.0,
        "micro_f1": float(2 * tp.sum() / tot) if tot > 0 else 0.0,
    }


def fit_one_vs_rest(
    X: np.ndarray, Y: np.ndarray, C: float = 1.0, max_iter: int = 1000
) -> tuple[np.ndarray, np.ndarray]:
    """One binary L2 logistic regression per column of the 0/1 matrix Y.

    Minimizes, per label c, ``C * sum_i log(1 + exp(-s_ic (x_i.w_c + b_c)))
    + ||w_c||^2 / 2`` with s in {-1, +1}; the labels' problems are
    independent, so one L-BFGS-B run solves them jointly.  Returns
    (W [d, n_labels], b [n_labels]).
    """
    from scipy.optimize import minimize

    X = np.asarray(X, np.float64)
    S = np.where(np.asarray(Y) > 0, 1.0, -1.0)
    n, d = X.shape
    k = S.shape[1]

    def objective(theta):
        W = theta[: d * k].reshape(d, k)
        b = theta[d * k :]
        z = S * (X @ W + b)
        loss = C * np.sum(np.logaddexp(0.0, -z)) + 0.5 * np.sum(W * W)
        g = -C * S * np.exp(-np.logaddexp(0.0, z))  # dloss/dmargin
        grad = np.concatenate([(X.T @ g + W).ravel(), g.sum(0)])
        return loss, grad

    res = minimize(
        objective, np.zeros(d * k + k), jac=True, method="L-BFGS-B",
        options={"maxiter": max_iter},
    )
    return res.x[: d * k].reshape(d, k), res.x[d * k :]


def node_classification_f1(
    embeddings: np.ndarray,
    labels: np.ndarray,
    train_ratio: float = 0.5,
    seed: int = 0,
) -> dict[str, float]:
    """One-vs-rest logistic regression macro/micro-F1.

    ``labels`` may be [V] single-label ints or [V, C] 0/1 multi-label.
    Single-label nodes get the highest-scoring class.  For multi-label, the
    deepwalk protocol is used: the classifier predicts the top-k labels per
    node where k is that node's true label count.
    """
    X = np.asarray(embeddings)
    y = np.asarray(labels)
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    perm = rng.permutation(n)
    n_train = max(int(train_ratio * n), 1)
    tr, te = perm[:n_train], perm[n_train:]

    if y.ndim == 1:
        classes, yi = np.unique(y, return_inverse=True)
        Y = np.eye(len(classes), dtype=np.int8)[yi]
    else:
        Y = (y > 0).astype(np.int8)
    W, b = fit_one_vs_rest(X[tr], Y[tr])
    scores = X[te] @ W + b
    if y.ndim == 1:
        pred = np.zeros_like(Y[te])
        pred[np.arange(len(te)), np.argmax(scores, axis=1)] = 1
        # scikit-learn's multiclass f1 averages over the labels that occur
        # in the truth or the prediction only
        seen = Y[te].any(axis=0) | pred.any(axis=0)
        return f1_scores(Y[te][:, seen], pred[:, seen])
    k = Y[te].sum(axis=1).astype(int)  # true label count per node
    pred = np.zeros_like(Y[te])
    for i in range(len(te)):
        if k[i] > 0:
            top = np.argsort(scores[i])[-k[i] :]
            pred[i, top] = 1
    return f1_scores(Y[te], pred)


def f1_train_ratio_sweep(
    embeddings: np.ndarray,
    labels: np.ndarray,
    ratios=(0.1, 0.3, 0.5, 0.7, 0.9),
    seed: int = 0,
) -> dict[float, dict[str, float]]:
    """The deepwalk/ComE-paper protocol: F1 at multiple labeled fractions."""
    return {
        r: node_classification_f1(embeddings, labels, train_ratio=r,
                                  seed=seed)
        for r in ratios
    }
