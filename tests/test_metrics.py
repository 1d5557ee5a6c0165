"""numpy/scipy evaluation metrics vs the scikit-learn functions they match."""

import numpy as np
import pytest

from come_tpu.evaluation.metrics import (
    f1_scores,
    fit_one_vs_rest,
    nmi_score,
    node_classification_f1,
)


def _noisy_labels(rng, n, k_true, k_pred, noise):
    a = rng.integers(0, k_true, n)
    b = np.where(rng.random(n) < noise, rng.integers(0, k_pred, n), a % k_pred)
    return a, b


@pytest.mark.parametrize(
    "n,k_true,k_pred,noise",
    [(200, 5, 5, 0.3), (500, 39, 39, 0.5), (100, 2, 7, 0.9), (64, 4, 2, 0.0)],
)
def test_nmi_matches_sklearn(rng, n, k_true, k_pred, noise):
    skm = pytest.importorskip("sklearn.metrics")
    a, b = _noisy_labels(rng, n, k_true, k_pred, noise)
    np.testing.assert_allclose(
        nmi_score(a, b), skm.normalized_mutual_info_score(a, b), atol=1e-12
    )


def test_nmi_edge_cases():
    assert nmi_score([0, 0, 1, 1], [1, 1, 0, 0]) == pytest.approx(1.0)
    assert nmi_score([3, 3, 3], [0, 0, 0]) == 1.0  # one cluster each
    assert nmi_score([0, 1, 0, 1], [0, 0, 0, 0]) == 0.0
    with pytest.raises(ValueError):
        nmi_score([0, 1], [0, 1, 2])


@pytest.mark.parametrize("labels", [3, 11])
def test_f1_scores_match_sklearn(rng, labels):
    skm = pytest.importorskip("sklearn.metrics")
    t = (rng.random((300, labels)) < 0.3).astype(int)
    p = np.where(rng.random(t.shape) < 0.2, 1 - t, t)
    p[:, 0] = 0  # a label never predicted
    got = f1_scores(t, p)
    assert got["macro_f1"] == pytest.approx(
        skm.f1_score(t, p, average="macro", zero_division=0), abs=1e-12
    )
    assert got["micro_f1"] == pytest.approx(
        skm.f1_score(t, p, average="micro", zero_division=0), abs=1e-12
    )


def test_logistic_regression_matches_sklearn(rng):
    """L-BFGS-B one-vs-rest fit lands on scikit-learn's C=1 solution (the
    objective is strictly convex; both stop near the same minimum)."""
    lm = pytest.importorskip("sklearn.linear_model")
    X = rng.normal(size=(300, 16))
    Y = (X @ rng.normal(size=(16, 3)) + rng.normal(size=(300, 3)) > 0.3)
    W, b = fit_one_vs_rest(X, Y.astype(int))
    for c in range(Y.shape[1]):
        ref = lm.LogisticRegression(C=1.0, max_iter=1000, tol=1e-8)
        ref.fit(X, Y[:, c])
        np.testing.assert_allclose(W[:, c], ref.coef_[0], atol=2e-3)
        np.testing.assert_allclose(b[c], ref.intercept_[0], atol=2e-3)


def _sklearn_protocol(X, y, train_ratio=0.5, seed=0):
    """The pre-numpy implementation: scikit-learn one-vs-rest logistic
    regression, deepwalk top-k for multi-label."""
    lm = pytest.importorskip("sklearn.linear_model")
    mc = pytest.importorskip("sklearn.multiclass")
    skm = pytest.importorskip("sklearn.metrics")
    perm = np.random.default_rng(seed).permutation(X.shape[0])
    n_train = max(int(train_ratio * X.shape[0]), 1)
    tr, te = perm[:n_train], perm[n_train:]
    clf = mc.OneVsRestClassifier(lm.LogisticRegression(max_iter=1000))
    clf.fit(X[tr], y[tr])
    if y.ndim == 1:
        pred = clf.predict(X[te])
    else:
        probs = clf.predict_proba(X[te])
        k = y[te].sum(axis=1).astype(int)
        pred = np.zeros_like(y[te])
        for i in range(len(te)):
            if k[i] > 0:
                pred[i, np.argsort(probs[i])[-k[i]:]] = 1
    return {
        "macro_f1": skm.f1_score(y[te], pred, average="macro"),
        "micro_f1": skm.f1_score(y[te], pred, average="micro"),
    }


@pytest.mark.parametrize("multilabel", [False, True])
def test_node_classification_f1_matches_sklearn(rng, multilabel):
    n, d, c = 400, 12, 5
    centers = rng.normal(size=(c, d)) * 1.5
    y1 = rng.integers(0, c, n)
    X = centers[y1] + rng.normal(size=(n, d))
    if multilabel:
        y = np.eye(c, dtype=int)[y1]
        extra = rng.random((n, c)) < 0.15
        y = np.maximum(y, extra.astype(int))
    else:
        y = y1
    got = node_classification_f1(X, y)
    want = _sklearn_protocol(X, y)
    for k in ("macro_f1", "micro_f1"):
        assert got[k] == pytest.approx(want[k], abs=0.02), (k, got, want)
