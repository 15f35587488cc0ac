"""LFW-style pair verification (reference util/verification.py:37-212 and
util/utils.py:167-295 perform_val).

Protocol: embed both flips of every image, sum the two embedding lists,
L2-normalize, then 10-fold cross-validated threshold search over squared
L2 distances (thresholds 0..4 step 0.01). The reference's leftover
``pdb.set_trace()`` (verification.py:70-72) is, obviously, not reproduced.
KFold is the deterministic unshuffled split (sklearn KFold shuffle=False).

The port's own numpy copy of ``gslora_tpu/evaluation/verification.py``:
``embed_fn`` is any function of a numpy batch returning (B, d) embeddings
as numpy (the port's runs give a torch forward on the run's device).
"""
from __future__ import annotations

import numpy as np


def _kfold_indices(n: int, k: int):
    """sklearn KFold(shuffle=False) split semantics."""
    if n < k:
        # sklearn parity: empty test folds would otherwise produce 0/0
        # NaN accuracies that propagate silently into reports
        raise ValueError(
            f"Cannot have number of splits={k} greater than the number "
            f"of samples={n}")
    sizes = np.full(k, n // k)
    sizes[: n % k] += 1
    idx = np.arange(n)
    start = 0
    for s in sizes:
        test = idx[start:start + s]
        train = np.concatenate([idx[:start], idx[start + s:]])
        yield train, test
        start += s


def calculate_accuracy(threshold: float, dist: np.ndarray,
                       actual_issame: np.ndarray):
    """(tpr, fpr, acc) of predicting same iff dist < threshold
    (verification.py:117-137)."""
    predict = dist < threshold
    tp = np.sum(np.logical_and(predict, actual_issame))
    fp = np.sum(np.logical_and(predict, np.logical_not(actual_issame)))
    tn = np.sum(np.logical_and(np.logical_not(predict),
                               np.logical_not(actual_issame)))
    fn = np.sum(np.logical_and(np.logical_not(predict), actual_issame))
    tpr = 0.0 if (tp + fn == 0) else tp / (tp + fn)
    fpr = 0.0 if (fp + tn == 0) else fp / (fp + tn)
    acc = (tp + tn) / dist.size
    return tpr, fpr, acc


def calculate_roc(thresholds, embeddings1, embeddings2, actual_issame,
                  nrof_folds: int = 10):
    """10-fold threshold search (verification.py:37-112, pca path omitted —
    unused by every caller)."""
    assert embeddings1.shape == embeddings2.shape
    nrof_pairs = min(len(actual_issame), embeddings1.shape[0])
    nrof_thresholds = len(thresholds)
    tprs = np.zeros((nrof_folds, nrof_thresholds))
    fprs = np.zeros((nrof_folds, nrof_thresholds))
    accuracy = np.zeros(nrof_folds)
    best_thresholds = np.zeros(nrof_folds)

    diff = embeddings1 - embeddings2
    dist = np.sum(diff ** 2, axis=1)
    actual_issame = np.asarray(actual_issame, bool)

    for fold_idx, (train, test) in enumerate(
            _kfold_indices(nrof_pairs, nrof_folds)):
        acc_train = np.array([
            calculate_accuracy(t, dist[train], actual_issame[train])[2]
            for t in thresholds])
        best = int(np.argmax(acc_train))
        best_thresholds[fold_idx] = thresholds[best]
        for ti, t in enumerate(thresholds):
            tprs[fold_idx, ti], fprs[fold_idx, ti], _ = calculate_accuracy(
                t, dist[test], actual_issame[test])
        _, _, accuracy[fold_idx] = calculate_accuracy(
            thresholds[best], dist[test], actual_issame[test])
    return tprs.mean(0), fprs.mean(0), accuracy, best_thresholds


def calculate_val(thresholds, embeddings1, embeddings2, actual_issame,
                  far_target: float = 1e-3, nrof_folds: int = 10):
    """VAL @ FAR=far_target with per-fold threshold interpolation
    (verification.py:140-212)."""
    nrof_pairs = min(len(actual_issame), embeddings1.shape[0])
    val = np.zeros(nrof_folds)
    far = np.zeros(nrof_folds)
    dist = np.sum((embeddings1 - embeddings2) ** 2, axis=1)
    actual_issame = np.asarray(actual_issame, bool)

    def val_far(threshold, d, same):
        predict = d < threshold
        ta = np.sum(np.logical_and(predict, same))
        fa = np.sum(np.logical_and(predict, np.logical_not(same)))
        n_same = max(np.sum(same), 1)
        n_diff = max(np.sum(np.logical_not(same)), 1)
        return ta / n_same, fa / n_diff

    for fold_idx, (train, test) in enumerate(
            _kfold_indices(nrof_pairs, nrof_folds)):
        far_train = np.array([val_far(t, dist[train],
                                      actual_issame[train])[1]
                              for t in thresholds])
        if np.max(far_train) >= far_target:
            # interpolate the threshold achieving the target FAR
            threshold = float(np.interp(far_target, far_train, thresholds))
        else:
            threshold = 0.0
        val[fold_idx], far[fold_idx] = val_far(threshold, dist[test],
                                               actual_issame[test])
    return val.mean(), val.std(), far.mean()


def evaluate_verification(embeddings: np.ndarray, actual_issame,
                          nrof_folds: int = 10):
    """verification.py evaluate(): embeddings interleaved pair-wise."""
    thresholds = np.arange(0, 4, 0.01)
    e1, e2 = embeddings[0::2], embeddings[1::2]
    return calculate_roc(thresholds, e1, e2, actual_issame, nrof_folds)


def perform_val(embed_fn, data_set, issame, embedding_size: int = 512,
                batch_size: int = 256, nrof_folds: int = 10,
                return_roc: bool = False):
    """Pair verification (util/utils.py:167-232): ``data_set`` is
    (images, flipped_images) arrays; embeddings of both flips are SUMMED
    then normalized. ``embed_fn(batch) -> (B, d)``.

    Returns (accuracy_mean, accuracy_std, xnorm, best_threshold_mean);
    with ``return_roc`` a fifth element (fpr, tpr) fold-mean arrays for the
    ROC render (the reference returns a rendered roc_curve_tensor,
    util/utils.py:225-231 — rendering lives in metrics.logging.gen_roc_plot
    so eval math stays plot-free)."""
    embeddings_list = []
    for carray in data_set:
        n = len(carray)
        embs = np.zeros((n, embedding_size), np.float64)
        for i in range(0, n, batch_size):
            embs[i:i + batch_size] = np.asarray(
                embed_fn(carray[i:i + batch_size]))
        embeddings_list.append(embs)

    xnorm = float(np.mean([np.linalg.norm(e, axis=1).mean()
                           for e in embeddings_list]))
    embeddings = embeddings_list[0] + embeddings_list[1]
    embeddings /= np.maximum(
        np.linalg.norm(embeddings, axis=1, keepdims=True), 1e-12)
    tpr, fpr, accuracy, best_thresholds = evaluate_verification(
        embeddings, issame, nrof_folds)
    out = (float(accuracy.mean()), float(accuracy.std()), xnorm,
           float(best_thresholds.mean()))
    if return_roc:
        return out + ((fpr, tpr),)
    return out


def perform_val_deit(embed_fn, dis_token, data_set, issame,
                     embedding_size: int = 512, batch_size: int = 256,
                     nrof_folds: int = 10, return_roc: bool = False):
    """DeiT-variant pair verification (util/utils.py:232-295
    perform_val_deit): identical protocol to :func:`perform_val` except the
    backbone takes a distillation token alongside each image batch —
    ``embed_fn(batch, dis_token) -> (B, d)``.

    Reference quirks kept: full batches pass the token while the ragged
    tail batch is embedded WITHOUT it (utils.py:253-266 calls
    ``backbone(batch)`` for the remainder — ``embed_fn`` receives
    ``dis_token=None`` there), and the per-image xnorm statistic is
    averaged over every embedding of both flip passes (utils.py:269-278).
    No model in the reference (or here) actually consumes the token — the
    path exists for checkpoint-evaluation parity only.
    """
    embeddings_list = []
    for carray in data_set:
        n = len(carray)
        embs = np.zeros((n, embedding_size), np.float64)
        idx = 0
        while idx + batch_size <= n:
            embs[idx:idx + batch_size] = np.asarray(
                embed_fn(carray[idx:idx + batch_size], dis_token))
            idx += batch_size
        if idx < n:
            embs[idx:] = np.asarray(embed_fn(carray[idx:], None))
        embeddings_list.append(embs)

    xnorm = float(np.mean([np.linalg.norm(e, axis=1).mean()
                           for e in embeddings_list]))
    embeddings = embeddings_list[0] + embeddings_list[1]
    embeddings /= np.maximum(
        np.linalg.norm(embeddings, axis=1, keepdims=True), 1e-12)
    tpr, fpr, accuracy, best_thresholds = evaluate_verification(
        embeddings, issame, nrof_folds)
    out = (float(accuracy.mean()), float(accuracy.std()), xnorm,
           float(best_thresholds.mean()))
    if return_roc:
        return out + ((fpr, tpr),)
    return out
