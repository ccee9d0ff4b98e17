"""Paper-style evaluation metrics (the reference's src/utils.py:84-156):
NRMSE between FEM-verified stress-strain responses and targets, best-of-N
statistics with a divergence cut, and closest-training-match baselines.
The port's copy of videometamaterials_tpu/postproc/metrics.py."""

from __future__ import annotations

import numpy as np


def reduce_csv_to_first_n_rows(csv_file: str, n: int) -> None:
    """Truncate a CSV to its first n rows in place (src/utils.py:84-92)."""
    with open(csv_file, "r") as f:
        lines = f.readlines()[:n]
    with open(csv_file, "w") as f:
        f.writelines(lines)


def compute_NRMSE(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """sqrt(sum (y_pred - y_true)^2 / sum y_true^2)."""
    return float(np.sqrt(np.sum(np.square(y_pred - y_true))
                         / np.sum(np.square(y_true))))


def compute_NRMSE_arrays(y_true: np.ndarray,
                         y_pred: np.ndarray) -> np.ndarray:
    """compute_NRMSE of one curve against each row of y_pred."""
    return np.sqrt(np.sum(np.square(y_pred - y_true), axis=1)
                   / np.sum(np.square(y_true)))


def find_closest_match(y_true, y_pred, skip_first: bool = False):
    """(NRMSE, row) of the row of y_pred closest to y_true (the second
    closest with skip_first, for a curve that is itself a row)."""
    nrmse = compute_NRMSE_arrays(y_true, y_pred)
    idx = np.argsort(nrmse)[1] if skip_first else np.argsort(nrmse)[0]
    return nrmse[idx], idx


def compute_full_error(data: np.ndarray, samples: int,
                       closest_match: bool = False,
                       full_data: np.ndarray | None = None,
                       skip_first: bool = False,
                       divergence_threshold: float = 50.0):
    """Rows of `data` are grouped per target: row 0 of each group is the
    target curve, rows 1..k are FEM-verified predictions. Per prediction
    the NRMSE is computed over the prefix before any |value| exceeds the
    divergence threshold (NaN when the first value does). Returns (mean
    error, mean best-of-k error, best index per target), and with
    closest_match also the closest rows of full_data's errors and the
    least relative gain over them (src/utils.py:97-144)."""
    tot = data.shape[0]
    if tot % samples:
        raise ValueError("Number of samples must be a divisor of the total "
                         "number of data points")
    if closest_match and full_data is None:
        raise ValueError("If closest_match is True, full_data must be "
                         "provided")
    per = tot // samples
    err, err_match = [], []
    for i in range(samples):
        target = data[i * per]
        for j in range(1, per):
            pred = data[i * per + j]
            valid = 0
            for v in pred:
                if abs(v) > divergence_threshold:
                    break
                valid += 1
            err.append(np.nan if valid == 0 else
                       compute_NRMSE(target[:valid], pred[:valid]))
        if closest_match:
            if len(target) != full_data.shape[1]:
                raise ValueError("Data dimensions do not match.")
            e, _ = find_closest_match(target, full_data, skip_first)
            err_match.append(e)

    errors = np.array(err).reshape(samples, per - 1)
    min_errors = np.nanmin(errors, axis=1)
    try:
        min_idx = np.nanargmin(errors, axis=1)
    except ValueError:
        min_idx = -1

    if closest_match:
        err_match = np.array(err_match).reshape(samples)
        rel = (min_errors - err_match) / err_match
        return (np.mean(errors), np.mean(min_errors), min_idx, err_match,
                np.nanmin(rel))
    return np.mean(errors), np.mean(min_errors), min_idx
