"""Retrieval metrics: R@1 / R@5 / R@10 / MedianRank from a similarity
matrix (the port's own copy of ``milnce_tpu/eval/metrics.py``; behavior
spec: reference metrics.py:9-29).

Given sim[i, j] = score of query i against candidate j with the ground
truth on the diagonal, the rank of each diagonal entry within its row
(0 = best) yields the recall@k rates and the median rank (1-indexed).
"""

from __future__ import annotations

import numpy as np


def compute_retrieval_metrics(sim: np.ndarray) -> dict:
    sim = np.asarray(sim)
    order = np.argsort(-sim, axis=1)
    gt = np.arange(sim.shape[0])[:, None]
    ranks = np.argmax(order == gt, axis=1)
    return {
        "R1": float(np.mean(ranks == 0)),
        "R5": float(np.mean(ranks < 5)),
        "R10": float(np.mean(ranks < 10)),
        "MR": float(np.median(ranks) + 1),
    }


def format_metrics(metrics: dict) -> str:
    return ("R@1: {R1:.4f} - R@5: {R5:.4f} - R@10: {R10:.4f} - "
            "Median R: {MR}".format(**metrics))
