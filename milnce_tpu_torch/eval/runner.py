"""Shared eval-task dispatch (port of ``milnce_tpu/eval/runner.py``): one
place that turns (task name, manifest, video root) into metrics, used by
both the eval CLI and the in-training evaluator."""

from __future__ import annotations

from milnce_tpu_torch.config import DataConfig
from milnce_tpu_torch.data.datasets import HMDBSource, MSRVTTSource, YouCookSource

EVAL_TASKS = ("hmdb", "youcook", "msrvtt")


def evaluate_task(task: str, model, device, *, data_cfg: DataConfig,
                  csv_path: str, video_root: str, tokenizer=None,
                  num_clip: int = 4, batch_size: int = 16,
                  decoder=None, max_words: int = 30,
                  process_group=None) -> dict:
    """Run one downstream eval task on ``device`` (one device or a group)
    over the ranks of ``process_group`` (None: this process alone, every
    rank of it else, each getting the same metrics); returns its metrics
    dict (R@k/MedR for retrieval, per-split accuracy for the probe).

    ``tokenizer`` is required for the retrieval tasks; ``decoder=None``
    builds ``data_cfg.decoder_backend`` (pass a FakeDecoder for hermetic
    runs)."""
    if task not in EVAL_TASKS:
        raise ValueError(f"unknown eval task {task!r}; expected one of "
                         f"{'|'.join(EVAL_TASKS)}")
    if task == "hmdb":
        from milnce_tpu_torch.eval.linear_probe import evaluate_linear_probe

        source = HMDBSource(csv_path, video_root, data_cfg,
                            num_clip=num_clip, decoder=decoder)
        return evaluate_linear_probe(model, source, device,
                                     process_group=process_group)

    from milnce_tpu_torch.eval.retrieval import evaluate_retrieval

    if tokenizer is None:
        raise ValueError("retrieval tasks need a tokenizer")
    cls = YouCookSource if task == "youcook" else MSRVTTSource
    source = cls(csv_path, video_root, data_cfg, tokenizer,
                 num_clip=num_clip, decoder=decoder, max_words=max_words)
    return evaluate_retrieval(model, source, device, batch_size=batch_size,
                              process_group=process_group)
