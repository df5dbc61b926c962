"""Evaluation entry point (port of ``milnce_tpu/eval/cli.py``; the
``milnce-eval-torch`` script):

    python -m milnce_tpu_torch.eval.cli youcook --ckpt <dir|.pth> --csv ... --video_root ...
    python -m milnce_tpu_torch.eval.cli msrvtt  ...
    python -m milnce_tpu_torch.eval.cli hmdb    ...

``--ckpt`` is a port checkpoint directory (``train/checkpoint.py``; the
newest label is read) or a reference ``.pth``/``.pth.tar`` file, either
flavor (the DDP ``state_dict`` wrapper or the upstream flat
S3D_HowTo100M table, the latter with ``--space_to_depth``).  Orbax
checkpoints of the JAX package are not read.  Runs over every visible
CUDA card (a device group, ``eval/shards.py``), as the JAX CLI builds its
mesh over every local device, unless ``--platform cpu`` (one device);
without a card it refuses.
"""

from __future__ import annotations

import argparse
import os

import torch

from milnce_tpu_torch.config import DataConfig, ModelConfig
from milnce_tpu_torch.data.datasets import build_tokenizer
from milnce_tpu_torch.data.video import FakeDecoder
from milnce_tpu_torch.eval.metrics import format_metrics
from milnce_tpu_torch.eval.runner import evaluate_task
from milnce_tpu_torch.models.build import build_model
from milnce_tpu_torch.train.checkpoint import CheckpointManager
from milnce_tpu_torch.train.loop import disable_tf32, resolve_device
from milnce_tpu_torch.utils.torch_convert import load_reference_checkpoint


def load_weights(ckpt: str, model) -> str:
    """Load ``ckpt`` into ``model`` in place; returns a line saying what
    was loaded."""
    if not os.path.exists(ckpt):
        raise FileNotFoundError(
            f"checkpoint not found: {ckpt!r} (expected a port checkpoint "
            "directory or a reference .pth/.pth.tar file)")
    if os.path.isdir(ckpt):
        # read-only: a mistyped path raises instead of being created
        epoch, weights = CheckpointManager(ckpt, create=False).restore_raw()
        model.load_state_dict(weights)
        return f"loaded checkpoint (epoch {epoch}) from {ckpt}"
    load_reference_checkpoint(model, ckpt)
    return f"loaded reference checkpoint from {ckpt}"


def eval_devices(platform: str) -> list:
    """``--platform`` -> the eval's device group: every visible card for
    ``cuda`` (refused without one), the one CPU device for ``cpu``."""
    device = resolve_device(platform)
    if device.type != "cuda":
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def main(argv=None):
    p = argparse.ArgumentParser(description="milnce-tpu-torch eval")
    p.add_argument("task", choices=["youcook", "msrvtt", "hmdb"])
    p.add_argument("--ckpt", required=True)
    p.add_argument("--csv", required=True)
    p.add_argument("--video_root", required=True)
    p.add_argument("--token_dict", default="")
    p.add_argument("--word2vec", default="")
    p.add_argument("--num_windows", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--video_size", type=int, default=224)
    p.add_argument("--fps", type=int, default=10)
    p.add_argument("--space_to_depth", action="store_true",
                   help="upstream flat checkpoints need this")
    p.add_argument("--max_words", type=int, default=30)
    # model-shape overrides (hermetic smoke runs / ablations)
    p.add_argument("--embedding_dim", type=int, default=None)
    p.add_argument("--inception_blocks", type=int, default=None)
    p.add_argument("--word_embedding_dim", type=int, default=None)
    p.add_argument("--text_hidden_dim", type=int, default=None)
    p.add_argument("--vocab_size", type=int, default=None)
    p.add_argument("--fake_decoder", action="store_true",
                   help="deterministic in-memory decoder (no ffmpeg/videos); "
                        "hermetic CLI smoke only")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: every visible card (refuses to run without "
                        "one); cpu: one device")
    args = p.parse_args(argv)
    devices = eval_devices(args.platform)
    device = devices[0]
    print(disable_tf32())
    print(f"eval devices: {', '.join(str(d) for d in devices)}")

    data_cfg = DataConfig(fps=args.fps, num_frames=args.num_frames,
                          video_size=args.video_size, max_words=args.max_words)
    model_cfg = ModelConfig(space_to_depth=args.space_to_depth,
                            token_dict_path=args.token_dict,
                            word2vec_path=args.word2vec)
    for fld in ("embedding_dim", "inception_blocks", "word_embedding_dim",
                "text_hidden_dim", "vocab_size"):
        if getattr(args, fld) is not None:
            setattr(model_cfg, fld, getattr(args, fld))
    decoder = FakeDecoder() if args.fake_decoder else None
    model = build_model(model_cfg)
    print(load_weights(args.ckpt, model))
    model.to(device)
    tokenizer = (None if args.task == "hmdb"
                 else build_tokenizer(model_cfg, args.max_words))
    metrics = evaluate_task(
        args.task, model, devices, data_cfg=data_cfg, csv_path=args.csv,
        video_root=args.video_root, tokenizer=tokenizer,
        num_clip=args.num_windows, batch_size=args.batch_size,
        decoder=decoder, max_words=args.max_words)
    if args.task == "hmdb":
        for k, v in metrics.items():
            print(f"HMDB top-1 {k}: {v:.4f}")
    else:
        print(format_metrics(metrics))
    return metrics


if __name__ == "__main__":
    main()
