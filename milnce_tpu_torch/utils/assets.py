"""Asset conversion CLI (port of ``milnce_tpu/utils/assets.py``; the
``milnce-assets-torch`` script): the reference's binary blobs <-> the
port's files.

The reference distributes ``word2vec.pth`` (a torch-saved (V, 300)
embedding table), ``dict.npy`` (the token vocabulary) and S3D
checkpoints.  The port keeps the reference's parameter names and
layouts, so a reference checkpoint loads straight into its model
(``utils/torch_convert.py::load_reference_checkpoint``)::

    python -m milnce_tpu_torch.utils.assets word2vec word2vec.pth word2vec.npy
    python -m milnce_tpu_torch.utils.assets ckpt epoch0012.pth.tar run_dir/
    python -m milnce_tpu_torch.utils.assets export run_dir/ epoch0012.pth.tar
    python -m milnce_tpu_torch.utils.assets inspect some_checkpoint.pth.tar

``ckpt`` takes the model flags of the trainer
(``--preset``, ``--model.*``) for the model the checkpoint holds; the
default is the full model the reference trains.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def convert_word2vec(src: str, dst: str) -> tuple[int, int]:
    """torch-saved embedding table -> .npy; returns (vocab, dim)."""
    table = torch.load(src, map_location="cpu", weights_only=False)
    if hasattr(table, "weight"):             # nn.Embedding module
        table = table.weight.detach()
    arr = np.asarray(table.numpy() if hasattr(table, "numpy") else table,
                     np.float32)
    assert arr.ndim == 2, f"expected (V, D) table, got {arr.shape}"
    np.save(dst, arr)
    return arr.shape


def convert_checkpoint(src: str, dst: str, model_cfg=None) -> int:
    """Reference torch checkpoint (either flavor: the DDP ``{'epoch',
    'state_dict': {'module.<k>': tensor}}`` wrapper or the upstream flat
    table) -> a port RUN directory in exactly the layout the trainer's
    ``--train.resume`` and the eval CLI restore (``train/checkpoint.py``:
    the model in the reference layout, a fresh Adam state, its schedule,
    step 0).  ``model_cfg``: the ``ModelConfig`` of the model the file
    holds (default: the full model).  Returns the saved epoch label."""
    from milnce_tpu_torch.config import ModelConfig, OptimConfig
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.train.checkpoint import CheckpointManager, train_state
    from milnce_tpu_torch.train.schedule import cosine_with_warmup
    from milnce_tpu_torch.train.state import build_optimizer
    from milnce_tpu_torch.utils.torch_convert import load_reference_checkpoint

    raw = torch.load(src, map_location="cpu", weights_only=False)
    epoch = int(raw.get("epoch", 0)) if isinstance(raw, dict) else 0
    model = build_model(model_cfg or ModelConfig())
    load_reference_checkpoint(model, src)
    optimizer, lr = build_optimizer(model, OptimConfig(),
                                    cosine_with_warmup(1e-3, 1, 2))
    CheckpointManager(dst).save(
        epoch, train_state(model, optimizer, lr, step=0, epoch=epoch))
    return epoch


def export_checkpoint(src: str, dst: str) -> int:
    """Port RUN directory -> a torch .pth the REFERENCE's eval scripts
    load (the DDP ``{'epoch', 'state_dict': {'module.<k>': tensor}}``
    flavor their format sniff expects).  The reverse of
    :func:`convert_checkpoint`: train here, evaluate there.  Only the
    model's tensors are read (``restore_raw``)."""
    from milnce_tpu_torch.train.checkpoint import CheckpointManager

    epoch, weights = CheckpointManager(src, create=False).restore_raw()
    torch.save({"epoch": epoch,
                "state_dict": {f"module.{k}": v.clone()
                               for k, v in weights.items()}}, dst)
    return epoch


def inspect(src: str) -> None:
    raw = torch.load(src, map_location="cpu", weights_only=False)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    if isinstance(sd, dict):
        print(f"{len(sd)} entries"
              + (f" (epoch {raw['epoch']})" if isinstance(raw, dict)
                 and "epoch" in raw else ""))
        for k, v in list(sd.items())[:40]:
            shape = tuple(v.shape) if hasattr(v, "shape") else type(v).__name__
            print(f"  {k}: {shape}")
        if len(sd) > 40:
            print(f"  ... {len(sd) - 40} more")
    else:
        print(type(sd), getattr(sd, "shape", ""))


def main(argv=None):
    from milnce_tpu_torch.config import PRESETS, _add_dataclass_args

    p = argparse.ArgumentParser(description="milnce-tpu-torch asset converter")
    sub = p.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("word2vec", help="torch .pth table -> .npy")
    w.add_argument("src")
    w.add_argument("dst")
    c = sub.add_parser("ckpt", help="reference torch checkpoint -> port "
                                    "run dir")
    c.add_argument("src")
    c.add_argument("dst")
    c.add_argument("--preset", choices=sorted(PRESETS), default="full",
                   help="model config of the checkpoint")
    _add_dataclass_args(c, "model.", PRESETS["full"]().model)
    e = sub.add_parser("export", help="port run dir -> torch .pth "
                                      "(reference eval scripts load it)")
    e.add_argument("src")
    e.add_argument("dst")
    i = sub.add_parser("inspect", help="list a torch checkpoint's tensors")
    i.add_argument("src")
    args = p.parse_args(argv)

    if args.cmd == "word2vec":
        v, d = convert_word2vec(args.src, args.dst)
        print(f"wrote {args.dst}: ({v}, {d})")
    elif args.cmd == "ckpt":
        model_cfg = PRESETS[args.preset]().model
        for key, val in vars(args).items():
            if key.startswith("model.") and val is not None:
                setattr(model_cfg, key.partition(".")[2], val)
        epoch = convert_checkpoint(args.src, args.dst, model_cfg)
        print(f"wrote {args.dst}: run dir at epoch {epoch}")
    elif args.cmd == "export":
        epoch = export_checkpoint(args.src, args.dst)
        print(f"wrote {args.dst}: torch checkpoint at epoch {epoch}")
    else:
        inspect(args.src)


if __name__ == "__main__":
    sys.exit(main())
