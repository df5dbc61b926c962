"""Distilled student text tower for the edge tier (port of
``milnce_tpu/quant/distill.py``).

The text path is an embedding lookup plus a two-layer MLP
(``models/text.py``), so distillation is cheap: keep the teacher's frozen
word table, shrink the fat hidden layer, and regress the student's
sentence embeddings onto frozen teacher embeddings over synthetic caption
batches.  The student stays in the teacher's embedding space (same
``embd_dim``), so a student export is an ordinary ``milnce-export``
artifact with a thinner ``text_hidden_dim`` in its model metadata.

The recipe is the JAX package's: ``np.random.default_rng(seed)`` batches
(the same stream, :func:`_sample_tokens` copied), Adam, the loss ``MSE +
(1 - mean cosine)``.  Adam is ``torch.optim.Adam`` over the two Linear
layers; the word table is frozen (``requires_grad=False``, the JAX
``stop_gradient``) and equals the teacher's afterwards.  The JAX draws
its initial student from ``jax.random.PRNGKey(seed)``, which torch cannot
replay: the port draws it from a ``torch.Generator`` seeded with ``seed``
(torch's default Linear init, the JAX tower's), or takes it from
``init_params`` (a Flax ``text_module`` tree — how a parity test hands in
the JAX's initial student).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def student_model_config(teacher_cfg, hidden_dim: int):
    """Teacher ModelConfig -> student ModelConfig: only the text hidden
    width changes."""
    return dataclasses.replace(teacher_cfg, text_hidden_dim=hidden_dim)


def build_student_variables(teacher_variables, student_params) -> dict:
    """Graft trained student text params (a Flax ``text_module`` tree)
    into the full-model Flax tree: the video tower and batch_stats are the
    teacher's — the tree a student export ships."""
    params = dict(teacher_variables["params"])
    params["text_module"] = student_params
    return {"params": params,
            "batch_stats": teacher_variables["batch_stats"]}


def _sample_tokens(rng: np.random.Generator, batch: int, max_words: int,
                   vocab_size: int) -> np.ndarray:
    """Synthetic caption batch: uniform token ids with variable length,
    pad id 0 on the tail (pad rows take part in the word-axis max, so the
    student must see them at train time too)."""
    ids = rng.integers(1, vocab_size, size=(batch, max_words),
                       dtype=np.int64)
    lengths = rng.integers(1, max_words + 1, size=batch)
    ids[np.arange(max_words)[None, :] >= lengths[:, None]] = 0
    return ids.astype(np.int32)


def _text_tree(module) -> dict:
    """The student's state as a Flax ``text_module`` params tree."""
    from milnce_tpu_torch.utils.torch_convert import torch_state_dict_to_flax

    sd = {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}
    return torch_state_dict_to_flax(sd)["params"]


def distill_text_student(model, variables, *, max_words: int,
                         hidden_dim: int | None = None,
                         steps: int = 200, batch_size: int = 32,
                         learning_rate: float = 1e-2, seed: int = 0,
                         init_params=None) -> tuple[dict, dict]:
    """Distill -> (student ``text_module`` params as a Flax tree, info).

    ``model`` is the port's f32 teacher (its text tower runs on the
    model's device, where the student trains too); ``variables`` the same
    weights as a Flax tree (the word table and widths are read from it).
    ``hidden_dim`` defaults to a quarter of the teacher's hidden width.
    ``info['losses']`` holds every step's loss.  Deterministic under a
    fixed ``seed``."""
    from milnce_tpu_torch.models.initializers import _torch_default_
    from milnce_tpu_torch.models.text import SentenceEmbedding
    from milnce_tpu_torch.train.step import make_text_embed_fn
    from milnce_tpu_torch.utils.torch_convert import flax_to_torch_state_dict

    teacher_text = variables["params"]["text_module"]
    word_table = np.asarray(teacher_text["word_embd"]["embedding"])
    vocab_size, word_dim = word_table.shape
    embd_dim = int(np.asarray(teacher_text["fc2"]["kernel"]).shape[-1])
    teacher_hidden = int(
        np.asarray(teacher_text["fc1"]["kernel"]).shape[-1])
    if hidden_dim is None:
        hidden_dim = max(8, teacher_hidden // 4)
    device = next(model.parameters()).device

    student = SentenceEmbedding(embd_dim, vocab_size, word_dim, hidden_dim)
    if init_params is not None:
        sd = flax_to_torch_state_dict({"params": init_params})
        student.load_state_dict({k: torch.from_numpy(np.array(v))
                                 for k, v in sd.items()}, strict=True)
    else:
        gen = torch.Generator().manual_seed(seed)
        _torch_default_(student.fc1.weight, student.fc1.bias, gen)
        _torch_default_(student.fc2.weight, student.fc2.bias, gen)
    with torch.no_grad():
        student.word_embd.weight.copy_(torch.from_numpy(
            np.asarray(word_table, np.float32)))
    student = student.to(device).train()
    opt = torch.optim.Adam([p for p in student.parameters()
                            if p.requires_grad], lr=learning_rate)
    teacher_fn = make_text_embed_fn(model)

    def loss_fn(pred, target):
        mse = torch.mean((pred - target) ** 2)
        cos = torch.sum(pred * target, dim=-1) / (
            torch.linalg.norm(pred, dim=-1)
            * torch.linalg.norm(target, dim=-1) + 1e-12)
        return mse + (1.0 - torch.mean(cos)), torch.mean(cos)

    rng = np.random.default_rng(seed)
    losses, cos = [], torch.tensor(float("nan"))
    for _ in range(steps):
        ids = torch.from_numpy(_sample_tokens(rng, batch_size, max_words,
                                              vocab_size)).to(device)
        target = teacher_fn(ids)
        loss, cos = loss_fn(student(ids), target)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    losses = [float(x) for x in losses]
    info = {
        "hidden_dim": int(hidden_dim),
        "teacher_hidden_dim": teacher_hidden,
        "word_embedding_dim": int(word_dim),
        "embd_dim": embd_dim,
        "steps": int(steps),
        "batch_size": int(batch_size),
        "seed": int(seed),
        "final_loss": losses[-1] if losses else float("nan"),
        "final_cosine": float(cos.detach()),
        "losses": losses,
    }
    return _text_tree(student), info
