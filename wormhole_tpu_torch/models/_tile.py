"""Pieces the FM and wide&deep stores share: the crec2 block decode, the
packed metric row, the completion ticket, the bucket-major slot table, the
sparse step's row gather and write-back, and the CLI's ``key=val``
routing."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from wormhole_tpu_torch.device import split_device_arg
from wormhole_tpu_torch.ops.metrics import accuracy, margin_hist
from wormhole_tpu_torch.utils.config import Config, load_config

EVAL_RECORD = ("split", "eval is forward-only",
               "onehot_cache=off:eval is forward-only")

# the knobs the app Config owns and each model config mirrors
SHARED_KEYS = {"num_buckets", "loss", "seed", "tile_step_kernel",
               "tile_onehot_cache"}


def decode_block(block: dict, ovf_cap: int):
    """(pw, labels, row_mask, ovf_b, ovf_r) of a device block: u8 label 255
    marks a pad row, any other label is clamped to 0/1; the spill lists
    are None when the file has none."""
    lab_u8 = block["labels"]
    row_mask = (lab_u8 != 255).to(torch.float32)
    labels = torch.clamp(lab_u8, max=1).to(torch.float32)
    ovf_b = block["ovf_b"] if ovf_cap else None
    ovf_r = block["ovf_r"] if ovf_cap else None
    return block["pw"], labels, row_mask, ovf_b, ovf_r


def eval_metrics(objv_fn, margin, labels, row_mask):
    """The eval step's tuple (objv, num_ex, acc, pos, neg, margin)."""
    objv = objv_fn(margin, labels, row_mask)
    pos, neg = margin_hist(labels, margin, row_mask)
    return (objv, torch.sum(row_mask), accuracy(labels, margin, row_mask),
            pos, neg, margin)


def metric_row(objv_fn, margin, labels, row_mask, wdelta2) -> torch.Tensor:
    """The JAX packed metric row [objv, num_ex, acc, wdelta2, pos[512],
    neg[512]]."""
    objv, num_ex, acc, pos, neg, _ = eval_metrics(objv_fn, margin, labels,
                                                  row_mask)
    return torch.cat([torch.stack([objv, num_ex, acc, wdelta2]), pos, neg])


def step_ticket(device: torch.device):
    """A CUDA event recorded after the step (None on the CPU, where the
    step has finished on return)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record()
    return event


def gather_bucket_rows(slots: torch.Tensor, batch) -> torch.Tensor:
    """The (kpad, width) rows of the bucket-major table at the batch's
    unique keys."""
    return slots[batch.uniq_keys.to(torch.int64)]


def write_bucket_rows(slots: torch.Tensor, batch, rows: torch.Tensor,
                      delta: torch.Tensor) -> None:
    """``slots.at[uniq_keys].add(delta)`` of the JAX stores for the real
    keys only (unique, first in ``uniq_keys``): each row written once as
    ``rows + delta``; the padding's zero deltas on bucket 0 never are."""
    k = batch.num_keys
    slots[batch.uniq_keys[:k].to(torch.int64)] = rows[:k] + delta[:k]


def init_slots(num_buckets: int, k: int, init_scale: float,
               rng: np.random.Generator) -> np.ndarray:
    """The (num_buckets, 2(1+k)) f32 table [w, v_1..v_k, cg_w, cg_v...]:
    v drawn N(0, init_scale²) from ``rng``, everything else 0 — the JAX
    stores' draw (wormhole_tpu/models/fm.py:86-90), so a fresh store of
    either package holds the same bits."""
    slots = np.zeros((num_buckets, 2 * (1 + k)), np.float32)
    slots[:, 1:1 + k] = init_scale * rng.standard_normal((num_buckets, k))
    return slots


def check_slots(slots: np.ndarray, num_buckets: int, k: int) -> np.ndarray:
    slots = np.asarray(slots, np.float32)
    want = (num_buckets, 2 * (1 + k))
    if slots.shape != want:
        raise ValueError(f"JAX slots of shape {slots.shape}; this store "
                         f"holds {want} (num_buckets, 2(1+dim))")
    return slots


def route_cli(argv: Optional[List[str]], model_cls
              ) -> Tuple[Optional[str], Config, list]:
    """(device token, app Config, model ``key=val`` tokens) of a model
    CLI, routed as the JAX ``main``s do (wormhole_tpu/models/fm.py:546):
    model-config fields go to the model, the rest to ``Config``;
    ``device=`` is the port's own token. The multi-device mesh is not
    ported (ROADMAP.md, slice 5)."""
    import sys
    args = list(sys.argv[1:] if argv is None else argv)
    device, args = split_device_arg(args)
    conf = args.pop(0) if args and "=" not in args[0] else None
    model_keys = {f.name for f in dataclasses.fields(model_cls)} - SHARED_KEYS
    model_kvs = [a for a in args
                 if a.partition("=")[0].strip() in model_keys]
    cfg = load_config(conf, [a for a in args if a not in model_kvs])
    if cfg.mesh_shape:
        raise NotImplementedError(
            "mesh_shape is not ported to the PyTorch package yet (see "
            "ROADMAP.md for the slice that brings it)")
    return device, cfg, model_kvs


def model_config(model_cls, cfg: Config):
    """A model config with the app Config's shared knobs mirrored in."""
    return model_cls(num_buckets=cfg.num_buckets, loss=cfg.loss.value,
                     seed=cfg.seed, tile_step_kernel=cfg.tile_step_kernel,
                     tile_onehot_cache=cfg.tile_onehot_cache)
