"""Step checkpointing and resumable transients.

Port of ``gmpnp_tpu/io/checkpoint.py``.  The transient runs in chunks of
``chunk`` steps with a checkpoint of (solution, extra carry, step index,
config hash) between chunks; a rerun resumes from the latest checkpoint and
refuses configs whose hash changed.

The reference keeps its checkpoints with orbax; here each one is a
directory ``<ckpt_dir>/<step>`` holding ``carry.pt`` (``torch.save`` of the
carry, tensors on the CPU) and ``meta.json`` (step and config hash).  It is
written into a temporary directory first and moved into place with
``os.replace``, so a committed checkpoint is never half-written: an
interrupted save leaves only a ``.tmp-*`` directory, which ``latest``
ignores.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from dataclasses import asdict, is_dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from gmpnp_tpu_torch.solve.timeloop import run_transient


def config_hash(cfg: Any) -> str:
    """Stable hash of a (dataclass) config: sha256 of its sorted JSON."""
    if is_dataclass(cfg):
        d = asdict(cfg)
    else:
        d = dict(cfg)
    blob = json.dumps(d, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _map(fn, x):
    """Apply fn to every tensor of a nest of tuples, lists and dicts
    (lists come back as tuples, NamedTuples keep their type)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, (list, tuple)):
        vals = [_map(fn, v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    return x


class TransientCheckpointer:
    """Step-numbered checkpoints of a transient's carry under one
    directory."""

    def __init__(self, ckpt_dir: str, cfg: Any = None):
        self.dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.hash = config_hash(cfg) if cfg is not None else None

    def steps(self):
        """The committed checkpoint steps, ascending."""
        out = []
        for name in os.listdir(self.dir):
            if name.isdigit() and os.path.exists(
                    os.path.join(self.dir, name, "meta.json")):
                out.append(int(name))
        return sorted(out)

    def save(self, step_idx: int, carry) -> None:
        tmp = os.path.join(self.dir, f".tmp-{step_idx}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(_map(lambda t: t.detach().cpu(), carry),
                   os.path.join(tmp, "carry.pt"))
        with open(os.path.join(tmp, "meta.json"), "w") as fh:
            json.dump({"step": step_idx, "config_hash": self.hash or ""}, fh)
        final = os.path.join(self.dir, str(step_idx))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)

    def latest(self, device=None) -> Optional[Tuple[int, Any]]:
        """(step, carry) of the newest checkpoint, its tensors on
        ``device`` (default: the CPU), or None; ValueError when it was
        written under another config."""
        steps = self.steps()
        if not steps:
            return None
        path = os.path.join(self.dir, str(steps[-1]))
        with open(os.path.join(path, "meta.json")) as fh:
            meta = json.load(fh)
        if self.hash and meta.get("config_hash") not in ("", self.hash):
            raise ValueError(
                f"checkpoint at {self.dir} was produced by a different "
                f"config (hash {meta.get('config_hash')} != {self.hash})")
        carry = torch.load(os.path.join(path, "carry.pt"),
                           map_location=device or "cpu", weights_only=True)
        return int(meta["step"]), carry


def _concat(chunks):
    """Concatenate per-chunk records along the step axis: tensors, numpy
    arrays, and tuples / NamedTuples of them field by field."""
    first = chunks[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(chunks)
    if isinstance(first, tuple):
        cols = [_concat([c[i] for c in chunks]) for i in range(len(first))]
        return type(first)(*cols) if hasattr(first, "_fields") else tuple(cols)
    return np.concatenate([np.asarray(c) for c in chunks])


def run_transient_checkpointed(
    step: Callable,
    carry0,
    n_steps: int,
    ckpt: TransientCheckpointer,
    chunk: int = 100,
    update_carry: Optional[Callable] = None,
    theta_of_carry: Optional[Callable] = None,
    step_state_init: Optional[Callable] = None,
):
    """Chunked resumable transient: run ``chunk`` steps, checkpoint, repeat.
    Returns (final_carry, ys) with ys concatenated over the chunks run in
    this call (the history of chunks before a resume is not rebuilt), or
    ys None when the checkpoint already holds ``n_steps``.  The carry is
    restored onto carry0's device; the recorded history is kept on the CPU.

    ``step_state_init`` opts into the stateful step protocol of
    ``timeloop.make_carried_step``: it is called as
    ``step_state_init(carry, start_index) -> state`` once before the first
    chunk (after any restore), and the state is threaded across chunks in
    memory.  The state is derived data (a factorization of the current
    Jacobian) and is not persisted: a resume rebuilds it.
    """
    device = carry0[0].device
    start = 0
    carry = carry0
    latest = ckpt.latest(device=device)
    if latest is not None:
        start, carry = latest

    state = None
    if step_state_init is not None and start < n_steps:
        state = step_state_init(carry, start)

    ys_chunks = []
    i = start
    while i < n_steps:
        k = min(chunk, n_steps - i)
        offset = i

        def theta_shifted(c, j, _offset=offset):
            if theta_of_carry is None:
                return None
            return theta_of_carry(c, j + _offset)

        def update_shifted(extra, u, j, _offset=offset):
            if update_carry is None:
                return extra
            return update_carry(extra, u, j + _offset)

        carry, ys = run_transient(
            step, carry, k,
            update_carry=update_shifted,
            theta_of_carry=theta_shifted,
            step_state0=state)
        if state is not None:
            u_c, extra_c, state = carry
            carry = (u_c, extra_c)
        ys_chunks.append(_map(lambda t: t.cpu(), ys))
        i += k
        ckpt.save(i, carry)

    if not ys_chunks:
        return carry, None
    return carry, _concat(ys_chunks)
