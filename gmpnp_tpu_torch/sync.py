"""Counted device-to-host reads.

The port runs eagerly: every Newton, GMRES and CG predicate is read back to
the host once per iteration.  All such reads on the solver path go through
:func:`to_host`, which counts those that leave a device (a CPU tensor costs
no synchronisation and is not counted).  ``SYNCS`` is the running total;
callers take differences around the work they measure.  ``READS`` counts
every call with a tensor, on any device: the reads a loop makes, which a
CPU run can count too.  A read from a device runs in a ``host.read`` span
(``utils.profiling``): the time the host waits for the card.
"""

from __future__ import annotations

import torch

from gmpnp_tpu_torch.utils.profiling import span

SYNCS = 0
READS = 0


def to_host(t):
    """A 0-d tensor as a Python scalar, any other tensor as a numpy array;
    non-tensors pass through unchanged."""
    global SYNCS, READS
    if not isinstance(t, torch.Tensor):
        return t
    READS += 1
    if t.device.type == "cpu":
        return _read(t)
    SYNCS += 1
    with span("host.read"):
        return _read(t)


def _read(t):
    if t.dim() == 0:
        return t.item()
    return t.detach().cpu().numpy()
