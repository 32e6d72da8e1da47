"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card is skipped (the cells run small on the CPU) and
the rest of a run goes as on the card. Faults, each planted where the
program's loop hands a step's answer back:

- ``unchanged``: the step returns the state it started from, with the
  step's own report;
- ``altered``: one value of the step's answer is changed by one part in
  a thousand;
- ``lane_dropped`` (sweeps): the last lane of the batch is left out, its
  state left where it started.

A cell runs on one card, so no exchange between cards can be left out.
"""

import importlib

import pytest
import torch

from benchmark.tests.small import SMALL, STEP_FACTORIES, run_small


def _fault(kind):
    def broken(u_prev, out):
        u = out[0]
        if kind == "unchanged":
            u = u_prev.clone()
        elif kind == "altered":
            u = u.clone()
            flat = u.view(-1)
            k = flat.numel() // 3
            flat[k] = flat[k] * 1.001 + 1e-3
        elif kind == "lane_dropped":
            u = u.clone()
            u[-1] = u_prev[-1]
        return (u,) + tuple(out[1:])
    return broken


def plant(monkeypatch, cell, kind):
    """Break every step the cell's program makes, below the harness."""
    mod_name, factories = STEP_FACTORIES[cell]
    mod = importlib.import_module(mod_name)
    fault = _fault(kind)

    def broken_step(step):
        def bad(*a):
            return fault(a[0], step(*a))
        return bad

    for name in factories:
        make = getattr(mod, name)

        def patched(*a, _make=make, **kw):
            made = _make(*a, **kw)
            if isinstance(made, tuple):        # (step, prep_init)
                return (broken_step(made[0]),) + made[1:]
            return broken_step(made)

        monkeypatch.setattr(mod, name, patched)


CASES = [(c, k) for c in sorted(SMALL) for k in ("unchanged", "altered")]
CASES += [(c, "lane_dropped") for c in sorted(SMALL) if "sweep" in c]


@pytest.mark.parametrize("cell,kind", CASES)
def test_fault_is_not_correct(monkeypatch, cell, kind):
    torch.manual_seed(0)
    plant(monkeypatch, cell, kind)
    res = run_small(cell)
    assert not res["correct"], res["checks"]
