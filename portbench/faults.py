"""Faults planted under the timed path, for the checks that `correct`
comes out false when the polish is broken (tests/ on the CPU, control.py
on the card).  Each takes the polish the window drives
(pipeline.polish_prepared_batch's signature) and returns a broken one:

- unchanged: the refine step returns its state unchanged (no round
  runs, every ZMW reported converged), so the drafts are emitted;
- half_batch: only the first half of the batch is polished, and the
  second half gets the first half's reads under its own ids;
- altered_token: one base of every emitted read is changed, at its
  middle, after the polish produced it;
- half_reads: each ZMW is polished over the first half of its mapped
  subreads only (rounded up), as a wrong read gate or live-read mask
  would;
- qv_saturated: every emitted QV reads 93, the emitted qualities' cap;
- qv_shifted: every emitted QV reads QV_SHIFT more than the sweep gave.

The exchange between chips has no fault here: every cell takes one
chip."""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np


def unchanged(polish):
    batch = importlib.import_module("pbccs_tpu_torch.parallel.batch")

    def broken(preps, settings, **kw):
        cls = batch.BatchPolisher
        orig = cls.refine

        def refine(self, opts=None, skip=None, budget=None):
            res = orig(self, opts, skip, 0)
            for r in res:
                r.converged = True
            return res

        cls.refine = refine
        try:
            return polish(preps, settings, **kw)
        finally:
            cls.refine = orig

    return broken


def half_batch(polish):
    def broken(preps, settings, **kw):
        h = (len(preps) + 1) // 2
        out = list(polish(preps[:h], settings, **kw))
        for k, p in enumerate(preps[h:]):
            failure, res = out[k % h]
            if res is not None:
                res = dataclasses.replace(res, id=p.chunk.id)
            out.append((failure, res))
        return out

    return broken


def altered_token(polish):
    def broken(preps, settings, **kw):
        out = list(polish(preps, settings, **kw))
        for k, (failure, res) in enumerate(out):
            if res is not None and res.sequence:
                s = res.sequence
                p = len(s) // 2
                b = "ACGT"[("ACGT".index(s[p]) + 1) % 4]
                out[k] = (failure, dataclasses.replace(
                    res, sequence=s[:p] + b + s[p + 1:]))
        return out

    return broken


def half_reads(polish):
    def broken(preps, settings, **kw):
        cut = [dataclasses.replace(p, mapped=p.mapped[:(len(p.mapped) + 1)
                                                      // 2])
               for p in preps]
        return polish(cut, settings, **kw)

    return broken


#: what qv_shifted adds to every emitted QV
QV_SHIFT = 20


def _qvs_changed(polish, change):
    def broken(preps, settings, **kw):
        out = list(polish(preps, settings, **kw))
        for k, (failure, res) in enumerate(out):
            if res is not None:
                out[k] = (failure, dataclasses.replace(
                    res, qvs=change(np.asarray(res.qvs))))
        return out

    return broken


def qv_saturated(polish):
    return _qvs_changed(polish, lambda q: np.full_like(q, 93))


def qv_shifted(polish):
    return _qvs_changed(polish, lambda q: q + QV_SHIFT)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered_token": altered_token, "half_reads": half_reads,
          "qv_saturated": qv_saturated, "qv_shifted": qv_shifted}
