"""``batch_server``, with a comparison that follows the program's router at
its near-ties: for a sigmoid router whose few gates are large (kanana2:
six gates renormalised to sum to 2.448).

There one expert swapped at a near-tie of the biased scores, a choice that
bf16 rounding decides either way, moves the layer's output by a large
share; the reference, teacher-forced on the served tokens but routing by
itself, parts from the program at that position and, through the KV
cache, at every later one, and its widest gap reads as high as the float8
control's.  So at each sampled position and MoE layer the reference takes
the program's chosen experts where their lowest biased score lies within
``check.route_tol`` of its own k-th (a near-tie), and its own choice
elsewhere (``choose`` of the family's reference).  ``route_far``, the rows
where the program's choice lies further than that, must be 0; ``gap_max``
is read as ``batch_server`` reads it.

The program's choices are ``ZipServer.stats[*]["routes"]`` with their
``owners``: the n-th row of a request in a layer is its position n (the
server feeds each request one position a step, its prompt first).
"""
from __future__ import annotations

import numpy as np
import torch

from zipbench.drivers.batch_server import Driver as _Base
from zipbench.reference import compare


class Driver(_Base):
    route_log = None

    def free(self):
        if self.zs is not None:
            self.route_log = [(s["layer"], s["owners"], s["routes"])
                              for s in self.zs.stats]
        super().free()

    def _route_index(self):
        """{(request id, layer): [k] expert ids of each position, in
        order}."""
        index = {}
        for layer, owners, routes in self.route_log or ():
            for b, rid in enumerate(owners or ()):
                index.setdefault((rid, layer), []).append(routes[b])
        return index

    def sequences(self, reqs):
        seqs = super().sequences(reqs)
        index = self._route_index()
        moe = [i for i in range(self.cfg.n_layers) if self.cfg.moe_layer(i)]
        for s, r in zip(seqs, reqs):
            n = len(s["tokens"])
            s["routes"] = {}
            for layer in moe:
                rows = index.get((r.rid, layer), [])
                if len(rows) < n:
                    raise RuntimeError(
                        f"request {r.rid}: {len(rows)} routed positions in "
                        f"layer {layer}, {n} fed to the reference")
                s["routes"][layer] = torch.as_tensor(
                    np.stack(rows[:n]), dtype=torch.long)[None]
        return seqs

    def reference_numbers(self, control: bool = False):
        run = self.run
        reqs = self.sample()
        ref = run.family.REFERENCE
        params = self._weights()
        tol = float(self.spec["check"]["route_tol"])
        ties = {"rows": 0, "forced": 0, "far": 0, "margin_max": 0.0}
        ctl = {"rows": 0, "forced": 0, "far": 0, "margin_max": 0.0}

        def one(s, prec):
            tokens = s["tokens"][None]
            if prec == "f32":
                return ref.logits(params, run.hp, tokens, prec,
                                  routes=s["routes"], tol=tol, ties=ties)[0]
            # the control's own choices, read as the program's are: the
            # float32 pass following them where they are near-ties
            mine = {}
            out = ref.logits(params, run.hp, tokens, prec, record=mine)[0]
            ref.logits(params, run.hp, tokens, "f32", routes=mine, tol=tol,
                       ties=ctl)
            return out

        out = compare.widest_gap(one, self.sequences(reqs), control)
        out.update({f"route_{k}": float(v) for k, v in ties.items()})
        if control:
            out.update({f"control_route_{k}": float(v)
                        for k, v in ctl.items()})
        del params
        return out

    def check(self):
        """``gap_max`` and ``route_far`` against the cell's limits; a run
        that served nothing to compare reads as failing (1e9)."""
        nums = self.reference_numbers()
        ok = nums["positions"] > 0
        return [("gap_max", nums["gap_max"] if ok else 1e9,
                 self.spec["check"]["gap_max"]),
                ("route_far", nums["route_far"] if ok else 1e9, 0)]
