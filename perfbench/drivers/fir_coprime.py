"""Driver of the phase-locked FIR fleet at a coprime rate pair on
device-resident chunks.

Entry, feed and counts are ``fir_lockstep.Driver``'s:
``BatchedResamplerFir(synchronized=True)``, path ``auto``, which at a
coprime pair (M past the periodic path's periods, as 44101) takes the
farrow path.  Every step offers each stream a full chunk of
``chunk_frames`` frames from ``buffers`` device tensors of white noise made
from the seed; all streams share one position from 0.  Outputs stay on the
device.

Checked: every step's consumed and produced counts against the reference
schedule (``reference/fir.py`` ``Schedule``), and every sample of the
sampled steps (all streams) against the reference's direct sums
(``reference/fir.py`` ``outputs``), on the rows of
``reference/fir_async.py`` ``phase_weights``.

**The one departure from the crate** is those rows': past the last
polyphase branch (``p1`` = P - 1) the blend goes on to the prototype's next
point, branch 0 one tap later, where the crate clamps to branch P - 1.
The fleet's Farrow basis evaluates the filter's continuous kernel, and so
follows the continued rows.  At 44100 -> 44101 Hz that touches 43 of the
44101 residues, outputs ``i`` with ``i % 44101`` in 1..43, about one step
in eleven: there the crate's rows read ~2e-3 against the fleet, over the
cell's limit, and the continued rows ~4e-6
(``tests/test_torch_farrow_reference.py`` pins both).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.drivers import fir_lockstep
from perfbench.drivers.common import absmax
from perfbench.reference import fir as ref
from perfbench.reference.fir_async import phase_weights


class Driver(fir_lockstep.Driver):
    """The lockstep driver's fleet, feed and counts, checked on the
    continued rows."""

    def check(self, limits: dict, control: bool = False):
        """``({name: {"value", "limit"}}, failed steps)``.  With ``control``
        the reference in TF32 takes the program's place: its outputs of the
        sampled steps are judged instead of the program's (the counts stay
        the program's)."""
        cfg = self.config
        W, L, M = phase_weights(cfg)
        sched = ref.Schedule(L, M, cfg["taps"], cfg["input_capacity"], ref.out_capacity(cfg))
        want = []
        for _ in self.counts:
            taken, emitted = sched.feed(self.n)
            want.append((int(taken[0]), int(emitted[0])))
        count_bad = {k for k, (got, exp) in enumerate(zip(self.counts, want)) if got != exp}
        for k, consumed, produced in self.slot_meta.values():
            if (consumed != want[k][0]).any() or (produced != want[k][1]).any():
                count_bad.add(k)
        frame0 = np.concatenate([[0], np.cumsum([t for t, _ in want])])
        out0 = np.concatenate([[0], np.cumsum([e for _, e in want])])

        Wt = torch.from_numpy(W).to(self.device)
        err, compared, sample_bad = 0.0, 0, set()
        for s, (k, _, _) in sorted(self.slot_meta.items()):
            n_out = want[k][1]
            first = int(out0[k])
            s_lo = int(np.searchsorted(frame0, first * L // M, side="right")) - 1
            x = torch.cat([self.lanes(j)[:, : want[j][0]] for j in range(s_lo, k + 1)], dim=1)
            expect = ref.outputs(x, int(frame0[s_lo]), first, n_out, Wt, L, M)
            if control:
                got = ref.outputs(x, int(frame0[s_lo]), first, n_out, Wt, L, M, control=True)
                past = 0.0
            else:
                got = self.kept[s][:, :n_out].permute(0, 2, 1).reshape(self.B * self.C, n_out).double()
                # lanes past the step's outputs hold zeros
                past = absmax(self.kept[s][:, n_out:])
            e = max(absmax(got - expect), past)
            err, compared = max(err, e), compared + 1
            if e > limits["max_abs_err"]:
                sample_bad.add(k)
        checks = {
            "count_mismatch": {"value": len(count_bad), "limit": limits["count_mismatch"]},
            "max_abs_err": {"value": err, "limit": limits["max_abs_err"]},
            # a run that compared no sample is not correct
            "uncompared": {"value": int(not compared), "limit": 0},
        }
        return checks, len(count_bad | sample_bad)
