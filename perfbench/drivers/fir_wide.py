"""Driver of the phase-locked FIR fleet at a rate pair on the program's
wide two-word schedule (a reduced ``M`` past 500,000 or an ``L`` past
2^31 / (input_capacity + 2)), on device-resident chunks.

Entry, feed and counts are ``fir_coprime.Driver``'s:
``BatchedResamplerFir(synchronized=True)``, path ``auto``, which at such a
pair takes the farrow path on the wide schedule.  Every step offers each
stream a full chunk of ``chunk_frames`` frames from ``buffers`` device
tensors of white noise made from the seed; all streams share one position
from 0.  Outputs stay on the device.

Checked: every step's consumed and produced counts against the reference
schedule (``reference/fir.py`` ``Schedule``), and every sample of the
sampled steps (all streams) against ``reference/fir_wide.py``'s direct
sums, whose rows are formed for the sampled outputs' residues alone
(``fir_coprime``'s ``[M, taps]`` table would take 8.2 GB at M 8,000,011).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.drivers import fir_coprime
from perfbench.drivers.common import absmax
from perfbench.reference import fir as ref
from perfbench.reference import fir_wide


class Driver(fir_coprime.Driver):
    """The coprime driver's fleet, feed and counts, checked on rows formed
    per residue."""

    def check(self, limits: dict, control: bool = False):
        """``({name: {"value", "limit"}}, failed steps)``.  With ``control``
        the reference in TF32 takes the program's place: its outputs of the
        sampled steps are judged instead of the program's (the counts stay
        the program's)."""
        cfg = self.config
        ext, L, M = fir_wide.branches(cfg)
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

        err, compared, sample_bad = 0.0, 0, set()
        for s, (k, _, _) in sorted(self.slot_meta.items()):
            n_out = want[k][1]
            first = int(out0[k])
            s_lo = int(np.searchsorted(frame0, first * L // M, side="right")) - 1
            x = torch.cat([self.lanes(j)[:, : want[j][0]] for j in range(s_lo, k + 1)], dim=1)
            expect = fir_wide.outputs(x, int(frame0[s_lo]), first, n_out, ext, L, M)
            if control:
                got = fir_wide.outputs(x, int(frame0[s_lo]), first, n_out, ext, L, M, control=True)
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
