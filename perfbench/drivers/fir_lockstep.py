"""Driver of the phase-locked FIR fleet on device-resident chunks.

Entry: ``BatchedResamplerFir(synchronized=True)``, the time-major ring
fleet.  Every step offers each stream a full chunk of ``chunk_frames``
frames; the chunks rotate over ``buffers`` device tensors ``[streams,
chunk_frames, channels]`` of white noise made on the device from the seed.
A stream's input is therefore the frames each step took, in order: the
first ``consumed`` frames of each step's chunk.  Outputs stay on the device.

Checked: every step's consumed and produced counts against the reference
schedule, and every sample of the sampled steps (all streams) against the
reference's direct sums.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.core import Sampler
from perfbench.reference import fir as ref
from perfbench.drivers.common import absmax, device_noise, program


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, layers):
        rtt = program()
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        B, C = config["streams"], config["channels"]
        self.B, self.C, self.n = B, C, traffic["chunk_frames"]
        self.fleet = rtt.BatchedResamplerFir(
            B, C, config["input_rate"], config["output_rate"],
            rtt.Latency[config["latency"]], rtt.Attenuation[config["attenuation"]],
            synchronized=True, max_chunk=self.n, horizon=traffic["horizon"], device=self.device,
        )
        self.out_cap = self.fleet.config.out_capacity
        self.bufs = device_noise(seed, (traffic["buffers"], B, self.n, C), self.device)
        slots = traffic["sample_slots"]
        self.kept = torch.empty((slots, B, self.out_cap, C), device=self.device)
        self.slot_meta: dict[int, tuple] = {}
        self.sampler = Sampler(seed, traffic["sample_gap"], slots, traffic["warm_steps"])
        self.counts: list[tuple[int, int]] = []
        layers.wrap(self.fleet, "resample", "fir_resample")

    def warm(self) -> None:
        for _ in range(self.traffic["warm_steps"]):
            self.step()

    def step(self) -> int:
        k = len(self.counts)
        out, consumed, produced, _peak = self.fleet.resample(self.bufs[k % len(self.bufs)])
        c, p = int(consumed[0]), int(produced[0])
        self.counts.append((c, p))
        s = self.sampler.slot(k)
        if s is not None:
            self.kept[s].copy_(out)
            self.slot_meta[s] = (k, np.asarray(consumed).copy(), np.asarray(produced).copy())
        return p * self.B * self.C

    def release(self) -> None:
        del self.fleet

    def check(self, limits: dict, control: bool = False):
        """``({name: {"value", "limit"}}, failed steps)``.  With ``control``
        the reference in TF32 takes the program's place: its outputs of the
        sampled steps are judged instead of the program's (the counts stay
        the program's)."""
        cfg = self.config
        W, L, M = ref.phase_weights(cfg)
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

    def lanes(self, j: int) -> torch.Tensor:
        """Step ``j``'s chunk as float64 lanes ``[streams * channels, frames]``."""
        buf = self.bufs[j % len(self.bufs)]
        return buf.permute(0, 2, 1).reshape(self.B * self.C, self.n).double()
