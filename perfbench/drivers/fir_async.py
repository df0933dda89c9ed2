"""Driver of the async multi-tenant FIR fleet on device-resident chunks.

Entry: ``BatchedResamplerFir(synchronized=True, sync_variant="async_tm")``
and its ``slew``.  Each tenant joins at its own start phase, drawn from the
seed uniform over the integers in ``[0, M)`` (1/M frames) and passed as
``initial_positions``.  Every step offers each tenant a full chunk of
``chunk_frames`` frames; the chunks rotate over ``buffers`` device tensors
``[streams, chunk_frames, channels]`` of white noise made on the device
from the seed.  After every step the drift loop slews each tenant by a draw
from the seed, uniform over the integers in ``[-slew_max, slew_max]`` 1/M
frames (``Drift``).  Outputs stay on the device.

Checked, against the plain reference (``reference/fir_async.py``): every
step's consumed and produced counts and every applied slew, exactly, and
every sample of the sampled steps (all tenants) against its direct sum.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.core import Sampler
from perfbench.drivers import fir_lockstep
from perfbench.drivers.common import absmax, device_noise, program
from perfbench.reference import fir_async as ref
from perfbench.reference.fir import reduced_ratio


def start_phases(seed: int, streams: int, M: int) -> np.ndarray:
    """Each tenant's start position, uniform over the integers in ``[0,
    M)`` 1/M frames."""
    return np.random.default_rng([seed % (1 << 63), 0xFA5E]).integers(0, M, streams)


class Drift:
    """The drift loop's slews, in 1/M frames.  A tenant's offset is its
    start phase plus the slews applied to it; ``request()`` draws each
    tenant's slew and reflects it where it would leave the offset outside
    ``[0, M - 1)``, so that the fleet's spread stays under one period (M);
    ``moved(applied)`` adds what the fleet applied."""

    def __init__(self, seed: int, phases: np.ndarray, M: int, most: int):
        self.rng = np.random.default_rng([seed % (1 << 63), 0x5E1])
        self.offset = np.asarray(phases, np.int64).copy()
        self.top, self.most = M - 1, most

    def request(self) -> np.ndarray:
        v = self.rng.integers(-self.most, self.most + 1, self.offset.shape[0])
        o = self.offset + v
        return np.where((o >= 0) & (o < self.top), v, -v)

    def moved(self, applied: np.ndarray) -> None:
        self.offset += applied


class Driver(fir_lockstep.Driver):
    """The lockstep driver's warm-up, release and input lanes, with the
    async fleet, its slews and its own check."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str, layers):
        rtt = program()
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        B, C = config["streams"], config["channels"]
        self.B, self.C, self.n = B, C, traffic["chunk_frames"]
        self.L, self.M = reduced_ratio(config["input_rate"], config["output_rate"])
        self.phases = start_phases(seed, B, self.M)
        self.fleet = rtt.BatchedResamplerFir(
            B, C, config["input_rate"], config["output_rate"],
            rtt.Latency[config["latency"]], rtt.Attenuation[config["attenuation"]],
            synchronized=True, sync_variant="async_tm", max_chunk=config["max_chunk"],
            horizon=traffic["horizon"], max_out=config["max_out"],
            initial_positions=self.phases, skew_periods=config["skew_periods"],
            device=self.device,
        )
        self.out_cap = min(self.fleet.config.out_capacity, config["max_out"])
        self.bufs = device_noise(seed, (traffic["buffers"], B, self.n, C), self.device)
        slots = traffic["sample_slots"]
        self.kept = torch.empty((slots, B, self.out_cap, C), device=self.device)
        self.slot_meta: dict[int, tuple] = {}
        self.sampler = Sampler(seed, traffic["sample_gap"], slots, traffic["warm_steps"])
        self.drift = Drift(seed, self.phases, self.M, traffic["slew_max"])
        self.counts: list[tuple[int, int]] = []
        self.applied: list[np.ndarray] = []  # int16: |slew| <= slew_max
        layers.wrap(self.fleet, "resample", "fir_resample")

    def step(self) -> int:
        k = len(self.counts)
        out, consumed, produced, _peak = self.fleet.resample(self.bufs[k % len(self.bufs)])
        c, p = int(consumed[0]), int(produced[0])
        self.counts.append((c, p))
        s = self.sampler.slot(k)
        if s is not None:
            self.kept[s].copy_(out)
            self.slot_meta[s] = (k, np.asarray(consumed).copy(), np.asarray(produced).copy())
        applied = np.rint(self.fleet.slew(self.drift.request() / self.M) * self.M).astype(np.int64)
        self.drift.moved(applied)
        self.applied.append(applied.astype(np.int16))
        return p * self.B * self.C

    def check(self, limits: dict, control: bool = False):
        """``({name: {"value", "limit"}}, failed steps)``.  With ``control``
        the reference in TF32 takes the program's place: its outputs of the
        sampled steps are judged instead of the program's (the counts and
        slews stay the program's)."""
        cfg, L, M = self.config, self.L, self.M
        W, _, _ = ref.phase_weights(cfg)
        sched = ref.AsyncSchedule(L, M, cfg["taps"], cfg["input_capacity"], self.out_cap,
                                  self.phases)
        drift = Drift(self.seed, self.phases, M, self.traffic["slew_max"])
        sampled = {k for k, _, _ in self.slot_meta.values()}
        want, starts, count_bad = [], {}, set()
        for k, got in enumerate(self.counts):
            taken, emitted, start = sched.feed(self.n)
            want.append((taken, emitted))
            if k in sampled:
                starts[k] = start
            applied = sched.slew(drift.request())
            drift.moved(applied)
            if got != (taken, emitted) or not np.array_equal(self.applied[k], applied):
                count_bad.add(k)
        for k, consumed, produced in self.slot_meta.values():
            if (consumed != want[k][0]).any() or (produced != want[k][1]).any():
                count_bad.add(k)
        frame0 = np.concatenate([[0], np.cumsum([t for t, _ in want])])

        Wt = torch.from_numpy(W).to(self.device)
        err, compared, sample_bad = 0.0, 0, set()
        for s, (k, _, _) in sorted(self.slot_meta.items()):
            n_out = want[k][1]
            start = starts[k]
            s_lo = int(np.searchsorted(frame0, int(start.min()) // M, side="right")) - 1
            x = torch.cat([self.lanes(j)[:, : want[j][0]] for j in range(s_lo, k + 1)], dim=1)
            expect = ref.outputs(x, int(frame0[s_lo]), start, n_out, Wt, L, M, self.C)
            if control:
                got = ref.outputs(x, int(frame0[s_lo]), start, n_out, Wt, L, M, self.C,
                                  control=True)
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
