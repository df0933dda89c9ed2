"""Driver of the serving runtime on ragged host pushes.

Entry: ``StreamingFleet`` (its default vmapped fleet).  Before each step
every stream ``push``es one interleaved host numpy block whose frame count
is drawn per stream and step, uniform in ``[push_frames_min,
push_frames_max)``; then ``step()`` returns each stream's new samples as
numpy.  The counts come from the seed for ``schedule_steps`` steps (then
repeat); each block is a slice, at an offset drawn from the seed, of one
pool of white noise made on the device from the seed and copied to the host
in set-up, so the window times ``push`` and ``step`` and no generator.

Checked: for every stream and step, the frames the fleet took and the
outputs it emitted (as the fleet reports them, and as delivered) against
the reference schedule of the pushes; for the streams drawn from the seed,
everything they were delivered, in order, against the reference's direct
sums over everything they pushed.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.drivers.common import absmax, device_noise, program
from perfbench.reference import fir as ref


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, layers):
        rtt = program()
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        B, C = config["streams"], config["channels"]
        self.B, self.C, self.n = B, C, traffic["chunk_frames"]
        self.fleet = rtt.StreamingFleet(
            B, C, config["input_rate"], config["output_rate"],
            rtt.Latency[config["latency"]], rtt.Attenuation[config["attenuation"]],
            chunk_frames=self.n, device=self.device,
        )
        rng = np.random.default_rng([seed % (1 << 63), 0x7A6])
        S = traffic["schedule_steps"]
        lo, hi = traffic["push_frames_min"], traffic["push_frames_max"]
        self.frames = rng.integers(lo, hi, size=(S, B), dtype=np.int64)
        pool_len = traffic["pool_frames"] * C
        self.offsets = rng.integers(0, pool_len - hi * C, size=(S, B), dtype=np.int64)
        self.pool = device_noise(seed, (pool_len,), self.device).cpu().numpy()
        self.watch = np.sort(rng.choice(B, size=min(B, traffic["check_streams"]), replace=False))
        self.delivered = {int(b): [] for b in self.watch}
        self.sizes: list[np.ndarray] = []      # per step, values delivered per stream
        self.engine_counts: list[tuple] = []   # per step, (consumed [B], produced [B])
        self.accepted, self.offered = 0, 0
        engine = self.fleet.engine
        inner = engine.resample

        def resample(*args, **kwargs):
            out, consumed, produced, peak = inner(*args, **kwargs)
            self.engine_counts.append((np.asarray(consumed).copy(), np.asarray(produced).copy()))
            return out, consumed, produced, peak

        engine.resample = resample
        layers.wrap(engine, "resample", "fir_resample")
        layers.wrap(self.fleet, "push", "runtime_push")
        layers.wrap(self.fleet, "step", "runtime_step")

    def warm(self) -> None:
        for _ in range(self.traffic["warm_steps"]):
            self.step()

    def step(self) -> int:
        k = len(self.sizes)
        row = k % len(self.frames)
        frames, offsets, C, pool = self.frames[row], self.offsets[row], self.C, self.pool
        push = self.fleet.push
        accepted = 0
        for b in range(self.B):
            o = offsets[b]
            accepted += push(b, pool[o : o + frames[b] * C])
        self.accepted += accepted
        self.offered += int(frames.sum()) * C
        outs = self.fleet.step()
        sizes = np.fromiter((o.size for o in outs), np.int64, self.B)
        self.sizes.append(sizes)
        for b in self.delivered:
            self.delivered[b].append(outs[b])
        return int(sizes.sum())

    def release(self) -> None:
        del self.fleet

    def check(self, limits: dict, control: bool = False):
        """``({name: {"value", "limit"}}, failed stream-steps)``.  With
        ``control`` the reference in TF32 takes the program's place: its
        outputs of the watched streams are judged instead of those delivered
        (the counts stay the program's)."""
        cfg, B, C, n = self.config, self.B, self.C, self.n
        W, L, M = ref.phase_weights(cfg)
        sched = ref.Schedule(L, M, cfg["taps"], cfg["input_capacity"], ref.out_capacity(cfg), n=B)
        queued = np.zeros(B, np.int64)
        bad = np.zeros(B, np.int64)
        emitted_total = np.zeros(B, np.int64)
        for k, sizes in enumerate(self.sizes):
            queued += self.frames[k % len(self.frames)]
            taken, emitted = sched.feed(np.minimum(queued, n))
            queued -= taken
            emitted_total += emitted
            consumed, produced = self.engine_counts[k]
            bad += (sizes != emitted * C) | (produced != emitted) | (consumed != taken)
        mismatch = int(bad.sum()) + int(self.accepted != self.offered)

        Wt = torch.from_numpy(W).to(self.device)
        err, wrong = 0.0, 0
        S = len(self.frames)
        for b, parts in self.delivered.items():
            blocks = [self.pool[self.offsets[k % S, b]:][: self.frames[k % S, b] * C]
                      for k in range(len(self.sizes))]
            x = torch.from_numpy(np.concatenate(blocks).reshape(-1, C).T.copy()).to(self.device)
            got = np.concatenate(parts).reshape(-1, C).T
            count = min(got.shape[1], int(emitted_total[b]))
            expect = ref.outputs(x.double(), 0, 0, count, Wt, L, M)
            if control:
                mine = ref.outputs(x.double(), 0, 0, count, Wt, L, M, control=True)
            else:
                mine = torch.from_numpy(got[:, :count].copy()).to(self.device).double()
            e = absmax(mine - expect)
            err = max(err, e)
            wrong += e > limits["max_abs_err"]
        checks = {
            "count_mismatch": {"value": mismatch, "limit": limits["count_mismatch"]},
            "max_abs_err": {"value": err, "limit": limits["max_abs_err"]},
            # a run that compared no sample is not correct
            "uncompared": {"value": int(not self.delivered), "limit": 0},
        }
        return checks, int((bad > 0).sum()) + int(wrong)
