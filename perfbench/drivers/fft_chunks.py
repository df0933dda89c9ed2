"""Driver of the FFT fleet on fixed chunks.

Entry: ``BatchedResamplerFft.resample`` on ``[streams, channels, N]``
chunks.  The chunks rotate over ``buffers`` arrays of white noise made on the
device from the seed.  ``feed: "device"`` hands the fleet those device
tensors and leaves its outputs on the device; ``feed: "host"`` hands it
pageable host numpy copies of them and copies each output back into a
pageable host numpy array of the caller's, as a server that reuses its
buffers does (two in turn, and one of its own for each sampled step).

Checked: every sample of the sampled steps (all streams and channels)
against the reference's overlap-add pipeline.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.core import Sampler
from perfbench.drivers.common import absmax, device_noise, program
from perfbench.reference.fft import FftReference

#: rows the reference transforms at once (float64 spectra of 4096 rows: ~80 MB)
ROWS_PER_BLOCK = 4096


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, layers):
        rtt = program()
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.host = traffic["feed"] == "host"
        B, C = config["streams"], config["channels"]
        self.B, self.C = B, C
        self.n_in, self.n_out = config["fft_size_input"], config["fft_size_output"]
        self.fleet = rtt.BatchedResamplerFft(
            B, C, config["input_rate"], config["output_rate"],
            backend=config["backend"], device=self.device,
        )
        cfg = self.fleet.config
        if (cfg.fft_size_input, cfg.fft_size_output) != (self.n_in, self.n_out):
            raise ValueError(f"the program plans {cfg}, the configuration states "
                             f"{self.n_in} -> {self.n_out}")
        self.bufs = device_noise(seed, (traffic["buffers"], B, C, self.n_in), self.device)
        self.feed = [b.cpu().numpy() for b in self.bufs] if self.host else list(self.bufs)
        slots = traffic["sample_slots"]
        if self.host:
            # pageable, touched once here so that no step faults its pages in
            self.kept = np.zeros((slots, B, C, self.n_out), np.float32)
            self.spare = np.zeros((2, B, C, self.n_out), np.float32)
        else:
            self.kept = torch.empty((slots, B, C, self.n_out), device=self.device)
        self.slot_step: dict[int, int] = {}
        self.sampler = Sampler(seed, traffic["sample_gap"], slots, traffic["warm_steps"])
        self.k = 0
        layers.wrap(self.fleet, "resample", "fft_resample")

    def warm(self) -> None:
        for _ in range(self.traffic["warm_steps"]):
            self.step()

    def step(self) -> int:
        k = self.k
        self.k += 1
        out = self.fleet.resample(self.feed[k % len(self.feed)])
        s = self.sampler.slot(k)
        if self.host:
            dst = self.spare[k % 2] if s is None else self.kept[s]
            torch.from_numpy(dst).copy_(out)
        elif s is not None:
            self.kept[s].copy_(out)
        if s is not None:
            self.slot_step[s] = k
        return self.B * self.C * self.n_out

    def release(self) -> None:
        del self.fleet

    def check(self, limits: dict, control: bool = False):
        """``({name: {"value", "limit"}}, failed steps)``.  With ``control``
        the reference in TF32 takes the program's place: its outputs of the
        sampled steps are judged instead of the program's."""
        fr = FftReference(self.config, self.device)
        R, nb = self.B * self.C, len(self.bufs)
        err, bad = 0.0, set()
        for s, k in sorted(self.slot_step.items()):
            got = torch.as_tensor(self.kept[s], device=self.device).reshape(R, self.n_out)
            cur = self.bufs[k % nb].reshape(R, self.n_in)
            prev = self.bufs[(k - 1) % nb].reshape(R, self.n_in) if k else None
            e = 0.0
            for r in range(0, R, ROWS_PER_BLOCK):
                rows = slice(r, r + ROWS_PER_BLOCK)
                p = None if prev is None else prev[rows]
                expect = fr.step(p, cur[rows])
                mine = fr.step(p, cur[rows], control=True) if control else got[rows].double()
                e = max(e, absmax(mine - expect))
            err = max(err, e)
            if e > limits["max_abs_err"]:
                bad.add(k)
        checks = {
            "max_abs_err": {"value": err, "limit": limits["max_abs_err"]},
            # a run that compared no sample is not correct
            "uncompared": {"value": int(not self.slot_step), "limit": 0},
        }
        return checks, len(bad)
