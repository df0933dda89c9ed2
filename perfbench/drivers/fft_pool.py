"""Driver of the FFT fleet on stacks of consecutive chunks.

Entry: ``BatchedResamplerFft.resample_many`` on ``[T, streams, channels,
N]`` stacks, ``T`` = ``chunks_per_call``.  The stacks rotate over
``buffers`` device tensors of white noise made from the seed, and calls
chain: chunk 0 of call ``k`` follows chunk ``T - 1`` of call ``k - 1``
through the fleet's carry.  Outputs stay on the device; a sampled call's
whole output is copied into one of ``sample_slots`` kept slots.

Checked: every sample of the sampled calls (all chunks, streams and
channels) against the reference's overlap-add pipeline, chunk 0 on the
previous call's last chunk.
"""

from __future__ import annotations

import torch

from perfbench.core import Sampler
from perfbench.drivers.common import absmax, device_noise, program
from perfbench.drivers.fft_chunks import ROWS_PER_BLOCK
from perfbench.reference.fft import FftReference


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, layers):
        rtt = program()
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        B, C, T = config["streams"], config["channels"], traffic["chunks_per_call"]
        self.B, self.C, self.T = B, C, T
        self.n_in, self.n_out = config["fft_size_input"], config["fft_size_output"]
        self.fleet = rtt.BatchedResamplerFft(
            B, C, config["input_rate"], config["output_rate"],
            backend=config["backend"], device=self.device,
        )
        cfg = self.fleet.config
        if (cfg.fft_size_input, cfg.fft_size_output) != (self.n_in, self.n_out):
            raise ValueError(f"the program plans {cfg}, the configuration states "
                             f"{self.n_in} -> {self.n_out}")
        self.bufs = device_noise(seed, (traffic["buffers"], T, B, C, self.n_in), self.device)
        slots = traffic["sample_slots"]
        self.kept = torch.empty((slots, T, B, C, self.n_out), device=self.device)
        self.slot_step: dict[int, int] = {}
        self.sampler = Sampler(seed, traffic["sample_gap"], slots, traffic["warm_steps"])
        self.k = 0

    def warm(self) -> None:
        for _ in range(self.traffic["warm_steps"]):
            self.step()

    def step(self) -> int:
        k = self.k
        self.k += 1
        out = self.fleet.resample_many(self.bufs[k % len(self.bufs)])
        s = self.sampler.slot(k)
        if s is not None:
            self.kept[s].copy_(out)
            self.slot_step[s] = k
        return self.T * self.B * self.C * self.n_out

    def release(self) -> None:
        del self.fleet

    def check(self, limits: dict, control: bool = False):
        """``({name: {"value", "limit"}}, failed calls)``.  With ``control``
        the reference in TF32 takes the program's place: its outputs of the
        sampled calls are judged instead of the program's."""
        fr = FftReference(self.config, self.device)
        R, T, nb = self.B * self.C, self.T, len(self.bufs)
        err, bad = 0.0, set()
        for s, k in sorted(self.slot_step.items()):
            got = self.kept[s].reshape(T, R, self.n_out)
            cur = self.bufs[k % nb].reshape(T, R, self.n_in)
            last = self.bufs[(k - 1) % nb][T - 1].reshape(R, self.n_in) if k else None
            e = 0.0
            for t in range(T):
                before = cur[t - 1] if t else last
                for r in range(0, R, ROWS_PER_BLOCK):
                    rows = slice(r, r + ROWS_PER_BLOCK)
                    p = None if before is None else before[rows]
                    expect = fr.step(p, cur[t, rows])
                    mine = fr.step(p, cur[t, rows], control=True) if control else got[t, rows].double()
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
