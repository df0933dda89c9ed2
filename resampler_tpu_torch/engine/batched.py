"""Batched multi-stream resamplers: PyTorch ports of
``resampler_tpu.engine.batched``.

- ``BatchedResamplerFir``: the general vmapped fleet (the default,
  ``synchronized=False``: every stream with its own schedule and valid
  count, kernel B9 on periodic ratios), the phase-locked time-major fleet
  (``synchronized=True, sync_variant="tm"``) on every ratio and convolve
  path it serves (``path="periodic" | "farrow" | "lerp"``, the wide u32
  schedule), the end-aligned slide fleet (``sync_variant="slide"``,
  kernel B8) and the async time-major fleet (``sync_variant="async_tm"``:
  per-stream join phases and slew, kernel B6);
- ``BatchedResamplerFft``: the FFT fleet on every backend, with
  ``resample_many`` over the zero-copy pool step on the magsplit backend.

Every other variant raises ``NotImplementedError`` naming the ROADMAP item
that ports it; none falls back to another engine.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..dsp.planner import plan_conversion
from ..types import Attenuation, Latency, SampleRate, reduce_ratio
from ..utils import tracing
from . import fft as fft_engine
from .fir import (
    FirConfig,
    fir_coefficients,
    fir_cutoff,
    fir_init_batched,
    make_fir_step_batched,
    resolve_device,
)
from .fir_fleets import (
    fir_fleet_init_async_tm,
    fir_fleet_init_sync,
    fir_fleet_init_sync_tm,
    make_fir_fleet_step_async_tm,
    make_fir_fleet_step_sync,
    make_fir_fleet_step_sync_tm,
)

__all__ = ["BatchedResamplerFir", "BatchedResamplerFft"]


class BatchedResamplerFir:
    """``n_streams`` FIR resamplers stepped as one fleet on ``device``.

    All streams share one configuration.  The vmapped fleet (the default,
    ``synchronized=False``) keeps each stream's state and schedule apart:
    per-stream valid counts and per-stream ``slew``.  The synchronized
    fleets step on one chunk cadence (the fleet minimum of the valid
    counts): ``sync_variant="tm"`` and ``"slide"`` share one exact
    schedule (on the time-major ring, or on the end-aligned buffer of the
    vmapped fleet); in the async fleet (``sync_variant="async_tm"``) each
    stream keeps its own position (``initial_positions``, per-stream
    ``slew``) within a spread of ``skew_periods`` input frames.  Chunks
    arrive batch-major ``[B, n, C]``; the ring fleets relay them to the
    time-major ``[n, B*C]`` feed (lane ``b*C + c``).
    """

    def __init__(
        self,
        n_streams: int,
        channels: int,
        input_rate,
        output_rate,
        latency: Latency = Latency.Sample64,
        attenuation: Attenuation = Attenuation.Db120,
        *,
        mesh=None,
        path: str = "auto",
        synchronized: bool = False,
        sync_variant: str = "tm",
        max_chunk: int = 2048,
        horizon: int = 16,
        max_out: int | None = None,
        initial_positions=None,
        skew_periods: int = 1,
        device="cuda",
    ) -> None:
        if mesh is not None:
            raise NotImplementedError(
                "mesh sharding is not ported yet (ROADMAP A11)"
            )
        if sync_variant not in ("tm", "async_tm", "slide"):
            raise ValueError(f"unknown sync_variant {sync_variant!r}")
        # as in the JAX package, synchronized=False is the vmapped fleet
        # whatever sync_variant says
        kind = sync_variant if synchronized else "vmapped"
        if path != "auto" and kind in ("async_tm", "slide"):
            # a silent drop would serve another convolve structure
            raise ValueError(
                "path= requires the vmapped fleet (synchronized=False) or the "
                "synchronized tm fleet (sync_variant='tm'); the "
                f"{sync_variant!r} variant picks its own convolve structure"
            )
        if initial_positions is not None and kind != "async_tm":
            # a silent drop would give every stream phase 0 with no error
            raise ValueError(
                "initial_positions requires the async fleet "
                "(synchronized=True, sync_variant='async_tm'); the "
                f"{'synchronized' if synchronized else 'vmapped'} variant "
                "shares one schedule or starts at phase 0: use slew() to set "
                "per-stream phases on the vmapped fleet"
            )
        L, M = reduce_ratio(int(input_rate), int(output_rate))
        self._config = FirConfig(
            channels=channels, taps=latency.taps, ratio_num=L, ratio_den=M
        )
        self._device = resolve_device(device)
        self.n_streams = n_streams
        self.synchronized = synchronized
        self.max_chunk = max_chunk
        cutoff = fir_cutoff(
            latency.taps, attenuation, int(input_rate) / int(output_rate)
        )
        coeffs = fir_coefficients(latency.taps, attenuation, cutoff)
        kw = dict(max_chunk=max_chunk, horizon=horizon, device=self._device)
        # each kind's step in one contract, ``step(state, chunks [B, n, C],
        # n_valid [B] int64 or None for full chunks) -> (state', out [B,
        # out_cap, C], consumed [B], produced [B], peak)`` with int32 counts
        # and the step's peak ``max |out|`` where it metered it (the tm
        # kind's fused epilogue), else None, and
        # the facts the other methods read: whether the counts and the
        # phases are per stream, the position spread the async fleet
        # tracks, and the ring fleets' chunk limit
        self._per_stream_counts = kind == "vmapped"
        self._per_stream_phases = kind in ("vmapped", "async_tm")
        self._spread_limit = skew_periods * M if kind == "async_tm" else None
        self._chunk_limit = max_chunk if kind in ("tm", "async_tm") else None
        if kind == "vmapped":
            self._fleet_step = _vmapped_step(make_fir_step_batched(
                self._config, coeffs, n_streams, path=path, device=self._device
            ), np.full(n_streams, self._config.out_capacity, np.int64))
            self._state = fir_init_batched(self._config, n_streams, self._device)
        elif kind == "slide":
            self._fleet_step = _synchronized_step(make_fir_fleet_step_sync(
                self._config, coeffs, n_streams, device=self._device
            ), n_streams, ring=False)
            self._state = fir_fleet_init_sync(self._config, n_streams, self._device)
        elif kind == "async_tm":
            self._fleet_step = _synchronized_step(make_fir_fleet_step_async_tm(
                self._config, coeffs, n_streams, max_out=max_out,
                skew_periods=skew_periods, **kw,
            ), n_streams, ring=True)
            self._state = fir_fleet_init_async_tm(
                self._config, n_streams, pos_num=initial_positions,
                skew_periods=skew_periods, **kw,
            )
        else:
            self._fleet_step = _synchronized_step(make_fir_fleet_step_sync_tm(
                self._config, coeffs, n_streams, path=path, meter_peak=True, **kw
            ), n_streams, ring=True)
            self._state = fir_fleet_init_sync_tm(self._config, n_streams, **kw)

    @property
    def config(self) -> FirConfig:
        return self._config

    @property
    def state(self) -> dict:
        """Fleet state.  Ring fleets: ring ``buffer`` tensor plus host-int
        ``start``, ``fill`` and ``pos_num`` (``pos_hi`` / ``pos_lo`` when
        wide); the async fleet's positions are ``[B]`` int64 numpy arrays.
        Vmapped fleet: ``buffer [B, C, alloc]`` and ``available_frames``
        and the position words as ``[B]`` int64 numpy; slide fleet: the
        same buffer with host ints."""
        return self._state

    @state.setter
    def state(self, value: dict) -> None:
        self._state = value

    def buffer_size_output(self) -> int:
        return self._config.out_capacity * self._config.channels

    def slew(self, samples):
        """Shift the sampling phase by ``samples`` input samples: resolution
        1/M input samples, clamped to the buffered history and (int32
        envelope only) the int32 schedule envelope; returns the applied
        slew.  The synchronized fleets share one phase, so ``samples`` is a
        scalar there; the vmapped and async fleets take a scalar or a
        per-stream ``[n_streams]`` vector and return ``[n_streams]``; the
        async fleet refuses a slew that would widen the position spread to
        ``skew_periods * M``."""
        with tracing.span("fir.slew"):
            M = self._config.ratio_den
            per_stream = self._per_stream_phases
            if not per_stream and np.ndim(samples) != 0:
                raise ValueError(
                    "synchronized fleets share one phase; per-stream slew "
                    "needs the async tm fleet (sync_variant='async_tm') "
                    "or the general (vmapped) fleet"
                )
            delta_f = np.round(np.atleast_1d(np.asarray(samples, np.float64)) * M)
            delta_f = np.broadcast_to(delta_f, (self.n_streams if per_stream else 1,))
            st = self._state
            if self._config.wide:
                # exact Python ints: the two u32 words can exceed int64 together
                pos = np.asarray(
                    [int(h) * M + int(lo) for h, lo in zip(np.atleast_1d(st["pos_hi"]),
                                                         np.atleast_1d(st["pos_lo"]))],
                    object,
                )
                # no int32 envelope; heavy downsampling carries pos past
                # capacity*M, so only the history clamp applies
                applied = np.maximum(np.asarray([int(d) for d in delta_f], object), -pos)
            else:
                pos = np.atleast_1d(np.asarray(st["pos_num"], np.int64))
                ceiling = self._config.input_capacity * M
                applied = np.clip(delta_f.astype(np.int64), -pos, np.maximum(0, ceiling - pos))
            new_pos = pos + applied
            if self._spread_limit is not None:
                spread = int(new_pos.max() - new_pos.min())
                if spread >= self._spread_limit:
                    raise ValueError(
                        f"per-stream slew would widen the fleet position spread "
                        f"to {spread} (>= skew_periods*M = {self._spread_limit}); the async tm "
                        "fleet only tracks bounded drift: widen skew_periods or "
                        "use the general (vmapped) fleet"
                    )
            moved_streams = int(np.count_nonzero(applied != 0))
            if moved_streams:
                tracing.count("fir.slews", moved_streams)
                if self._config.wide:
                    moved = dict(pos_hi=np.asarray([p // M for p in new_pos], np.int64),
                                 pos_lo=np.asarray([p % M for p in new_pos], np.int64))
                else:
                    moved = dict(pos_num=new_pos)
                if not per_stream:
                    moved = {k: int(v[0]) for k, v in moved.items()}
                self._state = dict(st, **moved)
            applied_s = np.asarray(applied / M, np.float64)
            return applied_s if per_stream else float(applied_s[0])

    def _step(self, chunks, n_valid):
        """One step in the fleet's step contract (``n_valid [B]`` or
        ``None`` in, ``[B]`` int32 counts out), and the step's peak: the
        step's own where it metered it, else ``max |out|`` taken here."""
        self._state, out, consumed, produced, peak = self._fleet_step(self._state, chunks, n_valid)
        tracing.count("fir.steps")
        if peak is None:
            with tracing.span("fir.peak"):
                peak = out.abs().amax()
        return out, consumed, produced, peak

    def _chunks(self, chunks, ndim: int):
        with tracing.span("fir.upload"):
            chunks = torch.as_tensor(chunks, dtype=torch.float32, device=self._device)
        with tracing.span("fir.check"):
            if chunks.ndim != ndim or chunks.shape[-3] != self.n_streams or (
                chunks.shape[-1] != self._config.channels
            ):
                raise ValueError(
                    f"chunks must be [..., {self.n_streams}, n, "
                    f"{self._config.channels}], got {tuple(chunks.shape)}"
                )
            # the ring fleets size their ring by max_chunk; the end-aligned
            # fleets take any chunk up to input_capacity (their steps check it)
            if self._chunk_limit is not None and chunks.shape[-2] > self._chunk_limit:
                raise ValueError(
                    f"chunk of {chunks.shape[-2]} frames exceeds max_chunk="
                    f"{self.max_chunk} (set max_chunk at construction for "
                    "larger feeds)"
                )
        return chunks

    def resample(self, chunks, n_valid=None):
        """Step all streams once.

        - ``chunks``: ``[n_streams, frames, channels]`` f32 (numpy, or a
          tensor, ideally already on the fleet's device)
        - ``n_valid``: optional ``[n_streams]`` valid frame counts
          (defaults to full chunks); the synchronized fleets take their
          minimum, the vmapped fleet each stream's own

        Returns ``(out [n_streams, out_cap, channels], consumed [B],
        produced [B], fleet_peak)``: ``out`` and the peak ``max|out|``
        stay on the device; ``consumed``/``produced`` are int32 numpy
        arrays, frames per channel (on the synchronized fleets every
        stream the same)."""
        t0 = time.perf_counter_ns()
        with tracing.span("fir.step"):
            got = self._step(self._chunks(chunks, 3), n_valid)
        tracing.count("fir.host_ns", time.perf_counter_ns() - t0)
        return got

    def resample_many(self, chunks, n_valid=None):
        """Step ``T`` consecutive chunks per stream: ``chunks [T, B, n, C]``
        -> ``(out [T, B, out_cap, C], consumed, produced, peak)``, the same
        steps as ``T`` calls of ``resample``.  ``n_valid``: optional valid
        counts, ``[T]`` (or ``[T, B]``, reduced by min) on the synchronized
        fleets, ``[T, B]`` (``[T]`` broadcasts) on the vmapped fleet;
        ``consumed`` / ``produced`` come back ``[T]`` and ``[T, B]``
        likewise."""
        t0 = time.perf_counter_ns()
        with tracing.span("fir.step"):
            chunks = self._chunks(chunks, 4)
            T, B = chunks.shape[:2]
            if n_valid is not None:
                nv = np.asarray(n_valid, np.int64)
                if nv.shape not in ((T,), (T, B)):
                    raise ValueError(f"n_valid must be [T] or [T, B], got {nv.shape}")
                n_valid = np.broadcast_to(nv.reshape(T, -1), (T, B))
            outs, cs, ps, peaks = [], [], [], []
            for t in range(T):
                out, c, p, peak = self._step(chunks[t], None if n_valid is None else n_valid[t])
                outs.append(out)
                cs.append(c)
                ps.append(p)
                peaks.append(peak)
            with tracing.span("fir.relayout_out"):
                out = torch.stack(outs)
            with tracing.span("fir.peak"):
                peak = torch.stack(peaks).amax()
            # [T, B]; one column on the synchronized fleets
            pick = slice(None) if self._per_stream_counts else 0
            got = out, np.asarray(cs, np.int32)[:, pick], np.asarray(ps, np.int32)[:, pick], peak
        tracing.count("fir.host_ns", time.perf_counter_ns() - t0)
        return got


def _vmapped_step(step, budget: np.ndarray):
    """The vmapped fleet's step (per-stream counts and output budget) in
    ``BatchedResamplerFir``'s step contract."""

    def contract(state, chunks, n_valid):
        state, out, consumed, produced = step(
            state, chunks, chunks.shape[1] if n_valid is None else n_valid, budget
        )
        return state, out, consumed.astype(np.int32), produced.astype(np.int32), None

    return contract


def _synchronized_step(step, n_streams: int, *, ring: bool):
    """A synchronized fleet's step, which takes one shared count (an int)
    and returns one of each count, in ``BatchedResamplerFir``'s step
    contract: the fleet minimum of ``n_valid [B]`` (``None``: the whole
    chunk) in, ``[B]`` counts out, and the peak a step returns fifth
    (``meter_peak``), else None.  The ring fleets (``ring=True``) take their chunks time-major:
    ``[B, n, C]`` is relaid to ``[n, B*C]`` (lane ``b*C + c``)."""

    def contract(state, chunks, n_valid):
        n_valid = chunks.shape[1] if n_valid is None else int(np.min(n_valid))
        if ring:
            with tracing.span("fir.relayout_in"):
                chunks = chunks.permute(1, 0, 2).reshape(chunks.shape[1], -1)
        state, out, consumed, produced, *peak = step(state, chunks, n_valid)
        return (state, out, np.full(n_streams, consumed, np.int32),
                np.full(n_streams, produced, np.int32), peak[0] if peak else None)

    return contract


class BatchedResamplerFft:
    """``n_streams`` independent FFT resamplers stepped as one fleet on
    ``device``.

    The chunk operator is linear and identical for every (stream,
    channel), so each step folds ``streams x channels`` into the rows of
    one operator call: one launch of kernel B4 on the magsplit backend
    (``"auto"`` on the card where the pair has a band plan), one launch of
    kernel B7 on the matmul and conv backends on the card (one f32 matmul
    on the CPU).
    """

    def __init__(
        self,
        n_streams: int,
        channels: int,
        sample_rate_input,
        sample_rate_output,
        *,
        mesh=None,
        backend: str = "auto",
        device="cuda",
    ) -> None:
        if mesh is not None:
            raise NotImplementedError(
                "mesh sharding is not ported yet (ROADMAP A11)"
            )
        cfg = plan_conversion(
            SampleRate(sample_rate_input), SampleRate(sample_rate_output)
        ).scale_for_throughput()
        self._config = fft_engine.FftConfig(
            channels=channels,
            fft_size_input=cfg.fft_size_input,
            fft_size_output=cfg.fft_size_output,
        )
        self._device = resolve_device(device)
        self.n_streams = n_streams
        self._backend = backend
        self._resolved_backend = fft_engine._resolve_backend(
            self._config, backend, self._device
        )
        self._step = fft_engine.make_fft_fleet_step(
            self._config, n_streams, backend=backend, device=self._device
        )
        self._pool_step = None  # built on the first resample_many
        self._state = fft_engine.fft_fleet_init(
            self._config, n_streams, backend, self._device
        )

    @property
    def config(self) -> fft_engine.FftConfig:
        return self._config

    @property
    def state(self) -> dict:
        return self._state

    @state.setter
    def state(self, value: dict) -> None:
        # "auto" resolves per device (magsplit {'prev'} on the card,
        # matmul {'overlap'} on the CPU), so a fleet checkpoint restored
        # on another device is converted as ResamplerFft does.
        lead = (self.n_streams, self._config.channels)
        value = fft_engine.private_carry(value, lead, self._config, self._device)
        self._state = fft_engine.convert_fft_state(
            value, self._config, self._backend, self._device
        )

    def chunk_size_input(self) -> int:
        return self._config.fft_size_input * self._config.channels

    def chunk_size_output(self) -> int:
        return self._config.fft_size_output * self._config.channels

    def _chunks(self, chunks, ndim: int):
        """``chunks`` as a contiguous f32 tensor on the device, and whether
        it is the caller's own memory (a tensor already in that form,
        which the carry must not keep)."""
        with tracing.span("fft.upload"):
            if isinstance(chunks, torch.Tensor):
                t = chunks.to(self._device, torch.float32).contiguous()
                callers = t is chunks
            else:
                t = torch.tensor(np.asarray(chunks, np.float32), device=self._device)
                callers = False
        C, N = self._config.channels, self._config.fft_size_input
        if t.ndim != ndim or tuple(t.shape[-3:]) != (self.n_streams, C, N):
            raise ValueError(
                f"chunks must be [..., {self.n_streams}, {C}, {N}], got "
                f"{tuple(t.shape)}"
            )
        return t, callers

    def _keep(self, state: dict, callers: bool) -> dict:
        # the input-domain carry holds the last chunk: copy it out of the
        # caller's memory, so that later writes there change no output
        if callers and "prev" in state:
            with tracing.span("fft.keep"):
                return {"prev": state["prev"].clone()}
        return state

    def resample(self, chunks):
        """Step all streams: ``chunks [B, C, N]`` (numpy, or a tensor,
        ideally already on the fleet's device) -> ``out [B, C, M]``, a
        tensor on the device."""
        t0 = time.perf_counter_ns()
        with tracing.span("fft.step"):
            chunks, callers = self._chunks(chunks, 3)
            tracing.count("fft.chunks")
            with tracing.span("fft.contract"):
                state, out = self._step(self._state, chunks)
            self._state = self._keep(state, callers)
        tracing.count("fft.host_ns", time.perf_counter_ns() - t0)
        return out

    def resample_many(self, chunks):
        """Step ``T`` consecutive chunks per stream: ``chunks [T, B, C, N]
        -> out [T, B, C, M]``, the same steps as ``T`` calls of
        ``resample``.

        On the magsplit backend chunk ``t >= 1`` goes through the
        zero-copy pool step (kernel B5): it reads its previous chunk
        straight from slot ``t-1`` of the caller's stack, the ``[T, B*C,
        N]`` view of ``chunks``.  Only chunk 0, whose ``prev`` is the
        carry, takes the fleet step (kernel B4), under ``fft.contract``;
        the B5 steps run under ``fft.pool``.  The result is allocated
        once, under ``fft.stack``, and B4 and B5 store each chunk straight
        into its slot ``out[t]`` (counted in ``fft.in_place``): nothing is
        copied after them.  Other backends, and ``T < 2``, loop the fleet
        step under ``fft.contract`` and stack its outputs there."""
        t0 = time.perf_counter_ns()
        with tracing.span("fft.step"):
            chunks, callers = self._chunks(chunks, 4)
            T = chunks.shape[0]
            tracing.count("fft.chunks", T)
            if self._resolved_backend != "magsplit" or T < 2:
                state, outs = self._state, []
                with tracing.span("fft.contract"):
                    for t in range(T):
                        state, out = self._step(state, chunks[t])
                        outs.append(out)
                    outs = torch.stack(outs)
                self._state = self._keep(state, callers)
            else:
                C, N = self._config.channels, self._config.fft_size_input
                M = self._config.fft_size_output
                pool = chunks.reshape(T, self.n_streams * C, N)
                with tracing.span("fft.stack"):
                    outs = torch.empty((T, self.n_streams, C, M), dtype=torch.float32,
                                       device=chunks.device)
                with tracing.span("fft.contract"):
                    self._step(self._state, chunks[0], out=outs[0])
                with tracing.span("fft.pool"):
                    if self._pool_step is None:
                        self._pool_step = fft_engine.make_fft_fleet_step_pool(
                            self._config, self.n_streams, backend=self._backend,
                            device=self._device,
                        )
                    for t in range(1, T):
                        self._pool_step({"prev_idx": t - 1}, pool, t, out=outs[t])
                tracing.count("fft.pool_steps", T - 1)
                tracing.count("fft.in_place", T)
                self._state = self._keep({"prev": chunks[T - 1]}, callers)
        tracing.count("fft.host_ns", time.perf_counter_ns() - t0)
        return outs
